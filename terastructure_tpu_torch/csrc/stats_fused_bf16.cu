// K7 and K6 at compute dtype bf16: batch_stats_fused_v2_packed's bf16
// bodies (t, u and R rounded to bf16 as the products' operands, sums in
// f32), for the reference's batch_stats_fused_v2_packed(dtype=
// jnp.bfloat16) and batch_stats_fused_packed(dtype=jnp.bfloat16)
// (terastructure_tpu/ops/stats_pallas.py:355, :263; casts in
// `_ratios_tile`, :68-93); K6 calls it at the exact divide. The bodies
// are stats_fused.cuh's; arguments as the f32 entry (stats_fused.cu). A
// source of its own, so that nvcc builds it beside the f32 one in
// parallel.

#include "stats_fused.cuh"

extern "C" int tt_batch_stats_fused_v2_bf16(
    int R, const uint8_t* rows, const float* up, const float* t1,
    const float* t0, float* l0, float* l1, float* g, float* lpart,
    float* gpart, int B, int W, int K, int tile_rows, int tile_cols,
    int approx, cudaStream_t stream) {
  return batch_stats_fused_v2<true>(R, rows, up, t1, t0, l0, l1, g, lpart,
                                    gpart, B, W, K, tile_rows, tile_cols,
                                    approx, stream);
}
