// K7: batch_stats_fused_v2_packed, and K6: batch_stats_fused_packed,
// which calls it at the exact divide, at compute dtype f32. The bodies,
// their design note and their launcher are in stats_fused.cuh;
// stats_fused_bf16.cu holds the bf16 entry (same arguments).

#include "stats_fused.cuh"

extern "C" int tt_batch_stats_fused_v2(
    int R, const uint8_t* rows, const float* up, const float* t1,
    const float* t0, float* l0, float* l1, float* g, float* lpart,
    float* gpart, int B, int W, int K, int tile_rows, int tile_cols,
    int approx, cudaStream_t stream) {
  return batch_stats_fused_v2<false>(R, rows, up, t1, t0, l0, l1, g, lpart,
                                    gpart, B, W, K, tile_rows, tile_cols,
                                    approx, stream);
}
