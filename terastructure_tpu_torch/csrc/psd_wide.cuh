// The K-chunking helpers of K6's K > 64 body, `stats_v1_wide_kernel`
// (stats_fused.cuh), the one body at K > 64 that still cuts K's output
// columns into chunks. Included by psd_common.cuh. The λ pass, the γ pass
// and K7 at K > 64 compute D once an entry on wide_tile.cuh's tile, with
// no K chunks (lambda_wide.cuh, gamma_wide.cuh, stats_fused.cuh).
//
// K6 wide's CTA keeps the K sums of its chunk of kKC = 32 output columns
// in registers (KM = 64 already spills) and computes D over all of K, a
// piece of 32 columns at a time. So D is computed once for each chunk:
// ceil(K / 32) times an entry.
//
// The replicate axis: R problems share the grid's z with the chunks, z =
// r x chunks + c (`wide_z`), so gridDim.z is R x ceil(K / 32), which the
// launcher keeps within 65,535 (`wide_grid_z`). A CTA offsets its
// pointers by replicate r's strides before any staging and then runs
// chunk c as the single call's CTA (x, y, c) does: a replicate's result is
// bitwise its single call's.
#pragma once

namespace tt {

constexpr int kKC = 32;          // columns of K in a chunk and in a piece

__host__ __device__ constexpr int round4(int K) { return (K + 3) & ~3; }
__host__ __device__ constexpr int wide_chunks(int K) {
  return (K + kKC - 1) / kKC;
}

// A chunked CTA's replicate and chunk: z = r x wide_chunks(K) + c.
struct WideZ {
  long long r;  // the replicate
  int c;        // the chunk of K: columns [32 c, 32 c + 32)
  int np;       // chunks (= pieces) of K
};
__device__ __forceinline__ WideZ wide_z(int K) {
  const int np = wide_chunks(K);
  return {(long long)(blockIdx.z / np), (int)(blockIdx.z % np), np};
}

// The grid's z of a chunked launch of R replicates; 0 where it would pass
// the hardware's 65,535 (the launcher then refuses the call).
inline unsigned wide_grid_z(int K, int R) {
  const long long z = (long long)wide_chunks(K) * R;
  return z <= 65535 ? (unsigned)z : 0u;
}

}  // namespace tt
