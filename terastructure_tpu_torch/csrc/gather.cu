// K3: gather_row_blocks — copy 8-row blocks of the packed matrix.
//
// Replaces terastructure_tpu/ops/gather.py `gather_row_blocks`
// (pallas_call at :77), which issued one HBM->HBM DMA per block, 16 in
// flight. out[g*block + r] = src[starts[g]*block + r]: a block of `block`
// consecutive rows is one contiguous run of block*W bytes in src and in
// out, so the kernel is a copy of G runs.
//
// Bound on the H100: bytes, and at the TGP shape (B=4096, W=640: G = 512
// runs of 5,120 bytes, 2.6 MB each way) the latency of one pass over
// them. A warp copies a run (a grid-stride loop over runs, CTAs of 4
// warps): every lane starts all its loads of a 320-word piece (10 at
// W=640) before its stores, so ten loads a lane are in flight. Words are
// the widest (16, 8, 4 or 1 bytes) that divide the run and both base
// addresses, so odd W is a run of 8-byte words. Two other designs lost to
// it at the TGP shape (PERF.md §6): a thread per 16-byte word with two
// CTAs of 256 threads per run (the first port), and the Tensor Memory
// Accelerator's 1-D bulk copies through a ring of shared-memory stages
// (one issuing thread a CTA, a barrier wait per piece).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpThreads = 128;   // 4 warps a CTA
constexpr int kUnroll = 10;         // words a lane loads before it stores

template <typename T>
__global__ void __launch_bounds__(kWarpThreads)
warp_copy_runs_kernel(T* __restrict__ out, const T* __restrict__ src,
                      const int* __restrict__ starts, long long n_runs,
                      long long run) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kWarpThreads / 32);
  for (long long g = (long long)blockIdx.x * (kWarpThreads / 32) +
                     (threadIdx.x >> 5);
       g < n_runs; g += nwarps) {
    const T* s = src + (long long)starts[g] * run;
    T* d = out + g * run;
    for (long long base = 0; base < run; base += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * 32 + lane;
        if (i < run) v[u] = __ldg(s + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * 32 + lane;
        if (i < run) d[i] = v[u];
      }
    }
  }
}

template <typename T>
int launch_runs(void* out, const void* src, const int* starts,
                long long n_runs, long long run, cudaStream_t stream) {
  constexpr long long kWarps = kWarpThreads / 32;
  long long grid = (n_runs + kWarps - 1) / kWarps;
  if (grid > 132 * 16) grid = 132 * 16;
  warp_copy_runs_kernel<T><<<(unsigned)grid, kWarpThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(src), starts, n_runs, run);
  return (int)cudaGetLastError();
}

// The widest word (16, 8, 4 or 1 bytes) dividing the run and both bases.
int word_bytes(const void* out, const void* src, long long run_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(src) | (uintptr_t)run_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

int launch_words(void* out, const void* src, const int* starts, long long n,
                 long long run_bytes, cudaStream_t stream) {
  switch (word_bytes(out, src, run_bytes)) {
    case 16:
      return launch_runs<uint4>(out, src, starts, n, run_bytes / 16, stream);
    case 8:
      return launch_runs<uint2>(out, src, starts, n, run_bytes / 8, stream);
    case 4:
      return launch_runs<unsigned>(out, src, starts, n, run_bytes / 4,
                                   stream);
    default:
      return launch_runs<uint8_t>(out, src, starts, n, run_bytes, stream);
  }
}

}  // namespace

extern "C" int tt_gather_row_blocks(void* out, const void* src,
                                    const int* starts, long long n_blocks,
                                    long long block_bytes,
                                    cudaStream_t stream) {
  if (n_blocks <= 0 || block_bytes <= 0) return (int)cudaErrorInvalidValue;
  return launch_words(out, src, starts, n_blocks, block_bytes, stream);
}
