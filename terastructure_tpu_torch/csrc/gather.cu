// K3: gather_row_blocks — copy 8-row blocks of the packed matrix.
//
// Replaces terastructure_tpu/ops/gather.py `gather_row_blocks`
// (pallas_call at :77), which issued one HBM->HBM DMA per block, 16 in
// flight. out[g*block + r] = src[starts[g]*block + r]: a block of `block`
// consecutive rows is one contiguous run of block*W bytes in src and in
// out, so the kernel is a plain copy of G runs.
//
// Bound on the H100: bytes. At the TGP shape (B=4096, W=640) it moves
// 2.6 MB in and out. Each thread moves 16 bytes (uint4) with neighbouring
// threads on neighbouring addresses; a run whose length or address is not
// 16-byte aligned falls back to a byte copy. blockIdx.y walks the blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void copy_runs_kernel(T* __restrict__ out,
                                 const T* __restrict__ src,
                                 const int* __restrict__ starts,
                                 long long n_runs, long long run) {
  for (long long g = blockIdx.y; g < n_runs; g += gridDim.y) {
    const long long s = (long long)starts[g] * run;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < run; i += (long long)gridDim.x * blockDim.x) {
      out[g * run + i] = src[s + i];
    }
  }
}

template <typename T>
int launch(void* out, const void* src, const int* starts, long long n_runs,
           long long run, cudaStream_t stream) {
  const long long per_cta = 256;
  const long long gx = (run + per_cta - 1) / per_cta;
  const dim3 grid((unsigned)(gx < 1024 ? gx : 1024),
                  (unsigned)(n_runs < 65535 ? n_runs : 65535));
  copy_runs_kernel<T><<<grid, (unsigned)per_cta, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(src), starts, n_runs, run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tt_gather_row_blocks(void* out, const void* src,
                                    const int* starts, long long n_blocks,
                                    long long block_bytes,
                                    cudaStream_t stream) {
  if (n_blocks <= 0 || block_bytes <= 0) return (int)cudaErrorInvalidValue;
  const bool v16 = block_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (v16)
    return launch<uint4>(out, src, starts, n_blocks, block_bytes / 16, stream);
  return launch<uint8_t>(out, src, starts, n_blocks, block_bytes, stream);
}
