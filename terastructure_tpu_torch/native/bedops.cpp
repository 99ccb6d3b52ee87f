// Native ingest core: PLINK .bed translation, 2-bit (un)packing and the
// streaming sampler's row-group gather (a copy of the reference's
// terastructure_tpu/native/bedops.cpp).
//
// Host C++, not a kernel: at biobank scale (1M x 1M = 250 GB packed) the
// ingest and the per-step host gather must run at memory bandwidth, which
// the numpy LUT path does not (it materializes intermediate index arrays).
// Plain threads, a C ABI consumed via ctypes
// (terastructure_tpu_torch/native/__init__.py). No Python dependency here.
//
// Built at first use with g++ into terastructure_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxThreads = 16;

// bed 2-bit code -> ours: 00->2 (hom A1), 01->3 (missing), 10->1, 11->0.
constexpr uint8_t kBedMap[4] = {2, 3, 1, 0};
// ours -> bed (inverse).
constexpr uint8_t kInvMap[4] = {3, 2, 0, 1};

struct Lut {
  uint8_t fwd[256];
  uint8_t inv[256];
  Lut() {
    for (int b = 0; b < 256; ++b) {
      uint8_t f = 0, v = 0;
      for (int s = 0; s < 4; ++s) {
        const int code = (b >> (2 * s)) & 0x3;
        f |= kBedMap[code] << (2 * s);
        v |= kInvMap[code] << (2 * s);
      }
      fwd[b] = f;
      inv[b] = v;
    }
  }
};
const Lut kLut;

void parallel_for(int64_t total, const std::function<void(int64_t, int64_t)>& fn,
                  int64_t serial_below = (1 << 20)) {
  const unsigned hw = std::thread::hardware_concurrency();
  const int nthreads =
      static_cast<int>(hw < kMaxThreads ? (hw ? hw : 1) : kMaxThreads);
  if (nthreads <= 1 || total < serial_below) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (total + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < total ? lo + chunk : total;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Translate PLINK-coded packed bytes into our code space (or back).
void bed_translate(const uint8_t* src, uint8_t* dst, int64_t nbytes,
                   int inverse) {
  const uint8_t* lut = inverse ? kLut.inv : kLut.fwd;
  parallel_for(nbytes, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = lut[src[i]];
  });
}

// Pack int8 genotypes (rows x n, values 0..3) into 2-bit bytes
// (rows x ceil(n/4)); tail positions of the last byte are set to
// MISSING (3).
void pack2bit(const int8_t* src, uint8_t* dst, int64_t rows, int64_t n) {
  const int64_t w = (n + 3) / 4;
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const int8_t* in = src + r * n;
      uint8_t* out = dst + r * w;
      int64_t full = n / 4;
      for (int64_t b = 0; b < full; ++b) {
        const int8_t* g = in + 4 * b;
        out[b] = static_cast<uint8_t>((g[0] & 3) | ((g[1] & 3) << 2) |
                                      ((g[2] & 3) << 4) | ((g[3] & 3) << 6));
      }
      if (full < w) {
        uint8_t last = 0;
        for (int s = 0; s < 4; ++s) {
          const int64_t i = 4 * full + s;
          const uint8_t code = i < n ? (in[i] & 3) : 3;
          last |= code << (2 * s);
        }
        out[full] = last;
      }
    }
  });
}

// Gather ng groups of g consecutive rows (wrapping at l) from a packed
// (l x w) matrix into a (ng*g x wp) batch buffer, wp >= w; columns
// [w, wp) of dst are left untouched (caller owns the padding bytes).
// This is the out-of-core streaming sampler's hot host loop
// (svi/stream.BatchStream): ~1 GB of row copies per minibatch at
// biobank shapes, memcpy-bound across threads.
void gather_groups(const uint8_t* src, int64_t l, int64_t w,
                   const int64_t* starts, int64_t ng, int64_t g,
                   uint8_t* dst, int64_t wp) {
  parallel_for(ng, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t s = starts[i];
      for (int64_t r = 0; r < g; ++r) {
        const int64_t row = (s + r) % l;
        std::memcpy(dst + (i * g + r) * wp, src + row * w,
                    static_cast<size_t>(w));
      }
    }
  }, /*serial_below=*/2);
}

// Unpack 2-bit bytes (rows x w) into int8 genotypes (rows x n).
void unpack2bit(const uint8_t* src, int8_t* dst, int64_t rows, int64_t w,
                int64_t n) {
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* in = src + r * w;
      int8_t* out = dst + r * n;
      for (int64_t i = 0; i < n; ++i) {
        out[i] = static_cast<int8_t>((in[i >> 2] >> (2 * (i & 3))) & 3);
      }
    }
  });
}

}  // extern "C"
