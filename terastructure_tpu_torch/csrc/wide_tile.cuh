// The tile that the K > 64 bodies redesigned for the H100 walk: K7's
// `stats_v2_wide_kernel` (stats_fused.cuh), the λ pass's
// `lambda_pass_wide_kernel` (lambda_wide.cuh: K1, K2, K4 and K8) and the
// γ pass's `gamma_pass_wide_kernel` (gamma_wide.cuh: K1's and K2's last
// pass, K5). Included by lambda_wide.cuh, after psd_mma.cuh's MMA helpers.
//
// The tile is 64 rows, held as 128 M-rows (t1 and t0 of each row,
// `w7_m`), against 16 byte columns (64 individuals: plane s, byte column c
// is the staged u row 16 s + c), with K in pieces of at most 128 columns
// (`w7_pieces`, `w7_piece_cols`: K = 65..128, which the reference's
// 128-lane padding runs at the cost of K = 8, is one piece). A CTA of 8
// warps walks it: K7 and the λ pass keep a row tile and walk byte
// columns in sub-tiles, the γ pass keeps a column tile and walks row
// tiles. What the bodies run is here:
//   - the staging: u of a sub-tile (`w7_stage_u`, 16-byte cp.async into
//     one of two buffers), t of the row tile at the strides a caller gives
//     (`w7_stage_t`), a row's 16 packed bytes (`w7_stage_code_row`), on
//     psd_mma.cuh's cp.async primitives;
//   - the dynamic shared memory (`W7`);
//   - three products and their writes: D = t u^T and S += R u over the
//     tile, and S into a (B, K, 2) partial (S1, S0); f32 register-blocked
//     SIMT (`W7Simt`, no TF32), bf16 on mma.sync m16n8k16 (`W7Mma`); and
//     g = t^T R into a (4W, K) partial (`W7SimtG`, `W7MmaG`: K7 and the
//     γ pass).
// Each body adds its own decode and divide (R = A / (D + eps) into the R
// tile between D and the products that read R).
#pragma once

namespace tt {

constexpr int kW7Threads = 256;          // 8 warps
constexpr int kW7Rows = 64;              // rows of a row tile
constexpr int kW7M = 2 * kW7Rows;        // its M-rows: t1 and t0 of each row
constexpr int kW7Cols = 16;              // byte columns of a sub-tile ...
constexpr int kW7Ind = 4 * kW7Cols;      // ... its 64 individuals
constexpr int kW7Piece = 128;            // the widest piece of K

// K in w7_pieces(K) pieces of w7_piece_cols(K) columns, a multiple of 16
// (80..128 at K > 64): K = 65..128 is one piece.
__host__ __device__ constexpr int w7_pieces(int K) {
  return (K + kW7Piece - 1) / kW7Piece;
}
__host__ __device__ constexpr int w7_piece_cols(int K) {
  return ((K + w7_pieces(K) - 1) / w7_pieces(K) + 15) / 16 * 16;
}

// The M-row of CTA row r (0..63) and allele a (0: t1, R1; 1: t0, R0): the
// m16 tile r / 8 holds t1 of its 8 rows, then t0 of the same rows.
__device__ __forceinline__ int w7_m(int r, int a) {
  return 16 * (r >> 3) + 8 * a + (r & 7);
}

// Dynamic shared memory of a body: u as staged (f32, two buffers), t of
// the CTA's M-rows for a piece, R of the sub-tile, bf(u) at bf16, and the
// sub-tile's allele counts as its row source stages them (two buffers of
// kSrc / 2 bytes: K7's and the λ pass's packed bytes, 16 a row, by
// default; K8's count planes, `WideRows<AcatLoader>` in lambda_wide.cuh).
// Row strides are padded so that the float4 and ldmatrix reads of 8 rows
// hit 32 distinct banks.
template <int KP, bool kBf16, int kSrc = 2 * kW7Rows * kW7Cols>
struct W7 {
  static constexpr int FS = KP + 4;          // floats a staged u or f32 t row
  static constexpr int HS = KP + 8;          // bf16 a t or u row
  static constexpr int RFS = kW7Ind + 4;     // floats an f32 R row
  static constexpr int RHS = kW7Ind + 8;     // bf16 a bf16 R row
  static constexpr int kUf = 2 * kW7Ind * FS * 4;
  static constexpr int kT = kW7M * (kBf16 ? 2 * HS : 4 * FS);
  static constexpr int kR = kW7M * (kBf16 ? 2 * RHS : 4 * RFS);
  static constexpr int kUb = kBf16 ? 2 * kW7Ind * HS : 0;
  static constexpr int kCodes = kSrc;
  static constexpr int kBytes = kUf + kT + kR + kUb + kCodes;
  static_assert(kBytes <= 232448, "a CTA's shared memory on the H100");

  float* uf;           // 2 x (64 individuals, FS): row 16 s + c, plane s
  void* t;             // (128 M-rows, FS floats | HS bf16)
  void* r;             // (128 M-rows, RFS floats | RHS bf16)
  __nv_bfloat16* ub;   // (64 individuals, HS): bf(u) (kBf16)
  uint8_t* codes;      // 2 x kSrc / 2 bytes

  __device__ explicit W7(unsigned char* p)
      : uf(reinterpret_cast<float*>(p)),
        t(p + kUf),
        r(p + kUf + kT),
        ub(reinterpret_cast<__nv_bfloat16*>(p + kUf + kT + kR)),
        codes(p + kUf + kT + kR + kUb) {}
  __device__ float* ufb(int buf) const { return uf + buf * kW7Ind * FS; }
  __device__ uint8_t* cb(int buf) const { return codes + buf * (kSrc / 2); }
};

// u of the sub-tile at byte column wc, columns [k0, k0 + KP) of K, into a
// staging buffer by cp.async (row n = 16 s + c: plane s, column wc + c),
// zero past K and wend; 16-byte copies where K % 4 == 0.
template <int KP>
__device__ __forceinline__ void w7_stage_u(float* uf,
                                           const float* __restrict__ up,
                                           int W, int K, int wc, int wend,
                                           int k0) {
  constexpr int Q = KP / 4, FS = KP + 4;
  const bool vec = (K & 3) == 0;
  for (int j = threadIdx.x; j < kW7Ind * Q; j += kW7Threads) {
    const int n = j / Q, q = j - n * Q;
    const int w = wc + (n & 15), k = k0 + 4 * q;
    float* dst = uf + n * FS + 4 * q;
    const bool ok = w < wend;
    const float* src =
        up + (ok ? ((long long)(n >> 4) * W + w) * K + k : 0);
    if (vec) {
      cp_async16z(dst, ok && k < K ? src : up, ok && k < K ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rd = ok && k + e < K;
        cp_async4z(dst + e, rd ? src + e : up, rd ? 4 : 0);
      }
    }
  }
}

// A row's packed bytes at byte columns [wc, wc + 16) into dst, MISSING
// (0xFF) past wend and for a null row: one 16-byte cp.async where the
// bytes lie whole and aligned, else byte loads.
__device__ __forceinline__ void w7_stage_code_row(uint8_t* dst,
                                                  const uint8_t* row, int wc,
                                                  int wend) {
  const uint8_t* src = row + wc;
  if (row != nullptr && wc + kW7Cols <= wend &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16z(dst, src, 16);
    return;
  }
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = 0xFFFFFFFFu;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
      if (row != nullptr && wc + c < wend) {
        v[q] &= ~(0xFFu << (8 * e));
        v[q] |= (uint32_t)__ldg(src + c) << (8 * e);
      }
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// t1, t0 of the CTA's rows, columns [k0, k0 + KP) of K, into its M-rows
// (f32, or rounded to bf16), zero past B and K; t1[b ts + k tk], t0
// likewise (K7, K4 and K8: ts = K, tk = 1; K1 and K2's interleaved t:
// ts = 2K, tk = 2).
template <int KP, bool kBf16>
__device__ __forceinline__ void w7_stage_t(void* tsm,
                                           const float* __restrict__ t1g,
                                           const float* __restrict__ t0g,
                                           int ts, int tk, int B, int K,
                                           int b0, int k0) {
  constexpr int P = KP / 2;                 // column pairs
  for (int j = threadIdx.x; j < kW7M * P; j += kW7Threads) {
    const int m = j / P, kp = j - m * P, k = k0 + 2 * kp;
    const float* tg = (m >> 3) & 1 ? t0g : t1g;
    const long long b = b0 + 8 * (m >> 4) + (m & 7);
    const float* tb = tg + b * ts + (long long)k * tk;
    const float x0 = b < B && k < K ? tb[0] : 0.f;
    const float x1 = b < B && k + 1 < K ? tb[tk] : 0.f;
    if constexpr (kBf16)
      reinterpret_cast<uint32_t*>(tsm)[m * (KP + 8) / 2 + kp] =
          pack_bf16(x0, x1);
    else
      reinterpret_cast<float2*>(tsm)[m * (KP + 4) / 2 + kp] =
          make_float2(x0, x1);
  }
}

// ---- the f32 products: SIMT, register-blocked ----
//
// Thread (q, c) = (tid / 16, tid % 16). D: rows 4q..4q+3 (both alleles:
// 8 M-rows) x the 4 individuals of byte column c (planes 0..3), t and u
// read as float4 along K. S: the same 8 M-rows x K columns c + 16 j, R
// read as float4 along the individuals. g: `W7SimtG` (the end of this
// file). Every sum runs in a fixed order.
template <int KP>
struct W7SimtG;
template <int KP>
struct W7Simt {
  using G = W7SimtG<KP>;                    // its g product
  static constexpr int KS = KP / 16;        // K columns a thread: c + 16 j
  static constexpr int FS = KP + 4, RFS = kW7Ind + 4;
  float s[4][2][KS];                        // S of rows 4q + e, allele a
  float d[4][2][4];                         // D of rows 4q + e, planes 0..3

  __device__ __forceinline__ void zero_s() {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < KS; ++j) s[e][a][j] = 0.f;
  }

  // nothing to convert: the products read the staged u
  template <class L>
  __device__ __forceinline__ void prepare(const L&, int) {}

  // D (+)= t u^T over columns [0, nk) of the staged piece (nk % 4 == 0)
  template <class L>
  __device__ __forceinline__ void d_product(const L& sm, int buf, int nk,
                                            bool first) {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
    const float* tf = static_cast<const float*>(sm.t);
    const float* ur = sm.ufb(buf) + c * FS;
    if (first) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int p = 0; p < 4; ++p) d[e][a][p] = 0.f;
    }
#pragma unroll 2
    for (int k = 0; k < nk; k += 4) {
      float4 u[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        u[p] = *reinterpret_cast<const float4*>(ur + 16 * p * FS + k);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float4 t = *reinterpret_cast<const float4*>(
              tf + w7_m(4 * q + e, a) * FS + k);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float x = d[e][a][p];
            x = fmaf(t.x, u[p].x, x);
            x = fmaf(t.y, u[p].y, x);
            x = fmaf(t.z, u[p].z, x);
            d[e][a][p] = fmaf(t.w, u[p].w, x);
          }
        }
    }
  }

  // S += R u over the sub-tile's 64 individuals, in individual order
  template <class L>
  __device__ __forceinline__ void s_product(const L& sm, int buf) {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
    const float* rf = static_cast<const float*>(sm.r);
    const float* uf = sm.ufb(buf) + c;
#pragma unroll 1
    for (int n4 = 0; n4 < kW7Ind; n4 += 4) {
      float4 rv[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          rv[e][a] = *reinterpret_cast<const float4*>(
              rf + w7_m(4 * q + e, a) * RFS + n4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float uv[KS];
#pragma unroll
        for (int j = 0; j < KS; ++j) uv[j] = uf[(n4 + i) * FS + 16 * j];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 v = rv[e][a];
            const float x = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
#pragma unroll
            for (int j = 0; j < KS; ++j)
              s[e][a][j] = fmaf(x, uv[j], s[e][a][j]);
          }
      }
    }
  }

  // S of the thread's rows into the W tile's lambda partial (S1, S0) at
  // K columns k0 + (c + 16 j), added to what is there where `add`
  __device__ __forceinline__ void flush_s(float* ltile, int B, int K,
                                          int b0, int k0, bool add) {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long b = b0 + 4 * q + e;
      if (b >= B) continue;
      float2* out = reinterpret_cast<float2*>(ltile + b * K * 2) + k0;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int k = c + 16 * j;
        if (k0 + k >= K) continue;
        float2 v = make_float2(s[e][0][j], s[e][1][j]);
        if (add) {
          const float2 o = out[k];
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        out[k] = v;
      }
    }
  }
};

// ---- the bf16 products: on the tensor cores (mma.sync m16n8k16) ----
//
// D: warp w takes m16 tile w (rows 8w..8w+7: bf(t1) in rows 0-7, bf(t0)
// in 8-15) x the 64 individuals (8 n8 tiles), K the MMAs' k; R on the
// accumulators, rounded to bf16 once, into the R tile. S: warp (wm, wn) =
// (w % 4, w / 4) takes m16 tiles 2wm, 2wm + 1 x the n8 tiles of K half wn
// (KP / 16 each), A from the R tile (ldmatrix), B from bf(u) (ldmatrix
// .trans), the sums in registers across sub-tiles. g: `W7MmaG`.
template <int KP>
struct W7MmaG;
template <int KP>
struct W7Mma {
  using G = W7MmaG<KP>;                     // its g product
  static constexpr int KH = KP / 16;        // S: n8 tiles a warp
  static constexpr int HS = KP + 8, RHS = kW7Ind + 8;
  float s[2][KH][4];                        // S: rows g (S1), g + 8 (S0)
  float d[8][4];                            // D: n8 tile j

  __device__ __forceinline__ void zero_s() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
  }

  // bf(u) of staging buffer buf into the bf16 u tile
  template <class L>
  __device__ __forceinline__ void prepare(const L& sm, int buf) {
    constexpr int Q = KP / 4, FS = KP + 4;
    const float* uf = sm.ufb(buf);
    for (int j = threadIdx.x; j < kW7Ind * Q; j += kW7Threads) {
      const int n = j / Q, q = j - n * Q;
      const float4 v = *reinterpret_cast<const float4*>(uf + n * FS + 4 * q);
      *reinterpret_cast<uint2*>(sm.ub + n * HS + 4 * q) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    __syncthreads();
  }

  // D (+)= bf(t) bf(u)^T over columns [0, nk) of the piece (nk % 16 == 0)
  template <class L>
  __device__ __forceinline__ void d_product(const L& sm, int, int nk,
                                            bool first) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(sm.t);
    const __nv_bfloat16* ta =
        tb + (16 * w + (lane & 7) + 8 * ((lane >> 3) & 1)) * HS +
        8 * (lane >> 4);
    const __nv_bfloat16* bb =
        sm.ub + ((lane & 7) + 8 * (lane >> 4)) * HS + 8 * ((lane >> 3) & 1);
    if (first) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < nk; k += 16) {
      uint32_t a[4];
      ldsm_x4(a, ta + k);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bq[4];
        ldsm_x4(bq, bb + 16 * jp * HS + k);
        mma_bf16(d[2 * jp], a, bq[0], bq[1]);
        mma_bf16(d[2 * jp + 1], a, bq[2], bq[3]);
      }
    }
  }

  // S += R bf(u) over the sub-tile's 64 individuals, 16 at a time
  template <class L>
  __device__ __forceinline__ void s_product(const L& sm, int) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wm = w & 3, wn = w >> 2;
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(sm.r);
    const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll 1
    for (int i0 = 0; i0 < kW7Ind; i0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], rb + (16 * (2 * wm + mt) + row) * RHS + i0 +
                               8 * (lane >> 4));
      const __nv_bfloat16* bb = sm.ub + (i0 + row) * HS + 8 * wn * KH;
#pragma unroll
      for (int jp = 0; jp < KH / 2; ++jp) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, bb + 16 * jp + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(s[mt][2 * jp], a[mt], bq[0], bq[1]);
          mma_bf16(s[mt][2 * jp + 1], a[mt], bq[2], bq[3]);
        }
      }
      if constexpr (KH % 2) {
        uint32_t bq[2];
        ldsm_x2_trans(bq, bb + 8 * (KH - 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(s[mt][KH - 1], a[mt], bq[0], bq[1]);
      }
    }
  }

  // S of the warp's tiles into the W tile's lambda partial (S1, S0) at K
  // columns k0 + (8 (wn KH + j) + 2t (+1)), added where `add`
  __device__ __forceinline__ void flush_s(float* ltile, int B, int K,
                                          int b0, int k0, bool add) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wm = w & 3, wn = w >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const long long b = b0 + 8 * (2 * wm + mt) + g;
      if (b >= B) continue;
      float2* out = reinterpret_cast<float2*>(ltile + b * K * 2) + k0;
#pragma unroll
      for (int j = 0; j < KH; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * (wn * KH + j) + 2 * t + e;
          if (k0 + k >= K) continue;
          float2 v = make_float2(s[mt][j][e], s[mt][j][2 + e]);
          if (add) {
            const float2 o = out[k];
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          out[k] = v;
        }
    }
  }
};

// ---- g = t^T R over the row tile's 128 M-rows ----
//
// K7's g product (stats_fused.cuh), and the γ pass's at K > 64
// (gamma_wide.cuh). f32 (`W7SimtG`): thread (q, c) takes individuals
// 4q..4q+3 of the sub-tile x K columns c + 16 j, an M-row at a time, R
// read as float4 along the individuals. bf16 (`W7MmaG`): warp (gm, gn) =
// (w / 4, w % 4) takes m16 tiles of K [gm MH, gm MH + MH) x the 16
// individuals of plane gn, k the 128 M-rows: A from the t tile and B from
// the R tile, both by ldmatrix .trans. `write` is K7's form: the partial
// so far (where `add`) and the tile's product, stored; the γ pass with one
// piece of K keeps g in registers across its row tiles (`zero`, `product`
// a row tile, `store` once).
template <int KP>
struct W7SimtG {
  static constexpr int KS = KP / 16, FS = KP + 4, RFS = kW7Ind + 4;
  float g[4][KS];                           // individual 4q + i, column j

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j) g[i][j] = 0.f;
  }

  // g = the partial at gtile's K columns k0 + (c + 16 j) where `add`, else
  // 0 (every load issued before the first product waits on them)
  __device__ __forceinline__ void load(const float* gtile, int W, int K,
                                       int wc, int wend, int k0, bool add) {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * q + i, w = wc + (n & 15);
      const float* in = gtile + ((long long)(n >> 4) * W + w) * K + k0;
#pragma unroll
      for (int j = 0; j < KS; ++j)
        g[i][j] =
            add && w < wend && k0 + c + 16 * j < K ? in[c + 16 * j] : 0.f;
    }
  }

  // g += t^T R over the 128 M-rows, in M-row order
  template <class L>
  __device__ __forceinline__ void product(const L& sm) {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
    const float* tf = static_cast<const float*>(sm.t) + c;
    const float* rf = static_cast<const float*>(sm.r) + 4 * q;
#pragma unroll 4
    for (int m = 0; m < kW7M; ++m) {
      const float4 rv = *reinterpret_cast<const float4*>(rf + m * RFS);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float tv = tf[m * FS + 16 * j];
        g[0][j] = fmaf(rv.x, tv, g[0][j]);
        g[1][j] = fmaf(rv.y, tv, g[1][j]);
        g[2][j] = fmaf(rv.z, tv, g[2][j]);
        g[3][j] = fmaf(rv.w, tv, g[3][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* gtile, int W, int K, int wc,
                                        int wend, int k0) const {
    const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * q + i, w = wc + (n & 15);
      if (w >= wend) continue;
      float* out = gtile + ((long long)(n >> 4) * W + w) * K + k0;
#pragma unroll
      for (int j = 0; j < KS; ++j)
        if (k0 + c + 16 * j < K) out[c + 16 * j] = g[i][j];
    }
  }

  // the tile's g into the partial at K columns k0 + (c + 16 j), summed
  // onto what is there where `add` (K7's form)
  template <class L>
  __device__ __forceinline__ static void write(const L& sm, float* gtile,
                                               int W, int K, int wc,
                                               int wend, int k0, bool add) {
    W7SimtG x;
    x.load(gtile, W, K, wc, wend, k0, add);
    x.product(sm);
    x.store(gtile, W, K, wc, wend, k0);
  }
};

template <int KP>
struct W7MmaG {
  static constexpr int KH = KP / 16;        // m16 tiles of K
  static constexpr int MH = (KH + 1) / 2;   // ... a warp
  static constexpr int HS = KP + 8, RHS = kW7Ind + 8;
  using Acc = float[MH][2][4];
  Acc acc;

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < MH; ++mi)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][jn][e] = 0.f;
  }

  // acc += bf(t)^T R over the 128 M-rows, 16 at a time
  template <class L>
  __device__ __forceinline__ static void product(Acc& acc, const L& sm) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int gm = w >> 2, gn = w & 3;
    const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(sm.t);
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(sm.r);
    const __nv_bfloat16* br =
        rb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RHS + 16 * gn +
        8 * (lane >> 4);
    const __nv_bfloat16* at =
        tb + ((lane & 7) + 8 * (lane >> 4)) * HS + 8 * ((lane >> 3) & 1);
#pragma unroll 1
    for (int m0 = 0; m0 < kW7M; m0 += 16) {
      uint32_t bq[4];
      ldsm_x4_trans(bq, br + m0 * RHS);
#pragma unroll
      for (int mi = 0; mi < MH; ++mi) {
        const int mt = gm * MH + mi;
        if (mt >= KH) continue;              // the warp's last tile (KH odd)
        uint32_t a[4];
        ldsm_x4_trans(a, at + m0 * HS + 16 * mt);
        mma_bf16(acc[mi][0], a, bq[0], bq[1]);
        mma_bf16(acc[mi][1], a, bq[2], bq[3]);
      }
    }
  }

  // acc into the partial at K columns k0 + (16 mt + g (+ 8)), added to
  // what is there where `add` (every load issued before the first add)
  __device__ __forceinline__ static void store(Acc& acc, float* gtile, int W,
                                               int K, int wc, int wend,
                                               int k0, bool add) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int gm = w >> 2, gn = w & 3, g = lane >> 2, t = lane & 3;
    float* gb = gtile + ((long long)gn * W + wc + 2 * t) * K + k0;
    if (add) {
#pragma unroll
      for (int mi = 0; mi < MH; ++mi)
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mt = gm * MH + mi;
            const int dw = 8 * jn + (e & 1), k = 16 * mt + g + 8 * (e >> 1);
            acc[mi][jn][e] = (mt < KH && wc + 2 * t + dw < wend && k0 + k < K
                                  ? gb[dw * K + k]
                                  : 0.f) +
                             acc[mi][jn][e];
          }
    }
#pragma unroll
    for (int mi = 0; mi < MH; ++mi) {
      const int mt = gm * MH + mi;
      if (mt >= KH) continue;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dw = 8 * jn + (e & 1), k = 16 * mt + g + 8 * (e >> 1);
          if (wc + 2 * t + dw < wend && k0 + k < K)
            gb[dw * K + k] = acc[mi][jn][e];
        }
    }
  }

  // the γ pass's g, held across row tiles
  __device__ __forceinline__ void zero() { zero(acc); }
  template <class L>
  __device__ __forceinline__ void product(const L& sm) {
    product(acc, sm);
  }
  __device__ __forceinline__ void store(float* gtile, int W, int K, int wc,
                                        int wend, int k0) {
    store(acc, gtile, W, K, wc, wend, k0, false);
  }

  // the tile's g into the partial at K columns k0 + (16 mt + g (+ 8)),
  // added to what is there where `add` (K7's form, its sums in a local
  // array)
  template <class L>
  __device__ __forceinline__ static void write(const L& sm, float* gtile,
                                               int W, int K, int wc,
                                               int wend, int k0, bool add) {
    Acc a;
    zero(a);
    product(a, sm);
    store(a, gtile, W, K, wc, wend, k0, add);
  }
};

}  // namespace tt
