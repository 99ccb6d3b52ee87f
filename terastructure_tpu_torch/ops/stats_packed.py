"""λ statistics straight from 2-bit packed rows (port of the parts of
terastructure_tpu/ops/stats_pallas.py on the main path).

Planar layout: byte w of a row holds individuals 4w..4w+3, and bit plane
s, `(byte >> 2s) & 3`, holds individuals {4w+s}. u is kept as
`u_planes (4, W, K)` with u_planes[s, w] = u[4w+s], so a kernel decodes a
byte with shifts and masks and reads u for the same (s, w).

Kernels (each wrapper runs its plain twin on CPU tensors, launches its
CUDA kernel on CUDA tensors, and counts `launches` / `twin_calls`):

- K4 `lambda_stats_packed` (csrc/stats_packed.cu): one raw λ pass;
  `local_solve_packed` drives it through the shared solve schedule.
- K8 `lambda_stats_acat` (csrc/stats_acat.cu): the same pass over the
  count planes of `decode_count_planes`; `local_solve_acat` drives it.
- K5 `gamma_stats_packed` (csrc/stats_gamma.cu): the planar γ statistic;
  with K4 it is the pair, `batch_stats_packed`.
- K7 `batch_stats_fused_v2_packed` and K6 `batch_stats_fused_packed`
  (csrc/stats_fused.cuh): λ and γ statistics from one D per entry.

The last four carry the big-N step (svi/engine.step_core_packed). Every
kernel takes any K the twins take: K <= 64 runs the bodies instantiated
at K-widths 4..64, K > 64 their "wide" bodies: for the λ pass (K4, K8),
the γ pass (K5) and K7 bodies that compute D once an entry with K in
pieces of up to 128 columns (csrc/lambda_wide.cuh
`lambda_pass_wide_kernel`, csrc/gamma_wide.cuh `gamma_pass_wide_kernel`,
csrc/stats_fused.cuh `stats_v2_wide_kernel`, which K6 runs too, on the
tile of csrc/wide_tile.cuh).

Every kernel also takes dtype=torch.bfloat16 (compute_dtype
"bfloat16"): T, U and R enter the products rounded to bf16, the sums stay
f32, and the wrappers scale by the unrounded t and u. At K <= 64 the
passes (K4, K5, K8), and the λ and γ passes (K4, K5, K8) and K7 and K6
at any K, run on the tensor cores (csrc/psd_mma.cuh, csrc/lambda_wide.cuh,
csrc/gamma_wide.cuh, csrc/stats_fused.cuh). Each wrapper counts its bf16
launches in `bf16_launches` (`count_launch`).

Batched replicates: every kernel also takes a leading R axis on each
per-replicate input (K4's rows may be shared) and runs the R calls in
one launch, replicate z in the grid's z (csrc/psd_common.cuh `Rep`), at
any K, each replicate bitwise its single call; counted in
`rep_launches` as well. On CPU tensors the twin of a batched call is the
single twin of each replicate, stacked (`stack_twins`).
"""

from __future__ import annotations

import struct

import torch

from terastructure_tpu_torch import _build
from terastructure_tpu_torch.models.psd import elog_beta
from terastructure_tpu_torch.ops.stats_dense import as_operand, solve_schedule

_EPS = 1e-30
SM_COUNT = 132          # H100 SXM


def u_to_planes(u: torch.Tensor) -> torch.Tensor:
    """(..., N, K) -> (..., 4, W, K) planar layout; requires N % 4 == 0.
    A leading axis (batched replicates) is carried through."""
    *lead, n, k = u.shape
    x = u.reshape(*lead, n // 4, 4, k)
    return x.transpose(-3, -2).contiguous()


def planes_to_flat(g: torch.Tensor) -> torch.Tensor:
    """(..., 4, W, K) -> (..., N, K), the inverse of u_to_planes."""
    *lead, _, w, k = g.shape
    return g.transpose(-3, -2).reshape(*lead, 4 * w, k)


def plane_counts(rows: torch.Tensor):
    """Packed rows (B, W) -> allele counts (A1, A0), each (B, 4W) f32 in
    planar column order s*W + w; MISSING (code 3) counts 0 for both."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=rows.device)
    x = (rows[:, None, :] >> shifts[:, None]) & 0x3           # (B, 4, W)
    x = x.reshape(rows.shape[0], -1)
    miss = x == 3
    xf = x.float()
    zero = torch.zeros((), device=rows.device)
    return torch.where(miss, zero, xf), torch.where(miss, zero, 2.0 - xf)


def ratios_planar(a1, a0, u_cat, t1, t0, approx_div=False,
                  dtype=torch.float32):
    """R = A / (T U^T + eps) for both alleles, (B, 4W) each. approx_div
    multiplies by the reciprocal instead of dividing (the kernel's fast
    path differs from both by a few ulp). dtype bf16: T and U enter the
    product rounded to bf16 and R is rounded after the f32 divide (held
    in f32, `as_operand`), as the reference's bf16 kernel bodies do."""
    u_cat = as_operand(u_cat, dtype)
    d1 = as_operand(t1, dtype) @ u_cat.T + _EPS
    d0 = as_operand(t0, dtype) @ u_cat.T + _EPS
    if approx_div:
        r1, r0 = a1 * torch.reciprocal(d1), a0 * torch.reciprocal(d0)
    else:
        r1, r0 = a1 / d1, a0 / d0
    return as_operand(r1, dtype), as_operand(r0, dtype)


def lambda_stats_packed_twin(rows, u_planes, t1, t0, *, approx_div=False,
                             dtype=torch.float32):
    """Plain PyTorch version of K4: raw (l0, l1) = (R1 U, R0 U); at bf16
    R and U enter the products rounded, the sums stay f32."""
    u_cat = u_planes.reshape(-1, u_planes.shape[-1])
    a1, a0 = plane_counts(rows)
    r1, r0 = ratios_planar(a1, a0, u_cat, t1, t0, approx_div, dtype)
    u_cat = as_operand(u_cat, dtype)
    return r1 @ u_cat, r0 @ u_cat


def decode_count_planes(rows: torch.Tensor):
    """Packed rows (B, W) uint8 -> allele-count planes (a1, a0), each
    (B, 4, W) bf16 with a1[b, s, w] the count of individual 4w+s (exact:
    counts are {0, 1, 2}; MISSING is 0 in both). The reference's layout
    (stats_pallas.decode_count_planes); plain torch there and here.
    Batched replicates' rows (R, B, W) give (R, B, 4, W)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=rows.device)
    x = (rows.unsqueeze(-2) >> shifts[:, None]) & 0x3     # (..., B, 4, W)
    miss = x == 3
    xf = x.to(torch.bfloat16)
    zero = torch.zeros((), dtype=torch.bfloat16, device=rows.device)
    return torch.where(miss, zero, xf), torch.where(miss, zero, 2.0 - xf)


def lambda_stats_acat_twin(a1, a0, u_planes, t1, t0, *, approx_div=False,
                           dtype=torch.float32):
    """Plain PyTorch version of K8: K4's (l0, l1) over count planes; at
    bf16 R and U enter the products rounded, the sums stay f32."""
    u_cat = u_planes.reshape(-1, u_planes.shape[-1])
    b = a1.shape[0]
    r1, r0 = ratios_planar(a1.reshape(b, -1).float(),
                           a0.reshape(b, -1).float(), u_cat, t1, t0,
                           approx_div, dtype)
    u_cat = as_operand(u_cat, dtype)
    return r1 @ u_cat, r0 @ u_cat


def gamma_stats_packed_twin(rows, u_planes, t1, t0, dtype=torch.float32):
    """Plain PyTorch version of K5: g (4, W, K) = R1^T T1 + R0^T T0; at
    bf16 R and T enter the products rounded (the γ pass of K1 and K2)."""
    u_cat = u_planes.reshape(-1, u_planes.shape[-1])
    a1, a0 = plane_counts(rows)
    r1, r0 = ratios_planar(a1, a0, u_cat, t1, t0, dtype=dtype)
    return (r1.T @ as_operand(t1, dtype)
            + r0.T @ as_operand(t0, dtype)).reshape(u_planes.shape)


def batch_stats_fused_twin(rows, u_planes, t1, t0, *, approx_div=False,
                           dtype=torch.float32):
    """Plain PyTorch version of K7 and K6: one R feeds both statistics;
    at bf16 R, T and U enter the products rounded, the sums stay f32.
    Returns (g (4, W, K), l0_raw (B, K), l1_raw (B, K))."""
    u_cat = u_planes.reshape(-1, u_planes.shape[-1])
    a1, a0 = plane_counts(rows)
    r1, r0 = ratios_planar(a1, a0, u_cat, t1, t0, approx_div, dtype)
    u_cat = as_operand(u_cat, dtype)
    g = (r1.T @ as_operand(t1, dtype)
         + r0.T @ as_operand(t0, dtype)).reshape(u_planes.shape)
    return g, r1 @ u_cat, r0 @ u_cat


def pad_individuals(u: torch.Tensor, w: int) -> torch.Tensor:
    """u (..., N, K) -> (..., 4W, K), padding individuals with 1.0: their
    genotypes decode as MISSING, so they add nothing."""
    *lead, n, k = u.shape
    if n != 4 * w:
        u = torch.cat([u, u.new_ones((*lead, 4 * w - n, k))], -2)
    return u


def check_shapes(name, rows, u_planes):
    """Validate the (B, W) rows and (4, W, K) u_planes of a kernel call."""
    if rows.dim() != 2 or u_planes.dim() != 3 or u_planes.shape[0] != 4:
        raise ValueError(f"{name}: rows (B, W), u_planes (4, W, K)")
    if u_planes.shape[1] != rows.shape[1]:
        raise ValueError(f"{name}: W mismatch {rows.shape} vs "
                         f"{tuple(u_planes.shape)}")
    if u_planes.shape[2] < 1:
        raise ValueError(f"{name}: K must be at least 1")


def check_t(name, b, k, t1, t0):
    """Validate the (B, K) t1, t0 of a kernel call."""
    if t1.shape != (b, k) or t0.shape != (b, k):
        raise ValueError(f"{name}: t1, t0 must be (B, K) = ({b}, {k})")


def check_dtype(name, dtype):
    """Validate a kernel call's compute dtype, the type its products take
    their operands in (the sums stay f32): float32 or bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{name}: compute dtype {dtype} is not ported (float32, "
            "bfloat16)")


def count_launch(fn, dtype, r=None):
    """One launch of fn's kernel: counted in fn.bf16_launches for its bf16
    body, in fn.launches otherwise, and in fn.rep_launches as well where
    it has the replicate axis (r, the replicates, is not None)."""
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1
    if r is not None:
        fn.rep_launches += 1


def replicates(name, x, dims, u_planes, t1, t0):
    """The replicate axis of a call: None for a single call (x with
    `dims` dimensions), R where every per-replicate input has a leading R
    (x, u_planes (R, 4, W, K), t1, t0 (R, B, K)). Raises on a mix."""
    if x.dim() == dims:
        return None
    r = x.shape[0]
    if (x.dim() != dims + 1 or u_planes.dim() != 4 or u_planes.shape[0] != r
            or t1.dim() != 3 or t1.shape[0] != r or t0.shape[:1] != (r,)):
        raise ValueError(f"{name}: a batched call takes every per-replicate "
                         f"input with a leading R = {r}")
    return r


def one_replicate(r, *xs):
    """The inputs of a single call as they are (r None), or replicate 0's
    of a batched call: what the single call's checks read."""
    return xs if r is None else tuple(x[0] for x in xs)


def stack_twins(twin, r, *args, **kw):
    """The twin of a batched call: twin(*args) of each of the r
    replicates (args with a leading R), stacked."""
    outs = [twin(*(a[i] for a in args), **kw) for i in range(r)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


def _entry(name, dtype):
    """The C entry point of a kernel's body at compute dtype `dtype`:
    `name`, or its bf16 body `name`_bf16 (the same arguments)."""
    return getattr(_build.lib(),
                   name + "_bf16" if dtype == torch.bfloat16 else name)


def mma_kp(k: int) -> int:
    """K padded to the k16 steps of D at the K-width a body runs (16 to
    K = 16, then 32, then 64): the row width, in bf16, of the rounded u
    (R, 4W, KP) and t (R, 2, B, KP) that the bf16 passes at K <= 64
    stage (csrc/psd_common.cuh `mma_kp`)."""
    return 16 if k <= 16 else 32 if k <= 32 else 64


def rounded_scratch(lead, rows, k, dev, dtype):
    """The scratch of a bf16 pass at K <= 64 (None otherwise): bf16
    (*lead, rows, mma_kp(k)), which the kernel fills with the rounded u
    (rows 4W) or t (rows 2B) before the pass reads it."""
    if dtype != torch.bfloat16 or k > 64:
        return None
    return torch.empty((*lead, rows, mma_kp(k)), dtype=torch.bfloat16,
                       device=dev)


def rcp_rn_mismatches(lo: float, hi: float, device) -> int:
    """How many floats x in [lo, hi) give the bf16 passes' exact
    reciprocal (csrc/psd_mma.cuh `rcp_rn`, the hardware reciprocal and a
    Newton step) other bits than the IEEE one, __frcp_rn: 0 means their
    exact divide is the IEEE divide's bits on that range. On the card."""
    lo_bits, hi_bits = (struct.unpack("<I", struct.pack("<f", v))[0]
                        for v in (lo, hi))
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _build.check(_build.lib().tt_rcp_rn_check(
        lo_bits, hi_bits, bad.data_ptr(), _build.stream_ptr(bad.device)),
        "rcp_rn_check")
    return int(bad.item())


def c_ptr(x):
    """A tensor's pointer for a C entry, None (NULL) for no tensor."""
    return None if x is None else x.data_ptr()


def _device_of(name, x):
    """'cpu' (run the twin) or 'cuda' (launch the kernel); else raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


GAMMA_COLS = 32         # byte columns of a γ-pass CTA (4 warps, a plane each)
# bf16 at K <= 64 (csrc/psd_mma.cuh): the fewest CTAs and the longest
# slice of rows of the row split (`gamma_grid`)
GAMMA_MMA_CTAS = 640
GAMMA_MMA_SLICE = 1024
# K > 64 (csrc/gamma_wide.cuh): a CTA of 8 warps takes GAMMA_WIDE_COLS
# byte columns and walks its row split in row tiles of GAMMA_WIDE_ROWS
GAMMA_WIDE_COLS = 16
GAMMA_WIDE_ROWS = 64


def gamma_grid(b: int, w: int, k: int, dtype=torch.float32) -> int:
    """The γ pass's row split at a batch of b rows of w bytes: CTA (i, j)
    takes its byte columns and the j-th of `nsplit` slices of rows,
    walked in order. At K <= 64 CTAs of 32 byte columns, slices of at
    least 32 rows: at f32 about four CTAs an SM where the batch allows;
    at bf16 (the tensor-core body, which walks its slice in 64-row blocks
    with the next block in flight) at least GAMMA_MMA_CTAS CTAs and
    slices of at most GAMMA_MMA_SLICE rows, whose CTAs fill the card's
    waves (K5 at the big-N shape: 4 slices, 0.517 ms against 0.568 at 1;
    NVIDIA H100 80GB HBM3, chip_smoke.py --kernels). At K > 64
    CTAs of 16 byte columns walk slices of whole 64-row tiles (the
    kernels' slice: ceil(b / nsplit) rounded up to 64), at f32 one CTA an
    SM: the slice is the longest, up to 64 row tiles, whose CTAs fill
    their last wave on the card's SMs at least 95% as well as the best
    slice does (`lambda_grid`'s rule; chip_smoke.py --kernels,
    `gamma_split_sweep`). A function of the shape and the dtype only, so
    the summation order, and the result, never depend on anything else."""
    if k > 64:
        cols = -(-w // GAMMA_WIDE_COLS)
        tiles = -(-b // GAMMA_WIDE_ROWS)

        def fill(n):
            ctas = cols * -(-tiles // n)
            return ctas / (-(-ctas // SM_COUNT) * SM_COUNT)

        lengths = range(1, min(tiles, 64) + 1)
        best = max(fill(n) for n in lengths)
        n = max(n for n in lengths if fill(n) >= 0.95 * best)
        return -(-tiles // n)
    ncol = -(-w // GAMMA_COLS)
    if dtype == torch.bfloat16:
        return min(-(-b // 32), max(-(-GAMMA_MMA_CTAS // ncol),
                                    -(-b // GAMMA_MMA_SLICE)))
    return max(1, min(-(-b // 32), 4 * SM_COUNT // ncol))


LAMBDA_ROWS = 64        # rows of a lambda-pass CTA: 2 warps, a row a lane
# K > 64 (csrc/lambda_wide.cuh): a CTA of 8 warps takes its 64 rows' chunk
# in sub-tiles of LAMBDA_WIDE_COLS byte columns
LAMBDA_WIDE_COLS = 16
# bf16 at K <= 64 (csrc/psd_mma.cuh): the fewest CTAs and the widest
# chunk of byte columns of the column split (`lambda_grid`)
LAMBDA_MMA_CTAS = 512
LAMBDA_MMA_CHUNK = 512


def lambda_grid(b: int, w: int, k: int, dtype=torch.float32):
    """The lambda pass's column split at a batch of b rows of w bytes and
    K = k: (nsplit, chunk), with CTA (i, j) taking rows [64 i, 64 i + 64)
    and byte columns [j chunk, (j + 1) chunk).

    K <= 64 at f32: a warp walks its 32 rows' chunk alone, so the chunk
    sets how many warps there are: it is a multiple of 16 between 16 and
    128 columns, chosen so that about 16 warps an SM are in flight where
    the batch allows. K <= 64 at bf16 (the tensor-core body: a CTA of 4
    warps walks its chunk in tiles of 64 or 32 columns, the next one in
    flight): the widest whole number of 64-column tiles, up to
    LAMBDA_MMA_CHUNK columns, that leaves at least LAMBDA_MMA_CTAS CTAs,
    else the widest multiple of 16 that does (the TGP shape: 10 splits of
    64; config #3's B = 1,024: 40 of 16; the big-N shape: 49 of 512;
    NVIDIA H100 80GB HBM3, chip_smoke.py --kernels). K > 64: a CTA of 8
    warps walks its chunk in sub-tiles of 16 columns and pays for staging
    t and writing its sums once a chunk, and at f32 one CTA fills an SM;
    so the chunk is the widest multiple of 16 between 32 and 256 columns
    whose CTAs fill their last wave on the card's SMs at least 95% as
    well as the best chunk does (a count of CTAs just past a multiple of
    the SMs costs a wave nearly empty: chip_smoke.py --kernels,
    `split_sweep`). A function of the shape and the dtype only, so the
    summation order, and the result, never depend on anything else."""
    if k > 64:
        tiles = -(-b // LAMBDA_ROWS)

        def fill(chunk):
            ctas = tiles * -(-w // chunk)
            return ctas / (-(-ctas // SM_COUNT) * SM_COUNT)

        chunks = range(2 * LAMBDA_WIDE_COLS, 257, LAMBDA_WIDE_COLS)
        best = max(fill(c) for c in chunks)
        chunk = max(c for c in chunks if fill(c) >= 0.95 * best)
    elif dtype == torch.bfloat16:
        tiles = -(-b // LAMBDA_ROWS)
        chunks = [c for c in range(LAMBDA_MMA_CHUNK, 0, -16)
                  if tiles * -(-w // c) >= LAMBDA_MMA_CTAS]
        whole = [c for c in chunks if c % 64 == 0]
        chunk = (whole or chunks or [16])[0]
    else:
        row_warps = -(-b // 32)
        chunk = w * row_warps // (16 * SM_COUNT) // 16 * 16
        chunk = max(16, min(128, chunk))
    nsplit = -(-w // chunk)
    # the chunk the kernels derive from nsplit (csrc: tt::split_chunk)
    return nsplit, -(-(-(-w // nsplit)) // 16) * 16


def lambda_stats_packed(rows: torch.Tensor, u_planes: torch.Tensor,
                        t1: torch.Tensor, t0: torch.Tensor, *,
                        approx_div: bool = False, dtype=torch.float32):
    """Raw λ statistics from packed rows.

    rows (B, W) uint8; u_planes (4, W, K) f32; t1, t0 (B, K) f32.
    Returns (l0_raw, l1_raw), each (B, K) f32; the caller multiplies by
    t1 / t0. dtype: the products' operand type, float32 or bfloat16 (T,
    U and R rounded to bf16, sums in f32: the bf16 body, counted in
    `bf16_launches`).

    Batched replicates: u_planes (R, 4, W, K) and t1, t0 (R, B, K) run R
    passes in one launch (the replicate axis, counted in `rep_launches`
    as well), over rows (B, W) that every replicate shares or (R, B, W)
    of their own; returns (R, B, K) each, replicate r bitwise the single
    call's on its inputs. The twin of a batched call is the twin of each
    replicate, stacked.
    """
    name = "lambda_stats_packed"
    check_dtype(name, dtype)
    r = u_planes.shape[0] if u_planes.dim() == 4 else None
    shared = rows.dim() == 2
    if r is None and not shared:
        raise ValueError(f"{name}: rows (R, B, W) take u_planes (R, 4, W, "
                         "K)")
    if not shared and rows.shape[0] != r:
        raise ValueError(f"{name}: rows (R, B, W) with R = {r}")
    check_shapes(name, rows if shared else rows[0],
                 u_planes if r is None else u_planes[0])
    b, w = rows.shape[-2:]
    k = u_planes.shape[-1]
    if r is None:
        check_t(name, b, k, t1, t0)
    elif t1.shape != (r, b, k) or t0.shape != (r, b, k):
        raise ValueError(f"{name}: t1, t0 must be (R, B, K) = ({r}, {b}, "
                         f"{k})")
    if _device_of(name, rows) == "cpu":
        lambda_stats_packed.twin_calls += 1
        if r is None:
            return lambda_stats_packed_twin(rows, u_planes, t1, t0,
                                            approx_div=approx_div,
                                            dtype=dtype)
        outs = [lambda_stats_packed_twin(rows if shared else rows[i],
                                         u_planes[i], t1[i], t0[i],
                                         approx_div=approx_div, dtype=dtype)
                for i in range(r)]
        return tuple(torch.stack(x) for x in zip(*outs))
    _build.require_cuda(name, rows, u_planes, t1, t0,
                        dtypes=(torch.uint8,) + (torch.float32,) * 3)
    out = launch_lambda_stats_packed(rows, u_planes, t1, t0,
                                     lambda_grid(b, w, k, dtype)[0],
                                     approx_div, dtype == torch.bfloat16)
    count_launch(lambda_stats_packed, dtype, r)
    return out


def launch_lambda_stats_packed(rows, u_planes, t1, t0, nsplit, approx_div,
                               bf16=False):
    """K4's launch at a given column split (validated CUDA tensors).
    `lambda_stats_packed` passes `lambda_grid`'s; chip_smoke.py's sweep
    passes others to show where the chosen split stands. bf16: the bf16
    body's entry. u_planes (R, 4, W, K) with t1, t0 (R, B, K) launch R
    replicates, over rows (B, W) shared or (R, B, W) their own."""
    b, w = rows.shape[-2:]
    k = u_planes.shape[-1]
    lead = tuple(u_planes.shape[:-3])
    dev = rows.device
    l0 = torch.empty((*lead, b, k), dtype=torch.float32, device=dev)
    l1 = torch.empty_like(l0)
    part = torch.empty((*lead, nsplit, b, k, 2), dtype=torch.float32,
                       device=dev)
    args = (lead[0] if lead else 1, rows.data_ptr(), u_planes.data_ptr(),
            t1.data_ptr(), t0.data_ptr(), l0.data_ptr(), l1.data_ptr(),
            part.data_ptr())
    if bf16:
        ub = rounded_scratch(lead, 4 * w, k, dev, torch.bfloat16)
        err = _build.lib().tt_lambda_stats_packed_bf16(
            *args, c_ptr(ub), b, w, k, nsplit, int(approx_div),
            b * w if rows.dim() == 3 else 0, _build.stream_ptr(dev))
    else:
        err = _build.lib().tt_lambda_stats_packed(
            *args, b, w, k, nsplit, int(approx_div),
            b * w if rows.dim() == 3 else 0, _build.stream_ptr(dev))
    _build.check(err, "lambda_stats_packed")
    return l0, l1


lambda_stats_packed.launches = 0
lambda_stats_packed.bf16_launches = 0
lambda_stats_packed.rep_launches = 0
lambda_stats_packed.twin_calls = 0


def local_solve_packed(rows, u, lamb_b, *, beta_a, beta_b, local_iters,
                       local_tol, stat_scale=1.0, approx_div=False,
                       accel=False, pad_rows=0, dtype=torch.float32,
                       ind_reduce=None):
    """Local coordinate ascent from packed rows on the shared schedule.

    u: (N, K) with N = 4 * W (caller pads); returns lamb_b (B, K, 2).
    stat_scale rescales the individual-summed statistics (N/Ns for a
    column subsample). pad_rows: the reference's all-MISSING batch rows
    that the tol test counts (`solve_schedule`). dtype: K4's compute
    dtype.

    Batched replicates: u (R, N, K) and lamb_b (R, B, K, 2) run R solves
    over the same rows (B, W), K4 with its replicate axis, each with its
    own tol test (`solve_schedule`); returns
    (R, B, K, 2), replicate r bitwise the single solve's.

    ind_reduce: None, or (l0, l1) -> (l0, l1) applied to each pass's raw
    sums before they are scaled by t (the sharded step's all-reduce over
    the ranks that hold the other individuals, parallel/sharded.py).
    """
    u_planes = u_to_planes(u)

    def iterate(lam):
        e1, e0 = elog_beta(lam)
        t1, t0 = torch.exp(e1), torch.exp(e0)
        l0, l1 = lambda_stats_packed(rows, u_planes, t1, t0,
                                     approx_div=approx_div, dtype=dtype)
        if ind_reduce is not None:
            l0, l1 = ind_reduce(l0, l1)
        return torch.stack([beta_a + stat_scale * t1 * l0,
                            beta_b + stat_scale * t0 * l1], -1)

    return solve_schedule(iterate, lamb_b, local_iters=local_iters,
                          local_tol=local_tol, accel=accel,
                          pad_rows=pad_rows, prior=(beta_a, beta_b))


def lambda_stats_acat(a1: torch.Tensor, a0: torch.Tensor,
                      u_planes: torch.Tensor, t1: torch.Tensor,
                      t0: torch.Tensor, *, approx_div: bool = False,
                      dtype=torch.float32):
    """Raw λ statistics from pre-decoded count planes.

    a1, a0 (B, 4, W) bf16 (`decode_count_planes`, at both dtypes);
    u_planes (4, W, K) f32; t1, t0 (B, K) f32. Returns (l0_raw, l1_raw),
    each (B, K) f32. dtype: the products' operand type, as
    `lambda_stats_packed`'s (the bf16 body counts in `bf16_launches`).
    Batched replicates: a1, a0 (R, B, 4, W), u_planes (R, 4, W, K), t1,
    t0 (R, B, K) -> (R, B, K) each.
    """
    name = "lambda_stats_acat"
    r = replicates(name, a1, 3, u_planes, t1, t0)
    a, up, s1, s0 = one_replicate(r, a1, u_planes, t1, t0)
    if a.dim() != 3 or a.shape[1] != 4 or a0.shape != a1.shape:
        raise ValueError(f"{name}: a1, a0 must be (B, 4, W)")
    check_shapes(name, a[:, 0], up)
    check_dtype(name, dtype)
    b, _, w = a.shape
    k = up.shape[-1]
    check_t(name, b, k, s1, s0)
    if _device_of(name, a1) == "cpu":
        lambda_stats_acat.twin_calls += 1
        args = (a1, a0, u_planes, t1, t0)
        kw = dict(approx_div=approx_div, dtype=dtype)
        if r is None:
            return lambda_stats_acat_twin(*args, **kw)
        return stack_twins(lambda_stats_acat_twin, r, *args, **kw)
    _build.require_cuda(name, a1, a0, u_planes, t1, t0,
                        dtypes=(torch.bfloat16,) * 2 + (torch.float32,) * 3)
    out = launch_lambda_stats_acat(a1, a0, u_planes, t1, t0,
                                   lambda_grid(b, w, k, dtype)[0],
                                   approx_div, dtype == torch.bfloat16)
    count_launch(lambda_stats_acat, dtype, r)
    return out


def launch_lambda_stats_acat(a1, a0, u_planes, t1, t0, nsplit, approx_div,
                             bf16=False):
    """K8's launch at a given column split (validated CUDA tensors), as
    `launch_lambda_stats_packed` is K4's: `lambda_stats_acat` passes
    `lambda_grid`'s; chip_smoke.py's sweep passes others. a1, a0 (R, B,
    4, W) with u_planes (R, 4, W, K) and t1, t0 (R, B, K) launch R
    replicates."""
    b, _, w = a1.shape[-3:]
    k = u_planes.shape[-1]
    lead = tuple(u_planes.shape[:-3])
    dev = a1.device
    l0 = torch.empty((*lead, b, k), dtype=torch.float32, device=dev)
    l1 = torch.empty_like(l0)
    part = torch.empty((*lead, nsplit, b, k, 2), dtype=torch.float32,
                       device=dev)
    args = (lead[0] if lead else 1, a1.data_ptr(), a0.data_ptr(),
            u_planes.data_ptr(), t1.data_ptr(), t0.data_ptr(),
            l0.data_ptr(), l1.data_ptr(), part.data_ptr())
    if bf16:
        ub = rounded_scratch(lead, 4 * w, k, dev, torch.bfloat16)
        err = _build.lib().tt_lambda_stats_acat_bf16(
            *args, c_ptr(ub), b, w, k, nsplit, int(approx_div),
            _build.stream_ptr(dev))
    else:
        err = _build.lib().tt_lambda_stats_acat(
            *args, b, w, k, nsplit, int(approx_div), _build.stream_ptr(dev))
    _build.check(err, "lambda_stats_acat")
    return l0, l1


lambda_stats_acat.launches = 0
lambda_stats_acat.bf16_launches = 0
lambda_stats_acat.rep_launches = 0
lambda_stats_acat.twin_calls = 0


def local_solve_acat(rows, u, lamb_b, *, beta_a, beta_b, local_iters,
                     local_tol, stat_scale=1.0, approx_div=False,
                     accel=False, pad_rows=0, dtype=torch.float32,
                     ind_reduce=None):
    """`local_solve_packed` with the counts decoded once up front: the
    schedule iterates K8 over the planes instead of unpacking the rows
    every pass. Same arguments and result (dtype: K8's compute dtype;
    the planes are bf16 at both).

    Where `local_solve_acat.loop_passes` is a list, each solve appends to
    it how many of its loop passes the reference's while_loop would run
    (`solve_schedule(passes=)`: a device scalar; the host reads none).

    Batched replicates: rows (R, B, W), u (R, N, K) and lamb_b (R, B, K,
    2) run R solves, K8 with its replicate axis, each with its own tol
    test; loop_passes then takes one count per replicate. ind_reduce: as
    `local_solve_packed`'s."""
    u_planes = u_to_planes(u)
    a1, a0 = decode_count_planes(rows)

    def iterate(lam):
        e1, e0 = elog_beta(lam)
        t1, t0 = torch.exp(e1), torch.exp(e0)
        l0, l1 = lambda_stats_acat(a1, a0, u_planes, t1, t0,
                                   approx_div=approx_div, dtype=dtype)
        if ind_reduce is not None:
            l0, l1 = ind_reduce(l0, l1)
        return torch.stack([beta_a + stat_scale * t1 * l0,
                            beta_b + stat_scale * t0 * l1], -1)

    return solve_schedule(iterate, lamb_b, local_iters=local_iters,
                          local_tol=local_tol, accel=accel,
                          pad_rows=pad_rows, prior=(beta_a, beta_b),
                          passes=local_solve_acat.loop_passes)


local_solve_acat.loop_passes = None


def gamma_stats_packed(rows: torch.Tensor, u_planes: torch.Tensor,
                       t1: torch.Tensor, t0: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Raw planar γ statistic (4, W, K) f32 = Σ_b Rᵀ [T1; T0] (exact
    divide); the caller re-interleaves with planes_to_flat and multiplies
    by u. dtype bf16: the γ pass K1 and K2 run at bf16 (U, T and R
    rounded to bf16, sums in f32), counted in `bf16_launches`. Batched
    replicates: rows (R, B, W), u_planes (R, 4, W, K), t1, t0 (R, B, K)
    -> (R, 4, W, K)."""
    name = "gamma_stats_packed"
    r = replicates(name, rows, 2, u_planes, t1, t0)
    rs, up, s1, s0 = one_replicate(r, rows, u_planes, t1, t0)
    check_shapes(name, rs, up)
    check_dtype(name, dtype)
    b, w = rs.shape
    k = up.shape[-1]
    check_t(name, b, k, s1, s0)
    if _device_of(name, rows) == "cpu":
        gamma_stats_packed.twin_calls += 1
        if r is None:
            return gamma_stats_packed_twin(rows, u_planes, t1, t0, dtype)
        return stack_twins(gamma_stats_packed_twin, r, rows, u_planes, t1,
                           t0, dtype=dtype)
    _build.require_cuda(name, rows, u_planes, t1, t0,
                        dtypes=(torch.uint8,) + (torch.float32,) * 3)
    g = launch_gamma_stats_packed(rows, u_planes, t1, t0,
                                  gamma_grid(b, w, k, dtype),
                                  dtype == torch.bfloat16)
    count_launch(gamma_stats_packed, dtype, r)
    return g


def launch_gamma_stats_packed(rows, u_planes, t1, t0, nsplit, bf16=False):
    """K5's launch at a given row split (validated CUDA tensors).
    `gamma_stats_packed` passes `gamma_grid`'s; chip_smoke.py's sweep
    passes others to show where the chosen split stands. bf16: the bf16
    body's entry. rows (R, B, W) with u_planes (R, 4, W, K) and t1, t0
    (R, B, K) launch R replicates."""
    b, w = rows.shape[-2:]
    k = u_planes.shape[-1]
    lead = tuple(u_planes.shape[:-3])
    dev = rows.device
    g = torch.empty((*lead, 4, w, k), dtype=torch.float32, device=dev)
    gpart = torch.empty((*lead, nsplit, 4 * w, k), dtype=torch.float32,
                        device=dev)
    args = (lead[0] if lead else 1, rows.data_ptr(), u_planes.data_ptr(),
            t1.data_ptr(), t0.data_ptr(), g.data_ptr(), gpart.data_ptr())
    if bf16:
        tb = rounded_scratch(lead, 2 * b, k, dev, torch.bfloat16)
        err = _build.lib().tt_gamma_stats_packed_bf16(
            *args, c_ptr(tb), b, w, k, nsplit, _build.stream_ptr(dev))
    else:
        err = _build.lib().tt_gamma_stats_packed(
            *args, b, w, k, nsplit, _build.stream_ptr(dev))
    _build.check(err, "gamma_stats_packed")
    return g


gamma_stats_packed.launches = 0
gamma_stats_packed.bf16_launches = 0
gamma_stats_packed.rep_launches = 0
gamma_stats_packed.twin_calls = 0


def batch_stats_packed(rows, u, t1, t0, *, dtype=torch.float32):
    """All sufficient statistics from packed rows with the pair K4 + K5.

    u (4W, K) (caller pads); t1, t0 (B, K) from the converged λ. Returns
    (gamma_stat (4W, K), l0 (B, K), l1 (B, K)), the λ statistics already
    scaled by t, as stats_dense.batch_stats. dtype: both kernels' compute
    dtype. Batched replicates: every input and output with a leading R.
    """
    u_planes = u_to_planes(u)
    l0, l1 = lambda_stats_packed(rows, u_planes, t1, t0, dtype=dtype)
    g = gamma_stats_packed(rows, u_planes, t1, t0, dtype)
    return u * planes_to_flat(g), t1 * l0, t0 * l1


V2_TILE_ROWS = 128        # K7's CTA tile at K <= 64: rows (a lane each) ...
V2_WIDE_TILE_ROWS = 64    # ... and at K > 64 (128 M-rows: t1, t0 of each)
V2_TILE_COLS = 256        # ... x byte columns (4 x 256 individuals)
V2_WIDE_MIN_CTAS = 256    # K > 64: the fewest CTAs a B tile may leave


def v2_tile_rows(k: int, dtype=torch.float32) -> int:
    """Rows of K7's CTA tile at K = k: the row tiles of its γ partials.
    The bf16 tensor-core body at K <= 64 gives a warp 4 / KD m-tiles of 8
    rows (KD = ceil(K' / 16), K' the K-width `pick_km` instantiates), so
    that its registers do not grow with K: 128 rows at K <= 16, 64 at
    K <= 32, 32 at K <= 64 (csrc/stats_fused.cuh `V2Mma`). At K > 64 both
    dtypes' body takes 64 rows, whose λ sums (128 M-rows x a piece of up
    to 128 columns of K) its 8 warps hold in registers
    (`stats_v2_wide_kernel`)."""
    if k > 64:
        return V2_WIDE_TILE_ROWS
    if dtype == torch.bfloat16:
        return 32 * (4 // (1 if k <= 16 else 2 if k <= 32 else 4))
    return V2_TILE_ROWS


def v2_b_tile(b: int, w: int, k: int, dtype=torch.float32) -> int:
    """Rows of K7's B tile at a call of b rows, w byte columns and K = k:
    a CTA's rows, one γ partial each. At K <= 64 the body's row tile. At
    K > 64 a CTA walks 4 row tiles of `v2_tile_rows` rows and adds their
    g into one partial, so that the γ partials take (B/256, 4W, K) floats
    as the K-chunked body's did (18.4 GB at N = 1M, K = 72 and R = 4,
    not 74); 2 or 1 row tiles where 4 would leave fewer than
    V2_WIDE_MIN_CTAS CTAs a replicate (B = 1,024, W = 2,048: 1), where the
    partials are small (below 2 MiB x K)."""
    rows = v2_tile_rows(k, dtype)
    if k <= 64:
        return rows
    nwt = -(-w // V2_TILE_COLS)
    for group in (4, 2):
        if nwt * -(-b // (group * rows)) >= V2_WIDE_MIN_CTAS:
            return group * rows
    return rows


def v2_partial_shapes(b: int, w: int, k: int, dtype=torch.float32):
    """K7's partial sums at a call of b rows, w byte columns and K = k:
    the λ partials (W tiles, B, K, 2), one per tile of V2_TILE_COLS byte
    columns, and the γ partials (B tiles, 4W, K), one per `v2_b_tile`
    rows; the launch adds each in tile order. A batched call holds R of
    each."""
    nwt, nbt = -(-w // V2_TILE_COLS), -(-b // v2_b_tile(b, w, k, dtype))
    return (nwt, b, k, 2), (nbt, 4 * w, k)


def _stats_args(name, rows, u, t1, t0):
    """Validate a statistics pass's arguments, single or batched (a
    leading R on each): (u_planes, R or None, B, W, K)."""
    u_planes = u_to_planes(u)
    r = replicates(name, rows, 2, u_planes, t1, t0)
    rs, up, s1, s0 = one_replicate(r, rows, u_planes, t1, t0)
    check_shapes(name, rs, up)
    b, w = rs.shape
    k = up.shape[-1]
    check_t(name, b, k, s1, s0)
    return u_planes, r, b, w, k


def _fused_twin(rows, u_planes, t1, t0, r, **kw):
    """K7's and K6's twin (`batch_stats_fused_twin`), single or batched."""
    if r is None:
        return batch_stats_fused_twin(rows, u_planes, t1, t0, **kw)
    return stack_twins(batch_stats_fused_twin, r, rows, u_planes, t1, t0,
                       **kw)


def _fused_outputs(b, w, k, r, dev):
    """K7's and K6's outputs: l0, l1 (B, K) and g (4, W, K), with a
    leading R for a batched call."""
    lead = () if r is None else (r,)
    l0 = torch.empty((*lead, b, k), dtype=torch.float32, device=dev)
    g = torch.empty((*lead, 4, w, k), dtype=torch.float32, device=dev)
    return l0, torch.empty_like(l0), g, lead


def _batch_stats(fn, name, rows, u, t1, t0, approx_div, dtype):
    """K7's launch, for K7 and K6 (K6 at the exact divide): the twin on
    CPU tensors, else K7's bodies on their grid (V2_TILE_COLS,
    `v2_b_tile`) with their partial buffers, counted on fn."""
    u_planes, r, b, w, k = _stats_args(name, rows, u, t1, t0)
    check_dtype(name, dtype)
    if _device_of(name, rows) == "cpu":
        fn.twin_calls += 1
        g, l0, l1 = _fused_twin(rows, u_planes, t1, t0, r,
                                approx_div=approx_div, dtype=dtype)
        return u * planes_to_flat(g), t1 * l0, t0 * l1
    _build.require_cuda(name, rows, u_planes, t1, t0,
                        dtypes=(torch.uint8,) + (torch.float32,) * 3)
    dev = rows.device
    tile_rows = v2_b_tile(b, w, k, dtype)
    l0, l1, g, lead = _fused_outputs(b, w, k, r, dev)
    lshape, gshape = v2_partial_shapes(b, w, k, dtype)
    lpart = torch.empty((*lead, *lshape), dtype=torch.float32, device=dev)
    gpart = torch.empty((*lead, *gshape), dtype=torch.float32, device=dev)
    err = _entry("tt_batch_stats_fused_v2", dtype)(
        r or 1, rows.data_ptr(), u_planes.data_ptr(), t1.data_ptr(),
        t0.data_ptr(), l0.data_ptr(), l1.data_ptr(), g.data_ptr(),
        lpart.data_ptr(), gpart.data_ptr(), b, w, k, tile_rows, V2_TILE_COLS,
        int(approx_div), _build.stream_ptr(dev))
    _build.check(err, name)
    count_launch(fn, dtype, r)
    return u * planes_to_flat(g), t1 * l0, t0 * l1


def batch_stats_fused_v2_packed(rows: torch.Tensor, u: torch.Tensor,
                                t1: torch.Tensor, t0: torch.Tensor, *,
                                approx_div: bool = False,
                                dtype=torch.float32):
    """The exact full-N statistics pass in one kernel (K7): each D feeds
    the λ sums (per-W-tile partials) and the γ sums (per-B-tile
    partials), both added in tile order. Same returns as
    `batch_stats_packed`. approx_div: fast divide (stats_approx_div).
    dtype: the products' operand type (the bf16 body counts in
    `bf16_launches`). Batched replicates: rows (R, B, W), u (R, 4W, K),
    t1, t0 (R, B, K), each return with a leading R."""
    return _batch_stats(batch_stats_fused_v2_packed,
                        "batch_stats_fused_v2_packed", rows, u, t1, t0,
                        approx_div, dtype)


batch_stats_fused_v2_packed.launches = 0
batch_stats_fused_v2_packed.bf16_launches = 0
batch_stats_fused_v2_packed.rep_launches = 0
batch_stats_fused_v2_packed.twin_calls = 0


def batch_stats_fused_packed(rows: torch.Tensor, u: torch.Tensor,
                             t1: torch.Tensor, t0: torch.Tensor, *,
                             dtype=torch.float32):
    """The exact full-N statistics pass, v1 (K6): K7's launch at the exact
    divide, so bitwise K7's. The reference's v1 adds λ over W tiles in
    W-tile order, as K7's λ reduction does. Same returns as
    `batch_stats_packed`; counted on its own counters. dtype and batched
    replicates: as `batch_stats_fused_v2_packed`'s."""
    return _batch_stats(batch_stats_fused_packed, "batch_stats_fused_packed",
                        rows, u, t1, t0, False, dtype)


batch_stats_fused_packed.launches = 0
batch_stats_fused_packed.bf16_launches = 0
batch_stats_fused_packed.rep_launches = 0
batch_stats_fused_packed.twin_calls = 0
