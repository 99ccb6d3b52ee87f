"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

These need a CUDA card of compute capability 9.0 and skip elsewhere.
They import no JAX, so they run on a machine without it:

    TERA_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(TERA_TEST_TPU=1 stops tests/conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

from terastructure_tpu_torch.data.pack import pack2bit
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.ops.stats_dense import exp_elog_theta

TOL = dict(rtol=2e-4, atol=2e-4)           # f32, sum order differs
# K1 on an accel schedule against its twin: the share of entries beyond
# TOL, and the rtol every entry of g stays within
ACCEL_FRAC, ACCEL_G_CAP = 1e-3, 1e-2

K1_CASES = {
    "cold_plain": dict(local_iters=6, local_tol=-1.0),
    "cold_accel": dict(local_iters=6, local_tol=-1.0, accel=True),
    "warm_plain": dict(local_iters=4, local_tol=-1.0, warm_start=True),
    "tol_fires_accel": dict(local_iters=7, local_tol=1e-3, accel=True),
    "approx_div": dict(local_iters=7, local_tol=-1.0, approx_div=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(dev, b, n, k, seed):
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(pack2bit(rng.integers(0, 4, (b, n)).astype(
        np.int8))).to(dev)
    gamma = torch.from_numpy(rng.uniform(0.3, 3.0, (n, k)).astype(
        np.float32)).to(dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    lamb = torch.from_numpy(rng.uniform(0.5, 3.0, (b, k, 2)).astype(
        np.float32)).to(dev)
    return rows, up, lamb


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("shape", [(64, 512, 8), (40, 700, 3)])  # ragged B, W
def test_fused_kernel_matches_twin(cuda_device, case, shape):
    rows, up, lamb = _problem(cuda_device, *shape, seed=len(case))
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve.launches
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    assert fused_step.fused_local_solve.launches == before + 1
    tol = dict(rtol=5e-3, atol=5e-3) if kw.get("approx_div") else TOL
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **tol)
    if not kw.get("accel"):   # the clamped Aitken step amplifies sum order
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **tol)


def _groups(dev, l, b, g, seed):
    """K2's inputs: packed (L, W) and B/g group starts (with a repeat)."""
    rng = np.random.default_rng(seed)
    idx0 = rng.integers(0, l // g, b // g) * g
    idx0[-1] = idx0[0]                          # a group drawn twice
    return torch.from_numpy(idx0.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("g", [8, 16])
def test_group_dma_kernel_matches_twin_and_k1(cuda_device, case, g):
    """K2 against its twin, and bitwise against K1 on the gathered rows
    (the same pass code over the same bytes in the same order)."""
    b, n, k, l = 64, 512, 8, 4096
    packed, up, lamb = _problem(cuda_device, l, n, k, seed=len(case) + g)
    idx0 = _groups(cuda_device, l, b, g, seed=g)
    idx = (idx0.long()[:, None] + torch.arange(g, device=cuda_device)
           ).reshape(-1)
    lamb = lamb[idx].contiguous()
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve_dma.launches
    got = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                           **kw)
    assert fused_step.fused_local_solve_dma.launches == before + 1
    want = fused_step.fused_local_solve_dma_twin(idx0, packed, up, lamb,
                                                 group=g, **kw)
    tol = dict(rtol=5e-3, atol=5e-3) if kw.get("approx_div") else TOL
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **tol)
    if not kw.get("accel"):
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **tol)
    k1 = fused_step.fused_local_solve(packed[idx], up, lamb, **kw)
    for a, c in zip(got, k1):
        assert torch.equal(a, c)
    assert torch.equal(got[0][:g], got[0][-g:])     # the repeated group


@pytest.mark.cuda
def test_group_dma_kernel_reads_no_row_outside_the_matrix(cuda_device):
    """A group start out of range reads as an all-MISSING group."""
    b, n, k, l, g = 32, 512, 3, 1024, 8
    packed, up, lamb = _problem(cuda_device, l, n, k, seed=3)
    lamb = lamb[:b].contiguous()
    idx0 = _groups(cuda_device, l, b, g, seed=4)
    bad = idx0.clone()
    bad[1] = l                                   # past the end
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    got = fused_step.fused_local_solve_dma(bad, packed, up, lamb, group=g,
                                           **kw)
    rows = packed[(bad.long().clamp(max=l - g)[:, None]
                   + torch.arange(g, device=cuda_device)).reshape(-1)]
    rows[g:2 * g] = 0xFF
    want = fused_step.fused_local_solve(rows, up, lamb, **kw)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("w,g", [(100, 64), (640, 64), (640, 1), (235, 512),
                                 (235, 1)])
def test_gather_kernel_matches_twin(cuda_device, w, g):
    """Runs of 8W bytes: 16-byte aligned (W even), not (odd W, the byte
    path); one run (G = 1) and many; bitwise the twin and index_select."""
    rng = np.random.default_rng(w + g)
    src = torch.from_numpy(rng.integers(0, 256, (4096, w), dtype=np.uint8))
    starts = torch.from_numpy(rng.integers(0, 512, g).astype(np.int32))
    src, starts = src.to(cuda_device), starts.to(cuda_device)
    before = gather.gather_row_blocks.launches
    got = gather.gather_row_blocks(src, starts)
    assert gather.gather_row_blocks.launches == before + 1
    assert torch.equal(got, gather.gather_row_blocks_twin(src, starts))
    assert torch.equal(got, src.view(-1, 8 * w).index_select(0, starts.long())
                       .view_as(got))


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
def test_lambda_stats_kernel_matches_twin(cuda_device, approx_div):
    rows, up, lamb = _problem(cuda_device, 100, 700, 5, seed=2)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    got = stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                           approx_div=approx_div)
    want = stats_packed.lambda_stats_packed_twin(rows, up, t1, t0,
                                                 approx_div=approx_div)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)


# The big-N kernels on ragged shapes (B not a multiple of 32, W of the
# tiles): K8 over decoded planes, K5, and the statistics passes K7 and K6.
@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("shape", [(12, 384, 3), (100, 700, 10)])
def test_lambda_acat_kernel_matches_twin(cuda_device, approx_div, shape):
    rows, up, lamb = _problem(cuda_device, shape[0], 4 * shape[1], shape[2],
                              seed=5)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    a1, a0 = stats_packed.decode_count_planes(rows)
    before = stats_packed.lambda_stats_acat.launches
    got = stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                         approx_div=approx_div)
    want = stats_packed.lambda_stats_acat_twin(a1, a0, up, t1, t0,
                                               approx_div=approx_div)
    assert stats_packed.lambda_stats_acat.launches == before + 1
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 384, 3), (300, 700, 10)])
def test_gamma_stats_kernel_matches_twin(cuda_device, shape):
    rows, up, lamb = _problem(cuda_device, shape[0], 4 * shape[1], shape[2],
                              seed=6)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    got = stats_packed.gamma_stats_packed(rows, up, t1, t0)
    want = stats_packed.gamma_stats_packed_twin(rows, up, t1, t0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,approx_div", [
    ("batch_stats_fused_v2_packed", False),
    ("batch_stats_fused_v2_packed", True),
    ("batch_stats_fused_packed", False),
])
@pytest.mark.parametrize("shape", [(12, 384, 3), (300, 700, 10)])
def test_stats_pass_kernels_match_twin(cuda_device, name, approx_div, shape):
    rows, up, lamb = _problem(cuda_device, shape[0], 4 * shape[1], shape[2],
                              seed=7)
    u = stats_packed.planes_to_flat(up).contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    kw = dict(approx_div=True) if approx_div else {}
    fn = getattr(stats_packed, name)
    before = fn.launches
    got = fn(rows, u, t1, t0, **kw)
    assert fn.launches == before + 1
    g, l0, l1 = stats_packed.batch_stats_fused_twin(rows, up, t1, t0, **kw)
    want = (u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)
    if not approx_div:      # no atomics: a second launch is bitwise equal
        for a, b in zip(got, fn(rows, u, t1, t0)):
            assert torch.equal(a, b)
    if name == "batch_stats_fused_packed":   # K6: K7's bodies and sum order
        for a, b in zip(got, stats_packed.batch_stats_fused_v2_packed(
                rows, u, t1, t0)):
            assert torch.equal(a, b)


# What the lambda pass's tiling can break: ragged row blocks, byte widths
# that no chunk divides, K across the instantiated widths, whole rows
# MISSING. K1, K4 and K8 against their twins, each bitwise against its own
# second run.
TILING_SHAPES = [(33, 235, 3), (1000, 626, 7), (33, 626, 10),
                 (1000, 235, 16), (72, 640, 33)]          # B, W, K


def _tiling_problem(dev, b, w, k):
    rows, up, lamb = _problem(dev, b, 4 * w, k, seed=b + w + k)
    rows[5] = 0xFF
    rows[-1] = 0xFF
    return rows, up, lamb


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("shape", TILING_SHAPES)
def test_lambda_pass_tiling_k4_k8(cuda_device, shape, approx_div):
    rows, up, lamb = _tiling_problem(cuda_device, *shape)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    a1, a0 = stats_packed.decode_count_planes(rows)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
    got = stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                           approx_div=approx_div)
    want = stats_packed.lambda_stats_packed_twin(rows, up, t1, t0,
                                                 approx_div=approx_div)
    again = stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                             approx_div=approx_div)
    got8 = stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                          approx_div=approx_div)
    again8 = stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                            approx_div=approx_div)
    for g, g8, w, a, a8 in zip(got, got8, want, again, again8):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)
        np.testing.assert_allclose(g8.cpu().numpy(), w.cpu().numpy(), **tol)
        assert torch.equal(g, a) and torch.equal(g8, a8)
    assert float(got[0][5].abs().max()) == 0.0      # a MISSING row adds 0


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("shape", TILING_SHAPES)
def test_lambda_pass_tiling_k1(cuda_device, shape, approx_div):
    rows, up, lamb = _tiling_problem(cuda_device, *shape)
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              approx_div=approx_div)
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    again = fused_step.fused_local_solve(rows, up, lamb, **kw)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
    for g, w, a in zip(got, want, again):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 640, 8), (40, 256, 3),
                                   (72, 128, 10), (136, 384, 16),
                                   (1000, 640, 33)])
def test_lambda_pass_tiling_k2_bitwise_k1(cuda_device, shape):
    """K2 where its gate admits the shape, with a whole row MISSING and a
    null group: bitwise K1 on the gathered rows, and on a second run."""
    b, w, k = shape
    g, l = 8, 4096
    packed, up, lamb = _problem(cuda_device, l, 4 * w, k, seed=b + w + k)
    lamb = lamb[:b].contiguous()
    idx0 = _groups(cuda_device, l, b, g, seed=b)
    packed[int(idx0[0]) + 3] = 0xFF
    idx0[1] = l                                  # reads as all MISSING
    idx = (idx0.long().clamp(max=l - g)[:, None]
           + torch.arange(g, device=cuda_device)).reshape(-1)
    rows = packed[idx]
    rows[g:2 * g] = 0xFF
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              warm_start=True)
    got = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                           **kw)
    again = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                             **kw)
    k1 = fused_step.fused_local_solve(rows, up, lamb, **kw)
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    for a, c, d, w_ in zip(got, again, k1, want):
        assert torch.equal(a, c) and torch.equal(a, d)
        np.testing.assert_allclose(a.cpu().numpy(), w_.cpu().numpy(), **TOL)


# K above the widest instantiated K-width (64): the λ pass's own K > 64
# body (`lambda_pass_wide_kernel`: K in pieces of at most 128 columns, run
# 80 or 128 wide; one piece at K = 65..128, two at 129, 200 (the second 72
# wide) and 256, eight at 1000) and the K-chunked γ pass, at ragged B and
# odd W, each against its twin.
WIDE_LAMBDA_KS = [65, 72, 96, 128, 129, 200, 256, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("k", WIDE_LAMBDA_KS)
def test_k_above_64_runs_the_wide_lambda_pass(cuda_device, k, approx_div,
                                              dtype):
    """K4, K8 and K1 (its loop passes divide by the Newton step, or fast
    with approx_div; its last pass exactly) at B = 40, W = 235 with whole
    rows MISSING, f32 and bf16: one launch each, against the twins at the
    K <= 64 tolerances (f32 TOL; bf16 BF16_PASS for a pass, BF16_SOLVE for
    K1 with at most 0.1% of lambda beyond it; the fast divide 5e-3),
    bitwise on a re-run. K2 at a shape its gate admits, with a null group,
    bitwise K1 on the gathered rows."""
    rows, up, lamb = _tiling_problem(cuda_device, 40, 235, k)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    a1, a0 = stats_packed.decode_count_planes(rows)
    bf16 = dtype == torch.bfloat16
    count = "bf16_launches" if bf16 else "launches"
    fast = dict(rtol=5e-3, atol=5e-3)
    tol = fast if approx_div else BF16_PASS if bf16 else TOL
    want = stats_packed.lambda_stats_packed_twin(rows, up, t1, t0,
                                                 approx_div=approx_div,
                                                 dtype=dtype)
    for fn, call in (
            (stats_packed.lambda_stats_packed,
             lambda: stats_packed.lambda_stats_packed(
                 rows, up, t1, t0, approx_div=approx_div, dtype=dtype)),
            (stats_packed.lambda_stats_acat,
             lambda: stats_packed.lambda_stats_acat(
                 a1, a0, up, t1, t0, approx_div=approx_div, dtype=dtype))):
        before = getattr(fn, count)
        got = call()
        assert getattr(fn, count) == before + 1
        assert all(torch.equal(g, a) for g, a in zip(got, call()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       **tol)
        assert float(got[0][5].abs().max()) == 0.0  # a MISSING row adds 0
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              approx_div=approx_div, dtype=dtype)
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    assert all(torch.equal(g, a) for g, a in zip(
        got, fused_step.fused_local_solve(rows, up, lamb, **kw)))
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    tol = fast if approx_div else BF16_SOLVE if bf16 else TOL
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **tol)
    if bf16:
        _flips(got[0], want[0], tol, 1e-3)
    else:
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **tol)

    b, g, l = 40, 8, 1024
    packed, up, lamb = _problem(cuda_device, l, 4 * 256, k, seed=9)
    lamb = lamb[:b].contiguous()
    idx0 = _groups(cuda_device, l, b, g, seed=9)
    idx0[1] = l                                  # reads as all MISSING
    rows = packed[(idx0.long().clamp(max=l - g)[:, None]
                   + torch.arange(g, device=cuda_device)).reshape(-1)]
    rows[g:2 * g] = 0xFF
    kw["warm_start"] = True
    got = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                           **kw)
    k1 = fused_step.fused_local_solve(rows, up, lamb, **kw)
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    for a, c, w in zip(got[1:], k1[1:], want[1:]):
        assert torch.equal(a, c)
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), **tol)
    assert torch.equal(got[0], k1[0])
    if bf16:
        _flips(got[0], want[0], tol, 1e-3)
    else:
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [72, 256])
def test_wide_fused_solve_reruns_bitwise(cuda_device, k, dtype):
    """K1 at K = 72 and 256 with the accel tail and a tol exit, f32 and
    bf16, and K4 and K8 (both divides) at B = 256, W = 256 (8 column
    splits of 2 sub-tiles): no atomics in the wide bodies, so a second
    run is bitwise equal."""
    rows, up, lamb = _problem(cuda_device, 256, 4 * 256, k, seed=11)
    kw = dict(local_iters=7, local_tol=1e-3, accel=True, beta_a=1.0,
              beta_b=1.0, dtype=dtype)
    fn = fused_step.fused_local_solve
    count = "bf16_launches" if dtype == torch.bfloat16 else "launches"
    before = getattr(fn, count)
    a = fn(rows, up, lamb, **kw)
    c = fn(rows, up, lamb, **kw)
    assert getattr(fn, count) == before + 2
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    a1, a0 = stats_packed.decode_count_planes(rows)
    for approx_div in (False, True):
        for call in (lambda: stats_packed.lambda_stats_packed(
                         rows, up, t1, t0, approx_div=approx_div,
                         dtype=dtype),
                     lambda: stats_packed.lambda_stats_acat(
                         a1, a0, up, t1, t0, approx_div=approx_div,
                         dtype=dtype)):
            assert all(torch.equal(x, y) for x, y in zip(call(), call()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_lambda_pass_gate_skips_a_replicate(cuda_device, dtype):
    """K1[rep] at K = 72, R = 3, on the tol-gated accel schedule: one
    replicate's tol test ends its loop early, so the wide λ pass's
    `active` gate skips its CTAs in the later loop passes while the others
    run on; each replicate bitwise its single call. f32: replicate 0 warm
    at its fixed point (200 plain passes) exits after the first pass, and
    its solve with the loop forced on (local_tol -1) differs (the gate did
    skip). bf16 (whose rounding keeps a fixed point's change above the
    tol): replicate 0's rows all MISSING, its g exactly 0."""
    rows, up, lamb = _rep_problem(cuda_device, 3, 64, 512, 72, seed=21)
    f32 = dtype == torch.float32
    lam0 = lamb.clone()
    if f32:
        lam0[0] = fused_step.fused_local_solve(
            rows[0], up[0], lamb[0], local_iters=200, local_tol=-1.0,
            beta_a=1.0, beta_b=1.0, warm_start=True)[0]
    else:
        rows[0] = 0xFF
    kw = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
              beta_b=1.0, warm_start=f32, dtype=dtype)
    got = fused_step.fused_local_solve(rows, up, lam0, **kw)
    for i in range(3):
        one = fused_step.fused_local_solve(rows[i], up[i], lam0[i], **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))
    if f32:
        forced = fused_step.fused_local_solve(rows[0], up[0], lam0[0],
                                              **dict(kw, local_tol=-1.0))
        assert not torch.equal(forced[1], got[1][0])
    else:
        assert float(got[1][0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [65, 72, 96, 128, 129, 130, 256, 1000])
def test_k_above_64_runs_the_wide_gamma_and_stats_bodies(cuda_device, k):
    """K5 (f32 and bf16: the γ pass's K > 64 body, `gamma_pass_wide_kernel`,
    K in pieces of at most 128 columns), K7 (both divides) and K6 at
    K = 65..1000, B = 40, W = 300: shared memory does not grow with K (one
    piece at K = 65..128, two at 129 and 130). K5 bitwise on a re-run and
    held to its twin at TOL, at bf16 at BF16_PASS; K6 bitwise K7 at the
    exact divide."""
    rows, up, lamb = _problem(cuda_device, 40, 4 * 300, k, seed=k)
    rows[3] = 0xFF
    u = stats_packed.planes_to_flat(up).contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    for dtype, tol in ((torch.float32, TOL), (BF16, BF16_PASS)):
        got = stats_packed.gamma_stats_packed(rows, up, t1, t0, dtype)
        assert torch.equal(got, stats_packed.gamma_stats_packed(
            rows, up, t1, t0, dtype))
        np.testing.assert_allclose(
            got.cpu().numpy(), stats_packed.gamma_stats_packed_twin(
                rows, up, t1, t0, dtype).cpu().numpy(), **tol)
    for name, approx_div in (("batch_stats_fused_v2_packed", False),
                             ("batch_stats_fused_v2_packed", True),
                             ("batch_stats_fused_packed", False)):
        kw = dict(approx_div=True) if approx_div else {}
        got = getattr(stats_packed, name)(rows, u, t1, t0, **kw)
        g, l0, l1 = stats_packed.batch_stats_fused_twin(rows, up, t1, t0,
                                                        **kw)
        want = (u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1)
        tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       **tol)
        if name == "batch_stats_fused_v2_packed" and not approx_div:
            k7 = got
    # K6 runs K7's wide body: bitwise K7 at the exact divide
    assert all(torch.equal(a, b) for a, b in zip(got, k7))


# K7 at K > 64 (`stats_v2_wide_kernel`): one piece of K (65..128, piece
# widths 80, 96 and 128) and several (129, 130: two of 80; 256: two of
# 128; 1000: eight of 128)
K7_WIDE_KS = [65, 72, 96, 128, 129, 130, 256, 1000]


# The γ pass at K > 64 (`gamma_pass_wide_kernel`, csrc/gamma_wide.cuh):
# one piece of K (65..128: 80 wide to K = 80, else 128), two (129: two of
# 80; 256: two of 128) and eight (1000)
WIDE_GAMMA_KS = [65, 72, 128, 129, 256, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [72, 129, 256])
def test_wide_gamma_pass_at_any_row_split(cuda_device, k, dtype):
    """K5 at K > 64 through its launch at row splits of 1, 2, 3, 5 and 16
    (B = 1000: 16 row tiles, the last ragged; 5 splits of 256 rows leave
    the fifth empty, which writes a zero partial) and the split
    `gamma_grid` chooses, W = 301 (a ragged column tile), rows MISSING:
    each held to the twin (TOL; bf16 BF16_PASS) and bitwise on a re-run."""
    rows, up, lamb = _problem(cuda_device, 1000, 4 * 301, k, seed=k + 3)
    rows[[7, 500, 999]] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    bf16 = dtype == BF16
    want = stats_packed.gamma_stats_packed_twin(rows, up, t1, t0,
                                                dtype).cpu().numpy()
    for nsplit in (1, 2, 3, 5, 16, stats_packed.gamma_grid(1000, 301, k)):
        got = stats_packed.launch_gamma_stats_packed(rows, up, t1, t0,
                                                     nsplit, bf16)
        assert torch.equal(got, stats_packed.launch_gamma_stats_packed(
            rows, up, t1, t0, nsplit, bf16))
        np.testing.assert_allclose(got.cpu().numpy(), want,
                                   **(BF16_PASS if bf16 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", WIDE_GAMMA_KS)
def test_k_above_64_gamma_of_k1_and_k2(cuda_device, k, dtype):
    """The γ statistic K1 and K2 end with at K > 64 (t interleaved (B, K,
    2), so the wide γ pass stages it by 4-byte copies) at B = 200 (four
    row tiles, the last ragged), W = 256, rows MISSING and a null group:
    K1's g held to its twin (TOL; bf16 BF16_SOLVE), bitwise on a re-run,
    one launch each; K2 bitwise K1 on the gathered rows."""
    b, g, l = 200, 8, 2048
    packed, up, lamb = _problem(cuda_device, l, 4 * 256, k, seed=k + 5)
    lamb = lamb[:b].contiguous()
    idx0 = _groups(cuda_device, l, b, g, seed=k)
    idx0[2] = l                                  # reads as all MISSING
    packed[int(idx0[0]) + 3] = 0xFF              # a whole row MISSING
    rows = packed[(idx0.long().clamp(max=l - g)[:, None]
                   + torch.arange(g, device=cuda_device)).reshape(-1)]
    rows[2 * g:3 * g] = 0xFF
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              warm_start=True, dtype=dtype)
    bf16 = dtype == BF16
    fn = fused_step.fused_local_solve
    count = "bf16_launches" if bf16 else "launches"
    before = getattr(fn, count)
    k1 = fn(rows, up, lamb, **kw)
    assert getattr(fn, count) == before + 1
    assert all(torch.equal(a, c) for a, c in zip(k1, fn(rows, up, lamb,
                                                        **kw)))
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    np.testing.assert_allclose(k1[1].cpu().numpy(), want[1].cpu().numpy(),
                               **(BF16_SOLVE if bf16 else TOL))
    k2 = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                          **kw)
    assert all(torch.equal(a, c) for a, c in zip(k2, k1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [72, 256])
def test_wide_gamma_rep_is_the_single_call_per_replicate(cuda_device, k,
                                                         dtype):
    """K5[rep] and K1[rep] at K > 64, R = 3, B = 200 (four row tiles),
    W = 301, one replicate's rows partly MISSING: one launch each,
    counted in rep_launches, each replicate bitwise its single call, a
    re-run bitwise."""
    rows, up, lamb = _rep_problem(cuda_device, 3, 200, 4 * 301, k, seed=k)
    rows[1, :70] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              dtype=dtype)
    for fn, call, one in (
            (stats_packed.gamma_stats_packed,
             lambda: [stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                      dtype)],
             lambda i: [stats_packed.gamma_stats_packed(
                 rows[i], up[i], t1[i], t0[i], dtype)]),
            (fused_step.fused_local_solve,
             lambda: fused_step.fused_local_solve(rows, up, lamb, **kw),
             lambda i: fused_step.fused_local_solve(rows[i], up[i], lamb[i],
                                                    **kw))):
        before = fn.rep_launches
        got = call()
        assert fn.rep_launches == before + 1
        assert all(torch.equal(a, c) for a, c in zip(got, call()))
        for i in range(3):
            assert all(torch.equal(a[i], c) for a, c in zip(got, one(i)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(75, 301, 256), (128, 512, 256),
                                   (300, 301, 1), (200, 512, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("k", K7_WIDE_KS)
def test_k7_wide_body_matches_twin(cuda_device, monkeypatch, k, approx_div,
                                   dtype, shape):
    """K7 at K > 64, f32 and bf16, both divides: B = 75 (a ragged row
    tile) with W = 301 (two W tiles, the second ragged; an odd W, so the
    bytes take the byte-wise path) and B = 128 with W = 512 (the bytes by
    16-byte copies), three rows MISSING, among them the last. Then B tiles
    of several row tiles, whose g add into one γ partial, at shapes small
    enough to check (V2_WIDE_MIN_CTAS lowered: `v2_b_tile`): B = 300 in B
    tiles of 256 (4 row tiles, then 1 of 44 rows) and B = 200 in B tiles
    of 128 (2 row tiles, then 2 with 8 rows in the second). One launch,
    against its twin at the tolerances of K <= 64 (f32 TOL, bf16
    BF16_PASS, the fast divide 5e-3), bitwise on a re-run."""
    b, w, min_ctas = shape
    monkeypatch.setattr(stats_packed, "V2_WIDE_MIN_CTAS", min_ctas)
    assert stats_packed.v2_b_tile(b, w, k, dtype) == (
        {1: 256, 3: 128}.get(min_ctas, 64))
    rows, up, lamb = _problem(cuda_device, b, 4 * w, k, seed=k + b)
    rows[[0, 40, b - 1]] = 0xFF
    u = stats_packed.planes_to_flat(up).contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    fn = stats_packed.batch_stats_fused_v2_packed
    count = "bf16_launches" if dtype == torch.bfloat16 else "launches"
    before = getattr(fn, count)
    got = fn(rows, u, t1, t0, approx_div=approx_div, dtype=dtype)
    assert getattr(fn, count) == before + 1
    assert all(torch.equal(a, c) for a, c in zip(
        got, fn(rows, u, t1, t0, approx_div=approx_div, dtype=dtype)))
    g, l0, l1 = stats_packed.batch_stats_fused_twin(
        rows, up, t1, t0, approx_div=approx_div, dtype=dtype)
    want = (u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1)
    tol = (dict(rtol=5e-3, atol=5e-3) if approx_div else
           TOL if dtype == torch.float32 else BF16_PASS)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **tol)


# The K-width of 12 that the gamma pass and K7 instantiate (K = 9..12) and
# its edges, beside the widths every body has.
KM12_KS = [3, 8, 9, 10, 12, 13, 16, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("k", KM12_KS)
def test_gamma_pass_and_k7_across_k_widths(cuda_device, k):
    """K5 and K7 (both divides) at B = 12, W = 385 with whole rows MISSING,
    against their twins and bitwise against a second run."""
    rows, up, lamb = _problem(cuda_device, 12, 4 * 385, k, seed=k + 1)
    rows[4] = 0xFF
    u = stats_packed.planes_to_flat(up).contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    got = stats_packed.gamma_stats_packed(rows, up, t1, t0)
    np.testing.assert_allclose(
        got.cpu().numpy(),
        stats_packed.gamma_stats_packed_twin(rows, up, t1, t0).cpu().numpy(),
        **TOL)
    assert torch.equal(got, stats_packed.gamma_stats_packed(rows, up, t1, t0))
    for approx_div in (False, True):
        fn = stats_packed.batch_stats_fused_v2_packed
        got = fn(rows, u, t1, t0, approx_div=approx_div)
        g, l0, l1 = stats_packed.batch_stats_fused_twin(
            rows, up, t1, t0, approx_div=approx_div)
        want = (u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1)
        tol = dict(rtol=5e-3, atol=5e-3) if approx_div else TOL
        for a, b, c in zip(got, want, fn(rows, u, t1, t0,
                                         approx_div=approx_div)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       **tol)
            assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cold_accel", "approx_div"])
def test_fused_solves_at_k10(cuda_device, case):
    """K1 and K2 at K = 10, where their gamma pass runs 12 wide: against
    the twin, K2 bitwise K1 on the gathered rows (a null group included)."""
    b, w, k, g, l = 64, 384, 10, 8, 1024
    packed, up, lamb = _problem(cuda_device, l, 4 * w, k, seed=10)
    lamb = lamb[:b].contiguous()
    idx0 = _groups(cuda_device, l, b, g, seed=10)
    idx0[2] = l                                  # reads as all MISSING
    rows = packed[(idx0.long().clamp(max=l - g)[:, None]
                   + torch.arange(g, device=cuda_device)).reshape(-1)]
    rows[2 * g:3 * g] = 0xFF
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
    tol = dict(rtol=5e-3, atol=5e-3) if kw.get("approx_div") else TOL
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **tol)
    dma = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                           **kw)
    for a, c in zip(got, dma):
        assert torch.equal(a, c)


# --- compute dtype bf16: K1, K2, K4 and the γ pass --------------------------
# Tolerances against the bf16 twins: one pass rtol 1e-3 (atol 1e-6), a
# solve 2e-3 (atol 1e-5), with at most 0.1% of lambda's entries beyond it
# (a bf(t) that rounds the other way on an ulp of lambda moves its row by
# up to 2^-8), approx_div 5e-3 as in f32. The divergence pin: bf16 differs
# from the f32 body by more than 1e-4 and less than 5e-2 of the largest
# magnitude.
BF16 = torch.bfloat16
BF16_PASS = dict(rtol=1e-3, atol=1e-6)
BF16_SOLVE = dict(rtol=2e-3, atol=1e-5)
BF16_KS = [3, 7, 8, 10, 16, 24, 33, 72]
# (B, individuals, K) of the bf16 cases: a ragged B and an odd W at
# BF16_KS, then B = 200 (four 64-row blocks of the γ pass, the last of 8
# rows) and W = 235 bytes (3.7 tiles of the λ pass, a ragged word) at the
# n8 and k16 edges of the tensor-core bodies (K = 1, 8, 9, 16, 17, 64),
# where a CTA of a one-split call walks at least 3 tiles
WALK_KS = [1, 8, 9, 16, 17, 64]
BF16_SHAPES = ([(75, 940, k) for k in BF16_KS]
               + [(200, 940, k) for k in WALK_KS])


def _replays_bitwise(fn, want):
    """Two replays of one CUDA graph of fn() (its allocations included):
    each bitwise `want`, the eager call's outputs."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(out, want))
    del graph, out


def _rep_bitwise(batched, singles):
    """A batched call's outputs: replicate i bitwise singles[i]."""
    for i, single in enumerate(singles):
        assert all(torch.equal(a[i], c) for a, c in zip(batched, single)), i


def _pinned(got, f32):
    for a, b in zip(got, f32):
        rel = float((a - b).abs().max() / b.abs().max())
        assert 1e-4 < rel < 5e-2, rel


def _flips(got, want, tol, frac):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    bad = np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)
    assert bad.mean() <= frac, bad.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("b,n,k", BF16_SHAPES)
def test_bf16_lambda_and_gamma_pass_match_twins(cuda_device, b, n, k,
                                                approx_div):
    """K4 at bf16 (the tensor-core λ pass at K <= 64, the wide body
    above) and the γ pass at bf16, on a ragged B and an odd W with rows
    MISSING: against their bf16 twins, bitwise on a re-run and on two
    replays of a CUDA graph, pinned; at one split (a CTA walks every tile
    of its rows, every block of its columns) against the twins again; R =
    3 replicates (K4 on shared and on own rows, K5) each bitwise its
    single call."""
    rows, up, lamb = _problem(cuda_device, b, n, k, seed=k)
    rows[3] = 0xFF
    rows[-1] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    before = stats_packed.lambda_stats_packed.bf16_launches
    got = stats_packed.lambda_stats_packed(rows, up, t1, t0, dtype=BF16,
                                           approx_div=approx_div)
    assert stats_packed.lambda_stats_packed.bf16_launches == before + 1
    again = stats_packed.lambda_stats_packed(rows, up, t1, t0, dtype=BF16,
                                             approx_div=approx_div)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = stats_packed.lambda_stats_packed_twin(
        rows, up, t1, t0, approx_div=approx_div, dtype=BF16)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else BF16_PASS
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **tol)
    _pinned(got, stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                                  approx_div=approx_div))
    g = stats_packed.gamma_stats_packed(rows, up, t1, t0, dtype=BF16)
    gwant = stats_packed.gamma_stats_packed_twin(rows, up, t1, t0, BF16)
    np.testing.assert_allclose(g.cpu().numpy(), gwant.cpu().numpy(),
                               **BF16_PASS)
    _pinned([g], [stats_packed.gamma_stats_packed(rows, up, t1, t0)])
    _replays_bitwise(lambda: stats_packed.lambda_stats_packed(
        rows, up, t1, t0, dtype=BF16, approx_div=approx_div), got)
    _replays_bitwise(lambda: [stats_packed.gamma_stats_packed(
        rows, up, t1, t0, dtype=BF16)], [g])
    one = stats_packed.launch_lambda_stats_packed(rows, up, t1, t0, 1,
                                                  approx_div, True)
    for a, c in zip(one, want):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **tol)
    one = stats_packed.launch_gamma_stats_packed(rows, up, t1, t0, 1, True)
    np.testing.assert_allclose(one.cpu().numpy(), gwant.cpu().numpy(),
                               **BF16_PASS)
    rs, ups, lambs = _rep_problem(cuda_device, 3, b, n, k, seed=k)
    rs[1, ::5] = 0xFF
    t1s, t0s = fused_step.exp_elog_beta_kernel(lambs)
    kw = dict(dtype=BF16, approx_div=approx_div)
    _rep_bitwise(stats_packed.lambda_stats_packed(rs[0], ups, t1s, t0s, **kw),
                 [stats_packed.lambda_stats_packed(rs[0], ups[i], t1s[i],
                                                   t0s[i], **kw)
                  for i in range(3)])
    _rep_bitwise(stats_packed.lambda_stats_packed(rs, ups, t1s, t0s, **kw),
                 [stats_packed.lambda_stats_packed(rs[i], ups[i], t1s[i],
                                                   t0s[i], **kw)
                  for i in range(3)])
    _rep_bitwise([stats_packed.gamma_stats_packed(rs, ups, t1s, t0s, BF16)],
                 [[stats_packed.gamma_stats_packed(rs[i], ups[i], t1s[i],
                                                   t0s[i], BF16)]
                  for i in range(3)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cold_plain", "warm_plain", "approx_div"])
@pytest.mark.parametrize("b,n,k", [(64, 512, k) for k in BF16_KS]
                         + [(200, 940, k) for k in WALK_KS])
def test_bf16_fused_solves_match_twin(cuda_device, case, b, n, k):
    """K1 at bf16 against its twin and pinned against f32, bitwise on
    two replays of a CUDA graph, and with R = 3 replicates each bitwise
    its single solve; K2 at bf16 bitwise K1 at bf16 on the gathered rows
    (B = 200: rows MISSING, a ragged word)."""
    rows, up, lamb = _problem(cuda_device, b, n, k, seed=k + len(case))
    if b % 64:
        rows[3] = 0xFF
        rows[-1] = 0xFF
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve.bf16_launches
    got = fused_step.fused_local_solve(rows, up, lamb, dtype=BF16, **kw)
    assert fused_step.fused_local_solve.bf16_launches == before + 1
    want = fused_step.fused_local_solve_twin(rows, up, lamb, dtype=BF16,
                                             **kw)
    tol = dict(rtol=5e-3, atol=5e-3) if kw.get("approx_div") else BF16_SOLVE
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **tol)
    _flips(got[0], want[0], tol, 1e-3)
    _pinned(got, fused_step.fused_local_solve(rows, up, lamb, **kw))
    _replays_bitwise(lambda: fused_step.fused_local_solve(
        rows, up, lamb, dtype=BF16, **kw), got)
    rs, ups, lambs = _rep_problem(cuda_device, 3, b, n, k, seed=k)
    rs[2, 1::3] = 0xFF
    _rep_bitwise(fused_step.fused_local_solve(rs, ups, lambs, dtype=BF16,
                                              **kw),
                 [fused_step.fused_local_solve(rs[i], ups[i], lambs[i],
                                               dtype=BF16, **kw)
                  for i in range(3)])
    g = 8
    if rows.shape[1] % 128:        # K2's gate: W a multiple of 128 bytes
        rows, up, lamb = _problem(cuda_device, b, 1024, k, seed=k)
        rows[3] = 0xFF
    packed = rows.contiguous()
    idx0 = torch.arange(0, b, g, dtype=torch.int32,
                        device=cuda_device).flip(0).contiguous()
    gathered = packed.view(-1, g * packed.shape[1])[idx0.long() // g]
    k2 = fused_step.fused_local_solve_dma(idx0, packed, up, lamb, group=g,
                                          dtype=BF16, **kw)
    k1 = fused_step.fused_local_solve(gathered.view(b, -1), up, lamb,
                                      dtype=BF16, **kw)
    assert all(torch.equal(a, c) for a, c in zip(k2, k1))


@pytest.mark.cuda
def test_bf16_passes_exact_reciprocal_is_the_ieee_one(cuda_device):
    """The exact divide of the bf16 passes at K <= 64 (the hardware
    reciprocal and a Newton step, psd_mma.cuh `rcp_rn`) gives the bits of
    __frcp_rn for every float in [2^-126, 2^126), where their D + 1e-30
    lies: the parent bodies' bits."""
    assert stats_packed.rcp_rn_mismatches(2.0 ** -126, 2.0 ** 126,
                                          cuda_device) == 0


# --- compute dtype bf16 on the big-N step: K5, K6, K7, K8 -----------------
def _bign_bf16_case(fn, kernel, twin, tol, f32):
    """A bf16 body (kernel(), a call of fn's bf16 body): one bf16 launch,
    bitwise on a re-run, within tol of its bf16 twin, pinned against its
    f32 body (f32())."""
    before = fn.bf16_launches
    got = kernel()
    assert fn.bf16_launches == before + 1
    assert all(torch.equal(a, c) for a, c in zip(got, kernel()))
    for a, c in zip(got, twin()):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **tol)
    _pinned(got, f32())


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("b,n,k", BF16_SHAPES)
def test_bf16_bign_bodies_match_twins(cuda_device, b, n, k, approx_div):
    """K7 (both divides), K6, K5 and K8 (both divides) at bf16 on a ragged
    B and an odd W with rows MISSING: against their bf16 twins, bitwise on
    a re-run, pinned against their f32 bodies; K8 and K5 also bitwise on
    two replays of a CUDA graph and, with R = 3 replicates, each
    replicate bitwise its single call."""
    rows, up, lamb = _problem(cuda_device, b, n, k, seed=k + 1)
    rows[3] = 0xFF
    u = stats_packed.planes_to_flat(up).contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else BF16_PASS

    def twin_stats(approx):
        g, l0, l1 = stats_packed.batch_stats_fused_twin(
            rows, up, t1, t0, approx_div=approx, dtype=BF16)
        return u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1

    v2 = stats_packed.batch_stats_fused_v2_packed
    _bign_bf16_case(
        v2, lambda: v2(rows, u, t1, t0, approx_div=approx_div, dtype=BF16),
        lambda: twin_stats(approx_div), tol,
        lambda: v2(rows, u, t1, t0, approx_div=approx_div))
    a1, a0 = stats_packed.decode_count_planes(rows)
    k8 = stats_packed.lambda_stats_acat
    _bign_bf16_case(
        k8, lambda: k8(a1, a0, up, t1, t0, approx_div=approx_div, dtype=BF16),
        lambda: stats_packed.lambda_stats_acat_twin(
            a1, a0, up, t1, t0, approx_div=approx_div, dtype=BF16),
        tol, lambda: k8(a1, a0, up, t1, t0, approx_div=approx_div))
    kw = dict(approx_div=approx_div, dtype=BF16)
    _replays_bitwise(lambda: k8(a1, a0, up, t1, t0, **kw),
                     k8(a1, a0, up, t1, t0, **kw))
    rs, ups, lambs = _rep_problem(cuda_device, 3, b, n, k, seed=k + 1)
    rs[0, 2::7] = 0xFF
    t1s, t0s = fused_step.exp_elog_beta_kernel(lambs)
    a1s, a0s = stats_packed.decode_count_planes(rs)
    _rep_bitwise(k8(a1s, a0s, ups, t1s, t0s, **kw),
                 [k8(a1s[i], a0s[i], ups[i], t1s[i], t0s[i], **kw)
                  for i in range(3)])
    if approx_div:
        return
    v1 = stats_packed.batch_stats_fused_packed
    _bign_bf16_case(v1, lambda: v1(rows, u, t1, t0, dtype=BF16),
                    lambda: twin_stats(False), BF16_PASS,
                    lambda: v1(rows, u, t1, t0))
    # K6[bf16] runs K7[bf16]'s tensor-core bodies: bitwise K7 (exact)
    assert all(torch.equal(a, b) for a, b in zip(
        v1(rows, u, t1, t0, dtype=BF16), v2(rows, u, t1, t0, dtype=BF16)))
    k5 = stats_packed.gamma_stats_packed
    _bign_bf16_case(
        k5, lambda: [k5(rows, up, t1, t0, BF16)],
        lambda: [stats_packed.gamma_stats_packed_twin(rows, up, t1, t0,
                                                      BF16)],
        BF16_PASS, lambda: [k5(rows, up, t1, t0)])
    _replays_bitwise(lambda: [k5(rows, up, t1, t0, BF16)],
                     [k5(rows, up, t1, t0, BF16)])
    _rep_bitwise([k5(rs, ups, t1s, t0s, BF16)],
                 [[k5(rs[i], ups[i], t1s[i], t0s[i], BF16)]
                  for i in range(3)])


@pytest.mark.cuda
@pytest.mark.parametrize("stats_kernel", ["fused_v2", "pair", "fused"])
def test_bf16_bign_step_runs_the_bf16_bodies(cuda_device, stats_kernel):
    """make_step at bf16 on a big-N shape (the subsample engages; K = 10):
    the bf16 bodies launch and no f32 body of K4-K8 does; the step's core
    on an injected column subsample matches its twins on the CPU (at most
    0.1% of the entries beyond the step tolerance: a bf(t) that rounds the
    other way on an ulp of lambda moves its row by up to 2^-8)."""
    from terastructure_tpu_torch.config import SVIConfig
    from terastructure_tpu_torch.svi import engine

    n, l, k, b = 8192, 4096, 10, 256
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, kernel="pallas",
                    local_sub_n=2048, local_accel=False,
                    stats_kernel=stats_kernel, compute_dtype="bfloat16")
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(pack2bit(rng.integers(0, 4, (l, n)).astype(
        np.int8))).to(cuda_device)
    fns = (stats_packed.lambda_stats_packed, stats_packed.gamma_stats_packed,
           stats_packed.batch_stats_fused_packed,
           stats_packed.batch_stats_fused_v2_packed,
           stats_packed.lambda_stats_acat)
    f32 = [f.launches for f in fns]
    bf16 = [f.bf16_launches for f in fns]
    state = engine.make_step(cfg)(engine.init_state(cfg, device=cuda_device),
                                  packed)
    assert [f.launches for f in fns] == f32
    ran = {f.__name__: f.bf16_launches - c for f, c in zip(fns, bf16)}
    assert ran["lambda_stats_acat"] >= cfg.local_iters
    want = {"fused_v2": "batch_stats_fused_v2_packed",
            "pair": "gamma_stats_packed",
            "fused": "batch_stats_fused_packed"}[stats_kernel]
    assert ran[want] == 1
    assert bool(torch.isfinite(state.gamma).all())

    gamma = state.gamma
    rows = packed[:b]
    idx_w = torch.from_numpy(rng.permutation(n // 4)[:512].copy())
    got = engine.step_core_packed(cfg, gamma, rows, idx_w=idx_w)
    want = engine.step_core_packed(cfg, gamma.cpu(), rows.cpu(),
                                   idx_w=idx_w)
    for a, c in zip(got, want):
        _flips(a, c, BF16_SOLVE, 1e-3)


# --- the tensor-core bodies of K7 and K8 at bf16 (K <= 64) -----------------
MMA_KS = [3, 8, 10, 12, 16, 33, 64]


def _mma_problem(dev, b, k):
    """B rows of an odd W (two of K7's W tiles, the second ragged) with
    three rows MISSING, among them the last."""
    rows, up, lamb = _problem(dev, b, 4 * 301, k, seed=b + k)
    rows[[0, 77, b - 1]] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return rows, up, t1, t0


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("b", [4096, 4092])
@pytest.mark.parametrize("k", MMA_KS)
def test_bf16_k7_tensor_core_body_matches_twin(cuda_device, k, b,
                                               approx_div):
    """K7 at bf16 and K <= 64 (the tensor-core body) against its bf16
    twin at B = 4096 and 4,092, odd W, rows MISSING, both divides;
    bitwise on a re-run, pinned against its f32 body."""
    rows, up, t1, t0 = _mma_problem(cuda_device, b, k)
    u = stats_packed.planes_to_flat(up).contiguous()
    v2 = stats_packed.batch_stats_fused_v2_packed
    g, l0, l1 = stats_packed.batch_stats_fused_twin(
        rows, up, t1, t0, approx_div=approx_div, dtype=BF16)
    want = (u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1)
    _bign_bf16_case(
        v2, lambda: v2(rows, u, t1, t0, approx_div=approx_div, dtype=BF16),
        lambda: want,
        dict(rtol=5e-3, atol=5e-3) if approx_div else BF16_PASS,
        lambda: v2(rows, u, t1, t0, approx_div=approx_div))


@pytest.mark.cuda
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("b", [4096, 4092])
@pytest.mark.parametrize("k", MMA_KS)
def test_bf16_k8_tensor_core_body_matches_twin(cuda_device, k, b,
                                               approx_div):
    """K8 at bf16 and K <= 64 (the tensor-core λ pass over count planes)
    against its bf16 twin at B = 4096 and 4,092, odd W, rows MISSING,
    both divides; bitwise on a re-run, pinned against its f32 body. The
    planes hold counts other than 0, 1, 2 in one row: the body reads any
    bf16 count, as the twin and the reference do."""
    rows, up, t1, t0 = _mma_problem(cuda_device, b, k)
    a1, a0 = stats_packed.decode_count_planes(rows)
    a1[5], a0[9] = 0.375, 3.0
    k8 = stats_packed.lambda_stats_acat
    _bign_bf16_case(
        k8, lambda: k8(a1, a0, up, t1, t0, approx_div=approx_div, dtype=BF16),
        lambda: stats_packed.lambda_stats_acat_twin(
            a1, a0, up, t1, t0, approx_div=approx_div, dtype=BF16),
        dict(rtol=5e-3, atol=5e-3) if approx_div else BF16_PASS,
        lambda: k8(a1, a0, up, t1, t0, approx_div=approx_div))


@pytest.mark.cuda
def test_bf16_k7_and_k8_reach_the_tensor_core_kernels(cuda_device):
    """At bf16 and K <= 64, K7 and K8 launch the tensor-core kernels
    (stats_v2_mma_kernel, lambda_pass_mma_kernel) and no SIMT body; at
    f32 they launch the SIMT ones (kernel names from torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    rows, up, t1, t0 = _mma_problem(cuda_device, 256, 10)
    u = stats_packed.planes_to_flat(up).contiguous()
    a1, a0 = stats_packed.decode_count_planes(rows)

    def kernels(dtype):
        stats_packed.batch_stats_fused_v2_packed(rows, u, t1, t0, dtype=dtype)
        stats_packed.lambda_stats_acat(a1, a0, up, t1, t0, dtype=dtype)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stats_packed.batch_stats_fused_v2_packed(rows, u, t1, t0,
                                                     dtype=dtype)
            stats_packed.lambda_stats_acat(a1, a0, up, t1, t0, dtype=dtype)
            torch.cuda.synchronize()
        return " ".join(e.key for e in prof.key_averages())

    bf16, f32 = kernels(BF16), kernels(torch.float32)
    assert "stats_v2_mma_kernel" in bf16 and "lambda_pass_mma_kernel" in bf16
    assert "stats_v2_kernel" not in bf16 and "lambda_pass_kernel" not in bf16
    assert "stats_v2_kernel" in f32 and "lambda_pass_kernel" in f32
    assert "_mma_kernel" not in f32


# --- K6 (`batch_stats_fused_packed`): K7's launch at the exact divide
# (csrc/stats_fused.cuh) ------------------------------------------------------
K6_BIGN_W = 25_088                     # the big-N shape's byte columns
# B, K: K <= 64 (K = 10, the KM = 12 body), one piece of K > 64 (72) and
# two (130: two of 80; 256: two of 128), a ragged B among them
K6_BIGN = [(4096, 10), (4092, 10), (4096, 72), (4092, 72), (4096, 130),
           (4096, 256)]


def _k6_inputs(dev, r, b, w, k, seed):
    """r replicates' rows (r, B, W), u planes (r, 4, W, K), u (r, 4W, K),
    t1 and t0 (r, B, K), drawn on the card (numpy would take minutes at
    the big-N shape), three rows of each MISSING."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 256, (r, b, w), generator=gen, device=dev,
                         dtype=torch.uint8)
    rows[:, [0, b // 2, b - 1]] = 0xFF
    gamma = 0.3 + 2.7 * torch.rand((r, 4 * w, k), generator=gen, device=dev)
    u = exp_elog_theta(gamma).contiguous()
    up = stats_packed.u_to_planes(u)
    lamb = 0.5 + 2.5 * torch.rand((r, b, k, 2), generator=gen, device=dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return rows, up, u, t1.contiguous(), t0.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("b,k", K6_BIGN)
def test_k6_at_the_big_n_shape(cuda_device, b, k, dtype):
    """K6 at the big-N shape (W = 25,088): one launch, counted on K6,
    held to its twin (TOL; bf16 BF16_PASS), bitwise on a re-run and
    bitwise K7 at the exact divide (K7's launch); at R = 4 each replicate
    bitwise its single call; two replays of one CUDA graph of the call
    bitwise the eager call."""
    rows, up, u, t1, t0 = _k6_inputs(cuda_device, 4, b, K6_BIGN_W, k,
                                     seed=b + k)
    fn = stats_packed.batch_stats_fused_packed
    count = "bf16_launches" if dtype == BF16 else "launches"

    def one(i):
        return fn(rows[i], u[i], t1[i], t0[i], dtype=dtype)

    before = getattr(fn, count)
    got = one(0)
    assert getattr(fn, count) == before + 1
    assert all(torch.equal(a, c) for a, c in zip(got, one(0)))
    k7 = stats_packed.batch_stats_fused_v2_packed(rows[0], u[0], t1[0],
                                                  t0[0], dtype=dtype)
    assert all(torch.equal(a, c) for a, c in zip(got, k7))
    del k7
    g, l0, l1 = stats_packed.batch_stats_fused_twin(rows[0], up[0], t1[0],
                                                    t0[0], dtype=dtype)
    want = (u[0] * stats_packed.planes_to_flat(g), t1[0] * l0, t0[0] * l1)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   **(BF16_PASS if dtype == BF16 else TOL))
    del g, l0, l1, want
    torch.cuda.empty_cache()

    before = fn.rep_launches
    batched = fn(rows, u, t1, t0, dtype=dtype)
    assert fn.rep_launches == before + 1
    for i in range(4):
        single = got if i == 0 else one(i)
        assert all(torch.equal(a[i], c) for a, c in zip(batched, single)), i
    del batched

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = one(0)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(out, got))
    del graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 72])
def test_k6_launches_the_tensor_core_body_at_bf16(cuda_device, k):
    """K6's launch (kernel names from torch.profiler): at bf16 the
    tensor-core body (`stats_v2_mma_kernel` at K <= 64, the bf16
    `stats_v2_wide_kernel` above) and no f32 body, at f32 the SIMT body;
    at both K7's λ and γ reductions."""
    from torch.profiler import ProfilerActivity, profile

    rows, up, u, t1, t0 = (x[0] for x in _k6_inputs(cuda_device, 1, 300,
                                                     700, k, seed=k))

    def kernels(dtype):
        stats_packed.batch_stats_fused_packed(rows, u, t1, t0, dtype=dtype)
        torch.cuda.synchronize()
        for _ in range(3):   # a profile may come back without device records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stats_packed.batch_stats_fused_packed(rows, u, t1, t0,
                                                      dtype=dtype)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()]
            if any("gamma_reduce_kernel" in n for n in names):
                break        # every launch of K6 runs its γ reduction
        return names

    for dtype in (BF16, torch.float32):
        names = kernels(dtype)
        bodies = [n for n in names if "stats_v2" in n]
        assert len(bodies) == 1, names
        if k > 64:
            assert "stats_v2_wide_kernel" in bodies[0]
            assert ("true>" if dtype == BF16 else "false>") in bodies[0], \
                bodies[0]
        else:
            assert ("stats_v2_mma_kernel" if dtype == BF16
                    else "stats_v2_kernel") in bodies[0], bodies[0]
        assert any("gamma_reduce_kernel" in n for n in names)
        assert any("split_reduce_kernel" in n for n in names)


def _stream_setup(dev, n=4096, l=512, g=8, seed=3):
    """A host matrix and a config for the card's streamed step."""
    from terastructure_tpu_torch import SVIConfig

    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(l, n // 4 - 3), dtype=np.uint8)
    cfg = SVIConfig(n=4 * packed.shape[1], l=l, k=5, batch_size=256,
                    seed=seed, snp_group=g, local_sub_n=512)
    return packed, cfg


@pytest.mark.cuda
def test_stream_batches_equal_host_gather_with_prefetch_in_flight(
        cuda_device):
    """Eight batches through the chunk's own pattern (batch t + 1 is
    gathered and copied while batch t is read), so both pinned buffers
    are refilled three times: each device batch equals the numpy gather of
    the reference's draw, read after work on the compute stream that
    follows it."""
    from concurrent.futures import ThreadPoolExecutor

    from terastructure_tpu_torch.svi.stream import BatchStream

    packed, cfg = _stream_setup(cuda_device)
    bs = BatchStream(cfg, packed, cuda_device)
    l, w, g = packed.shape[0], packed.shape[1], bs.g
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(bs.batch, 0)
        for t in range(8):
            rows = bs.ready(fut.result())
            fut = ex.submit(bs.batch, t + 1)
            # work on the compute stream that reads the batch first
            busy = rows.float().sum() + (rows.float() @ rows.float().T).sum()
            got = rows.cpu().numpy()
            starts = np.random.default_rng(
                np.random.SeedSequence((cfg.seed, t))).integers(0, l, 256 // g)
            idx = ((starts[:, None] + np.arange(g)) % l).ravel()
            assert got.shape == (256, bs.wp) and bool(torch.isfinite(busy))
            np.testing.assert_array_equal(got[:, :w], packed[idx])
            assert (got[:, w:] == 0xFF).all()
        fut.result()


@pytest.mark.cuda
def test_stream_chunk_reruns_bitwise_and_runs_the_kernels(cuda_device):
    from terastructure_tpu_torch.ops import stats_packed as pk
    from terastructure_tpu_torch.svi import engine, stream

    packed, cfg = _stream_setup(cuda_device)
    st = engine.init_state(cfg, device=cuda_device)
    chunk = stream.make_stream_chunk(cfg, 6, cfg.l)
    before = (pk.batch_stats_fused_v2_packed.launches,
              pk.lambda_stats_acat.launches,
              pk.batch_stats_fused_v2_packed.twin_calls)
    a = chunk(st, packed)
    b = chunk(st, packed)
    assert a.t == 6 and torch.equal(a.gamma, b.gamma)
    assert bool(torch.isfinite(a.gamma).all())
    assert pk.batch_stats_fused_v2_packed.launches == before[0] + 12
    assert pk.lambda_stats_acat.launches > before[1]
    assert pk.batch_stats_fused_v2_packed.twin_calls == before[2]


@pytest.mark.cuda
def test_stream_worker_exception_propagates(cuda_device, monkeypatch):
    from terastructure_tpu_torch.svi import engine, stream

    packed, cfg = _stream_setup(cuda_device)
    gather = stream.BatchStream.gather

    def failing(self, t, out):
        if t == 4:
            raise OSError("read failed at step 4")
        gather(self, t, out)

    monkeypatch.setattr(stream.BatchStream, "gather", failing)
    st = engine.init_state(cfg, device=cuda_device)
    with pytest.raises(OSError, match="step 4"):
        stream.make_stream_chunk(cfg, 6, cfg.l)(st, packed)


# --- the replicate axis (batched replicates) ---------------------------------
def _rep_problem(dev, r, b, n, k, seed):
    """r replicates' (rows, u planes, lambda), each `_problem` of its own
    seed."""
    parts = [_problem(dev, b, n, k, seed + i) for i in range(r)]
    return tuple(torch.stack(x) for x in zip(*parts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["cold_plain", "warm_plain",
                                  "tol_fires_accel"])
@pytest.mark.parametrize("shape", [(64, 512, 8), (40, 700, 3)])
def test_rep_fused_kernel_is_the_single_kernel_per_replicate(
        cuda_device, case, shape, dtype):
    """K1 with the replicate axis (R = 3): each replicate bitwise the
    single launch on its inputs, counted in rep_launches, and held to the
    twin as the single kernel is (at bf16 the plain schedules only, as
    test_bf16_fused_solves_match_twin: with the accel tail a bf(t) that
    rounds the other way moves g by up to 0.6%, measured on 6% of g's
    entries at shape0, NVIDIA H100 80GB HBM3, 700 W)."""
    rows, up, lamb = _rep_problem(cuda_device, 3, *shape, seed=len(case))
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0, dtype=dtype)
    before = fused_step.fused_local_solve.rep_launches
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    assert fused_step.fused_local_solve.rep_launches == before + 1
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-3, atol=1e-5)
    for i in range(3):
        one = fused_step.fused_local_solve(rows[i], up[i], lamb[i], **kw)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i],
                                                              one[1])
        if dtype == torch.bfloat16 and kw.get("accel"):
            continue
        want = fused_step.fused_local_solve_twin(rows[i], up[i], lamb[i],
                                                 **kw)
        np.testing.assert_allclose(got[1][i].cpu().numpy(),
                                   want[1].cpu().numpy(), **tol)


@pytest.mark.cuda
def test_rep_fused_kernel_exits_per_replicate(cuda_device):
    """Replicate 1's rows all MISSING: its tol loop ends after the first
    pass while the others run on, each bitwise its single solve."""
    rows, up, lamb = _rep_problem(cuda_device, 3, 64, 512, 8, seed=5)
    rows[1] = 0xFF
    kw = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
              beta_b=1.0)
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    for i in range(3):
        one = fused_step.fused_local_solve(rows[i], up[i], lamb[i], **kw)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i],
                                                              one[1])
    assert float(got[1][1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rep_of_one_is_the_single_kernel(cuda_device, dtype):
    """A leading replicate axis of one gives the single call's bits (both
    launch the same entry, R = 1)."""
    rows, up, lamb = _problem(cuda_device, 40, 700, 3, seed=2)
    kw = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
              beta_b=1.0, dtype=dtype)
    got = fused_step.fused_local_solve(rows[None], up[None], lamb[None],
                                       **kw)
    one = fused_step.fused_local_solve(rows, up, lamb, **kw)
    assert torch.equal(got[0][0], one[0]) and torch.equal(got[1][0], one[1])
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    got = stats_packed.lambda_stats_packed(rows, up[None], t1[None],
                                           t0[None], dtype=dtype)
    one = stats_packed.lambda_stats_packed(rows, up, t1, t0, dtype=dtype)
    assert torch.equal(got[0][0], one[0]) and torch.equal(got[1][0], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("approx_div", [False, True])
def test_rep_lambda_stats_is_the_single_pass_per_replicate(
        cuda_device, dtype, shared, approx_div):
    """K4 with the replicate axis (R = 3), over rows every replicate
    shares or rows of their own: each replicate bitwise the single pass,
    and held to the twin."""
    rows, up, lamb = _rep_problem(cuda_device, 3, 72, 640, 8, seed=9)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    rr = rows[0] if shared else rows
    before = stats_packed.lambda_stats_packed.rep_launches
    got = stats_packed.lambda_stats_packed(rr, up, t1, t0,
                                           approx_div=approx_div, dtype=dtype)
    assert stats_packed.lambda_stats_packed.rep_launches == before + 1
    tol = (dict(rtol=5e-3, atol=5e-3) if approx_div else
           TOL if dtype == torch.float32 else dict(rtol=1e-3, atol=1e-6))
    for i in range(3):
        ri = rr if shared else rr[i]
        one = stats_packed.lambda_stats_packed(ri, up[i], t1[i], t0[i],
                                               approx_div=approx_div,
                                               dtype=dtype)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i],
                                                              one[1])
        want = stats_packed.lambda_stats_packed_twin(
            ri, up[i], t1[i], t0[i], approx_div=approx_div, dtype=dtype)
        for g, w in zip((got[0][i], got[1][i]), want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       **tol)


@pytest.mark.cuda
def test_rep_kernels_refuse_k_above_64(cuda_device):
    """K > 64 with the replicate axis, which raised before the K-chunked
    bodies took it (the name is kept from then): K1, K4, K5, K6, K7 and
    K8 at K = 72, 128 and 130 (3, 4 and 5 chunks; K7 one piece of 80, one
    of 128, two of 80; ragged B and W), R = 3, f32 and
    bf16, one launch each, counted in rep_launches, each replicate
    bitwise its single wide call, a re-run bitwise; K1 on the plain and
    the tol-gated accel schedules, held to its twin at f32: on the plain
    one at TOL, on the accel one with at most ACCEL_FRAC of g and of
    lambda beyond TOL and every entry of g within rtol ACCEL_G_CAP (after
    the accel tail's clamped Aitken step the twin differs on a few entries
    of g: measured 8 of 50,400 beyond TOL at K = 72 on NVIDIA H100 80GB
    HBM3, 700 W; the single call as much)."""
    for k in (72, 128, 130):
        rows, up, lamb = _rep_problem(cuda_device, 3, 40, 700, k, seed=k)
        rows[1, :20] = 0xFF
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("cold_plain", "tol_fires_accel"):
                kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0,
                          dtype=dtype)
                before = fused_step.fused_local_solve.rep_launches
                got = fused_step.fused_local_solve(rows, up, lamb, **kw)
                assert fused_step.fused_local_solve.rep_launches == before + 1
                for i in range(3):
                    one = fused_step.fused_local_solve(rows[i], up[i],
                                                       lamb[i], **kw)
                    assert all(torch.equal(g[i], o)
                               for g, o in zip(got, one))
                    if dtype != torch.float32:
                        continue
                    want = fused_step.fused_local_solve_twin(
                        rows[i], up[i], lamb[i], **kw)
                    pairs = [(g.cpu().numpy(), w.cpu().numpy())
                             for g, w in zip((got[0][i], got[1][i]), want)]
                    if case == "cold_plain":
                        for g, w in pairs:
                            np.testing.assert_allclose(g, w, **TOL)
                        continue
                    for g, w in pairs:
                        bad = np.abs(g - w) > TOL["atol"] + TOL["rtol"] * \
                            np.abs(w)
                        assert bad.mean() <= ACCEL_FRAC, (k, i, bad.mean())
                    np.testing.assert_allclose(*pairs[1], rtol=ACCEL_G_CAP,
                                               atol=TOL["atol"])
            calls = dict(_rep_bign_calls(rows, up, t1, t0, False, dtype),
                         K4=(stats_packed.lambda_stats_packed,
                             lambda: stats_packed.lambda_stats_packed(
                                 rows[0], up, t1, t0, dtype=dtype)))
            for name, (fn, call) in calls.items():
                before = fn.rep_launches
                got = call()
                assert fn.rep_launches == before + 1, name
                assert all(torch.equal(g, a) for g, a in zip(got, call()))
                for i in range(3):
                    one = (stats_packed.lambda_stats_packed(
                        rows[0], up[i], t1[i], t0[i], dtype=dtype)
                        if name == "K4" else _rep_bign_calls(
                            rows[i], up[i], t1[i], t0[i], False,
                            dtype)[name][1]())
                    assert all(torch.equal(g[i], o)
                               for g, o in zip(got, one)), (name, k, i)


def _rep_bign_calls(rows, up, t1, t0, approx_div, dtype):
    """K8, K5, K6 and K7 on (rows, u planes, t1, t0), single or batched
    (a leading R on each): name -> (wrapper, call)."""
    u = stats_packed.planes_to_flat(up).contiguous()
    a1, a0 = stats_packed.decode_count_planes(rows)
    return {
        "K8": (stats_packed.lambda_stats_acat,
               lambda: stats_packed.lambda_stats_acat(
                   a1, a0, up, t1, t0, approx_div=approx_div, dtype=dtype)),
        "K5": (stats_packed.gamma_stats_packed,
               lambda: [stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                        dtype)]),
        "K6": (stats_packed.batch_stats_fused_packed,
               lambda: stats_packed.batch_stats_fused_packed(
                   rows, u, t1, t0, dtype=dtype)),
        "K7": (stats_packed.batch_stats_fused_v2_packed,
               lambda: stats_packed.batch_stats_fused_v2_packed(
                   rows, u, t1, t0, approx_div=approx_div, dtype=dtype)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("shape", [(300, 700, 10), (12, 384, 3),
                                   (128, 512, 16)])
@pytest.mark.parametrize("kernel", ["K8", "K5", "K6", "K7"])
def test_rep_bign_kernels_are_the_single_calls_per_replicate(
        cuda_device, kernel, shape, approx_div, dtype):
    """K8, K5, K6 and K7 with the replicate axis (R = 3, inputs of each
    replicate's own, one replicate's rows all MISSING): one launch,
    counted in rep_launches; each replicate bitwise the single call on
    its inputs and held to its twin as the single kernel is; a re-run
    bitwise. (K5 and K6 have no fast divide: approx_div=True runs them
    as False.)"""
    rows, up, lamb = _rep_problem(cuda_device, 3, *shape, seed=len(kernel))
    rows[1, : shape[0] // 2] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    approx = approx_div and kernel in ("K7", "K8")
    fn, call = _rep_bign_calls(rows, up, t1, t0, approx, dtype)[kernel]
    before = fn.rep_launches
    got = call()
    assert fn.rep_launches == before + 1
    assert all(torch.equal(g, a) for g, a in zip(got, call()))
    tol = (dict(rtol=5e-3, atol=5e-3) if approx else
           TOL if dtype == torch.float32 else dict(rtol=1e-3, atol=1e-6))
    for i in range(3):
        _, one = _rep_bign_calls(rows[i], up[i], t1[i], t0[i], approx,
                                 dtype)[kernel]
        one = one()
        assert all(torch.equal(g[i], o) for g, o in zip(got, one)), i
        if kernel in ("K5", "K8"):
            twin = (stats_packed.gamma_stats_packed_twin(
                rows[i], up[i], t1[i], t0[i], dtype),) if kernel == "K5" \
                else stats_packed.lambda_stats_acat_twin(
                    *stats_packed.decode_count_planes(rows[i]), up[i], t1[i],
                    t0[i], approx_div=approx, dtype=dtype)
        else:
            g, l0, l1 = stats_packed.batch_stats_fused_twin(
                rows[i], up[i], t1[i], t0[i], approx_div=approx, dtype=dtype)
            u = stats_packed.planes_to_flat(up[i])
            twin = (u * stats_packed.planes_to_flat(g), t1[i] * l0,
                    t0[i] * l1)
        for g, w in zip(one, twin):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rep_of_one_is_the_single_bign_kernel(cuda_device, dtype):
    """A leading replicate axis of one gives the single call's bits for
    K8, K5, K6 and K7 (both launch the same entry, R = 1)."""
    rows, up, lamb = _problem(cuda_device, 40, 700, 10, seed=3)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    batched = _rep_bign_calls(rows[None], up[None], t1[None], t0[None],
                              False, dtype)
    for name, (_, one) in _rep_bign_calls(rows, up, t1, t0, False,
                                          dtype).items():
        got = batched[name][1]()
        assert all(torch.equal(g[0], o) for g, o in zip(got, one())), name


@pytest.mark.cuda
def test_rep_bign_step_is_the_single_steps(cuda_device):
    """The batched big-N step (engine.step_core_packed on stacked inputs,
    each replicate's own subsample): K8, K7 and no twin, each replicate
    bitwise its single step, at f32 and bf16."""
    from terastructure_tpu_torch import SVIConfig
    from terastructure_tpu_torch.svi import engine

    n, k, b = 4096, 10, 64
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(np.stack([pack2bit(rng.integers(
        0, 4, (b, n)).astype(np.int8)) for _ in range(2)])).to(cuda_device)
    gamma = torch.from_numpy(rng.uniform(0.05, 30.0, (2, n, k)).astype(
        np.float32)).to(cuda_device)
    idx_w = torch.stack([torch.randperm(1024)[:128] for _ in range(2)])
    for dtype in ("float32", "bfloat16"):
        cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                        compute_dtype=dtype)
        fns = (stats_packed.lambda_stats_acat,
               stats_packed.batch_stats_fused_v2_packed)
        before = [f.rep_launches for f in fns]
        twins = [f.twin_calls for f in fns]
        got = engine.step_core_packed(cfg, gamma, rows, idx_w=idx_w)
        assert [f.rep_launches - c for f, c in zip(fns, before)] == [
            cfg.local_iters, 1]
        assert [f.twin_calls for f in fns] == twins
        for i in range(2):
            one = engine.step_core_packed(cfg, gamma[i], rows[i],
                                          idx_w=idx_w[i])
            assert all(torch.equal(g[i], o) for g, o in zip(got, one))


# --------------------------------------------------------------------------
# the MCMC validators (mcmc/): no kernel of their own, but the potential
# must stay float32 on the card and the samplers must be right there


def _tf32(x):
    """x rounded to TF32's 10-bit mantissa (a TF32 product's operands);
    straight through for the gradient."""
    i = x.detach().contiguous().view(torch.int32)
    return x + (((i + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()


@pytest.mark.cuda
def test_mcmc_potential_is_float32_with_tf32_allowed(cuda_device):
    """PSDPotential's value and gradient on the card at config #4's
    shape (2 chains, float64 sums) while TF32 is allowed for matmuls,
    against float64 on the CPU: within 0.05 nats and 2e-5 of the largest
    gradient, limits that TF32-rounded operands miss."""
    from terastructure_tpu_torch.data.simulate import simulate_psd
    from terastructure_tpu_torch.mcmc import PSDPotential, hmc
    from terastructure_tpu_torch.mcmc.potential import f32_product

    n, l, k = 500, 5000, 3
    _, _, x = simulate_psd(n, l, k, seed=4)
    rng = np.random.default_rng(4)
    host = {"z_theta": torch.from_numpy((0.5 * rng.standard_normal(
                (2, n, k))).astype(np.float32)),
            "z_beta": torch.from_numpy((0.8 * rng.standard_normal(
                (2, l, k))).astype(np.float32))}
    kw = dict(alpha=1 / k, scale_sigma=0.05, acc_dtype=torch.float64)
    pot = PSDPotential(x=torch.from_numpy(x).to(cuda_device), **kw)
    tmpl = {name: v[0].to(cuda_device) for name, v in host.items()}
    target = hmc.Target(pot, tmpl)
    q = target.flat({name: v.to(cuda_device) for name, v in host.items()})
    rounded = hmc.Target(hmc.batched(lambda d: pot.plain(
        d, product=lambda t, b: f32_product(_tf32(t), _tf32(b)))), tmpl)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lp, g = target.value_and_grad(q)
        lp_t, g_t = rounded.value_and_grad(q)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    lp64, g64 = hmc.Target(
        PSDPotential(x=torch.from_numpy(x), **kw),
        {name: v[0].double() for name, v in host.items()}
    ).value_and_grad(q.cpu().double())
    gmax = float(g64.abs().max())
    assert float((lp.cpu() - lp64).abs().max()) < 0.05
    assert float((g.cpu().double() - g64).abs().max()) < 2e-5 * gmax
    assert float((lp_t.cpu() - lp64).abs().max()) > 0.05
    assert float((g_t.cpu().double() - g64).abs().max()) > 2e-5 * gmax


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_mcmc_samplers_match_the_conjugate_posterior(cuda_device, sampler):
    """HMC and NUTS on the card on the reference's K = 1 problem
    (tests/test_mcmc.py:18-31): posterior means within 0.03 of the exact
    Beta posterior; a NUTS re-run with the same seed is bitwise equal."""
    from terastructure_tpu_torch.mcmc import PSDPotential, run_hmc, run_nuts
    from terastructure_tpu_torch.mcmc.potential import init_params

    rng = np.random.default_rng(0)
    beta_true = rng.uniform(0.2, 0.8, size=6)
    x = rng.binomial(2, np.broadcast_to(beta_true, (40, 6))).astype(np.int8)
    a, b = 1.0 + x.sum(0), 1.0 + (2 - x).sum(0)
    pot = PSDPotential(x=torch.from_numpy(x).to(cuda_device), alpha=1.0)
    if sampler == "hmc":
        run = lambda: run_hmc(2, pot, init_params(pot, 1, k=1),
                              n_samples=800, n_warmup=300, n_leapfrog=16)
    else:
        run = lambda: run_nuts(4, pot, init_params(pot, 3, k=1),
                               n_samples=500, n_warmup=300, max_depth=6)
    samples, _ = run()
    beta = 1.0 / (1.0 + np.exp(-samples["z_beta"][:, :, 0]))
    np.testing.assert_allclose(beta.mean(0), a / (a + b), atol=0.03)
    if sampler == "nuts":
        again, _ = run()
        assert np.array_equal(samples["z_beta"], again["z_beta"])


def _mcmc_transitions(dev, seed=11):
    """One HMC transition (12 leapfrog steps) and one NUTS transition
    (max depth 6) for 2 chains at 200 x 1,000, K = 3, then a short ChEES
    run (4 chains) on the reference's K = 1 conjugate problem, every draw
    from seeded generators on `dev`: their outputs on the host, and
    NUTS's depth."""
    from terastructure_tpu_torch.data.simulate import simulate_psd
    from terastructure_tpu_torch.mcmc import PSDPotential, hmc, nuts
    from terastructure_tpu_torch.mcmc.chees import run_chees
    from terastructure_tpu_torch.mcmc.potential import init_params

    _, _, x = simulate_psd(200, 1000, 3, seed=5)
    pot = PSDPotential(x=torch.from_numpy(x).to(dev), alpha=1 / 3,
                       scale_sigma=0.05, acc_dtype=torch.float64)
    params = init_params(pot, 12, k=3, n_chains=2)
    target = hmc.Target(pot, {k: v[0] for k, v in params.items()})
    q = target.flat(params)
    inv_mass = torch.ones_like(q)
    draws = hmc.TorchDraws(torch.Generator(device=dev).manual_seed(seed))
    lp, g = target.value_and_grad(q)
    out = list(hmc.hmc_kernel(target, 12)(draws, q, lp, g, 2e-3, inv_mass))
    new, info = nuts.nuts_kernel(target, max_depth=6)(draws, q, 1e-3,
                                                     inv_mass)
    out += [new] + [info[k] for k in sorted(info)]
    rng = np.random.default_rng(0)
    x1 = rng.binomial(2, np.broadcast_to(rng.uniform(0.2, 0.8, 6), (40, 6)))
    pot1 = PSDPotential(x=torch.from_numpy(x1.astype(np.int8)).to(dev),
                        alpha=1.0)
    samples, _ = run_chees(seed, pot1, init_params(pot1, 13, k=1,
                                                   n_chains=4),
                           n_samples=10, n_warmup=20, n_chains=4)
    return ([t.cpu() for t in out]
            + [torch.from_numpy(samples[k]) for k in sorted(samples)],
            int(info["depth"].min()))


@pytest.mark.cuda
def test_mcmc_graph_steps_equal_the_uncaptured_steps(cuda_device,
                                                     monkeypatch):
    """The leapfrog steps as captured CUDA graphs (hmc.StepGraph) and as
    plain calls of the same step on the card give the same bits: one HMC
    transition, one NUTS transition of depth >= 3 (its masked checkpoint
    slots and device leaf table) and a short ChEES run (per-chain step
    counts), on the same seeded draws."""
    from terastructure_tpu_torch.mcmc import hmc

    graph, depth = _mcmc_transitions(cuda_device)
    monkeypatch.setattr(hmc.StepGraph, "__call__", lambda self: self.fn())
    plain, _ = _mcmc_transitions(cuda_device)
    assert depth >= 3
    for a, b in zip(graph, plain, strict=True):
        assert torch.equal(a, b)
