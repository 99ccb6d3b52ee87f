"""The group-DMA fused solve (K2, ops/fused_step.fused_local_solve_dma)
and the engine branch that takes it, against the reference's
fused_local_solve_dma in interpret mode (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.ops.stats_dense import exp_elog_theta
from terastructure_tpu_torch.svi import engine

TOL = dict(rtol=2e-4, atol=2e-4)    # f32, the two packages' sum orders


def _problem(b=32, n=512, l=128, k=3, g=8, seed=4):
    """Packed (L, W), gamma (N, K), group starts idx0 (B/g,), and lambda
    rows for a warm start, from one numpy seed (tests/test_fused.py)."""
    rng = np.random.default_rng(seed)
    packed = pack2bit(rng.integers(0, 4, size=(l, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    idx0 = (rng.integers(0, l // g, size=b // g) * g).astype(np.int32)
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    return packed, gamma, idx0, lamb


def _outliers(got, want, frac):
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert bad.mean() <= frac, bad.mean()


@pytest.mark.parametrize("case", ["plain", "accel", "warm_start"])
def test_twin_matches_reference_interpret(case):
    packed, gamma, idx0, lamb = _problem()
    g = 8
    extra = {"plain": dict(local_iters=5, local_tol=-1.0),
             "accel": dict(local_iters=7, local_tol=1e-4, accel=True),
             "warm_start": dict(local_iters=4, local_tol=-1.0,
                                warm_start=True)}[case]
    kw = dict(beta_a=1.0, beta_b=1.0, **extra)
    u = ref_ops.exp_elog_theta(jnp.asarray(gamma))
    want = ref_fused.fused_local_solve_dma(
        jnp.asarray(idx0), jnp.asarray(packed), ref_pk.u_to_planes(u),
        jnp.asarray(lamb), group=g, dtype=jnp.float32, interpret=True, **kw)
    before = fused_step.fused_local_solve_dma.twin_calls
    got = fused_step.fused_local_solve_dma(
        torch.from_numpy(idx0), torch.from_numpy(packed),
        stats_packed.u_to_planes(exp_elog_theta(torch.from_numpy(gamma))),
        torch.from_numpy(lamb), group=g, **kw)
    assert fused_step.fused_local_solve_dma.twin_calls == before + 1
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    if case == "accel":
        # The clamped Aitken step flips with the sign of d0 - d1, so f32
        # sum-order differences move a few lambda coordinates: 1% may
        # exceed the tolerance (PERF.md, the accel tail); g holds it.
        _outliers(got[0].numpy(), np.asarray(want[0]), 1e-2)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("g", [8, 16])
def test_twin_equals_k1_twin_on_gathered_rows(g):
    packed, gamma, idx0, lamb = _problem(g=g, seed=g)
    packed_t = torch.from_numpy(packed)
    up = stats_packed.u_to_planes(exp_elog_theta(torch.from_numpy(gamma)))
    idx = (torch.from_numpy(idx0).long()[:, None] + torch.arange(g)).reshape(-1)
    kw = dict(local_iters=7, local_tol=1e-4, beta_a=1.0, beta_b=1.0,
              accel=True, warm_start=True)
    got = fused_step.fused_local_solve_dma(
        torch.from_numpy(idx0), packed_t, up, torch.from_numpy(lamb),
        group=g, **kw)
    want = fused_step.fused_local_solve_twin(packed_t[idx], up,
                                             torch.from_numpy(lamb), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["group4", "unaligned", "range", "dtype",
                                 "lamb"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    packed, gamma, idx0, lamb = _problem()
    g = 4 if bad == "group4" else 8
    idx = torch.from_numpy(idx0)
    if bad == "unaligned":
        idx[0] += 1
    if bad == "range":
        idx[-1] = packed.shape[0]
    if bad == "dtype":
        idx = idx.long()
    lamb_t = torch.from_numpy(lamb)
    if bad == "lamb":
        lamb_t = lamb_t[:-1]
    if bad == "group4":
        lamb_t = torch.from_numpy(np.concatenate([lamb] * 2)[:16])
    up = stats_packed.u_to_planes(exp_elog_theta(torch.from_numpy(gamma)))
    with pytest.raises((ValueError, TypeError)):
        fused_step.fused_local_solve_dma(
            idx, torch.from_numpy(packed), up, lamb_t, group=g,
            local_iters=3, local_tol=-1.0, beta_a=1.0, beta_b=1.0)


L_BIG = 65552      # > 65536 and a multiple of 16

@pytest.mark.parametrize("change,dma", [
    (dict(), True),
    (dict(snp_group=16), True),
    (dict(l=65536), False),                 # L at or below 65536
    (dict(snp_group=4), False),             # group below 8
    (dict(snp_group=12), False),            # group not a multiple of 8
    (dict(batch_size=24, snp_group=16), False),   # B % g != 0
    (dict(l=L_BIG + 4), False),             # L % g != 0
])
def test_engine_gate_takes_k2_as_the_reference(change, dma):
    cfg = SVIConfig(n=512, l=L_BIG, k=3, batch_size=16, snp_group=8,
                    seed=2).replace(**change)
    packed = torch.randint(0, 256, (cfg.l, 128), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    fns = (fused_step.fused_local_solve_dma, fused_step.fused_local_solve,
           gather.gather_row_blocks)
    before = [f.twin_calls for f in fns]
    state0 = engine.init_state(cfg)
    state = engine.make_step(cfg)(state0, packed)
    after = [f.twin_calls for f in fns]
    assert engine.uses_group_dma(cfg, cfg.l) == dma
    assert after[0] - before[0] == int(dma)
    assert after[1] - before[1] == int(not dma)
    assert after[2] == before[2]                  # B=16: no block gather
    assert state.t == 1 and bool(torch.isfinite(state.gamma).all())
    if not dma:
        return
    # The rows the step read: the step generator's B/g group starts,
    # g-aligned, each covering g consecutive SNPs.
    g = cfg.snp_group
    idx0, idx = engine._draw_groups(
        cfg, engine.step_generator(cfg.seed, 0, "cpu"), cfg.l, "cpu")
    assert idx0.dtype == torch.int32 and idx0.shape == (cfg.batch_size // g,)
    assert bool((idx0 % g == 0).all()) and int(idx0.max()) <= cfg.l - g
    assert torch.equal(idx.reshape(-1, g) - idx0[:, None],
                       torch.arange(g, dtype=torch.int32).expand(len(idx0), g))
    _, stat = engine.step_core_fused(cfg, state0.gamma, packed[idx.long()])
    want = engine._global_update(cfg, state0.gamma, stat, 0, cfg.l)
    np.testing.assert_allclose(state.gamma.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("accel,t", [(False, 0), (True, 11)])
def test_step_matches_reference_dma_branch(accel, t):
    """One local-mode step through the fused-DMA branch, assembled by hand
    on the reference's side (svi/engine.py:347-367, 380, 409) with the
    same injected idx0."""
    n, l, k, b, g = 512, 256, 3, 32, 8
    packed, _, idx0, _ = _problem(b, n, l, k, g, seed=20 + t)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, snp_group=g, seed=3,
                    local_accel=accel, local_iters=7 if accel else 6)
    s0 = ref_engine.init_state(cfg)._replace(t=jnp.int32(t))
    u = ref_ops.exp_elog_theta(s0.gamma)
    _, gp = ref_fused.fused_local_solve_dma(
        jnp.asarray(idx0), jnp.asarray(packed), ref_pk.u_to_planes(u),
        jnp.zeros((b, k, 2), jnp.float32), group=g,
        local_iters=cfg.local_iters, local_tol=cfg.local_tol, beta_a=1.0,
        beta_b=1.0, dtype=jnp.float32, interpret=True, accel=accel)
    stat = (u * ref_pk.planes_to_flat(gp))[:n]
    want = ref_engine._global_update(cfg, s0.gamma, stat, s0.t, l)

    st = engine.state_from_reference(s0.gamma, s0.lamb, s0.t, cfg.seed)
    _, got_stat = engine.step_core_fused_dma(
        cfg, st.gamma, torch.from_numpy(packed), torch.from_numpy(idx0))
    got = engine._global_update(cfg, st.gamma, got_stat, st.t, l)
    np.testing.assert_allclose(got_stat.numpy(), np.asarray(stat), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
