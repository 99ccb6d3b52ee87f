"""MCMC chains and SMC particles over ranks (terastructure_tpu_torch/mcmc/
chains.py), on the CPU.

The port's ranks are spawned processes over gloo (parallel/ranks.py's
RankPool, running tests/_torch_chain_cases.py; no JAX in them). The
reference's tests/test_sharded_chains.py, ported: the sharded NUTS and
SMC runs against the one-rank runs by moments at its limits and bitwise
against themselves; the one-rank port against the reference's unsharded
run_nuts and run_smc at the same limits. Beyond it: the first NUTS
transitions on the same draws, the generator calls equal on every rank
(lockstep), ranks without chains, ChEES's pooled adaptation, HMC, and
`cli validate --distributed` over two processes against one. On the CPU
every sharded run here is bitwise the one-rank run (each chain's
log-density and draws do not depend on how many chains a rank holds).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_chain_cases as cases
from terastructure_tpu.mcmc import run_nuts as ref_run_nuts
from terastructure_tpu.mcmc import run_smc as ref_run_smc
from terastructure_tpu.mcmc.chains import chain_mesh
from terastructure_tpu_torch.mcmc import chains, run_nuts, run_smc
from terastructure_tpu_torch.parallel.ranks import RankPool

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, tmp_path_factory.mktemp(
                f"chains{world}"), device="cpu", timeout=240, threads=1)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


@pytest.mark.parametrize("n,world,want", [
    (4, 8, 4), (6, 8, 6), (6, 4, 3), (1, 8, None), (7, 4, None),
    (12, 8, 6), (16, 4, 4)])
def test_chain_grid_is_the_references_mesh(n, world, want):
    assert chains.chain_grid(n, world) == want
    mesh = chain_mesh(n, jax.devices()[:world])
    assert (None if mesh is None else mesh.devices.size) == want


def test_split_without_a_group_is_the_identity():
    sp = chains.split(4)
    tree = {"z": torch.zeros(4, 3)}
    assert not sp.sharded and sp.holds and sp.local(tree) is tree
    src = object()
    assert sp.draws(src) is src
    x = torch.arange(4.0)
    assert sp.gather(x) is x and sp.sum_int(3) == 3 and sp.max_int(5) == 5
    assert sp.any(torch.tensor([False, True])) is True


def _moments_close(a, b, mean=0.05, std=0.1):
    assert abs(a.mean() - b.mean()) < mean, (a.mean(), b.mean())
    assert abs(a.std() - b.std()) < std, (a.std(), b.std())


@pytest.mark.parametrize("world,n_samples,n_warmup", [(2, 60, 30),
                                                     (4, 30, 15)])
def test_sharded_nuts_matches_one_rank(pools, world, n_samples, n_warmup):
    """tests/test_sharded_chains.py:35: NUTS on the 8-dim Gaussian, 4
    chains (fewer samples: 60 + 30 on 2 ranks, 30 + 15 on 4, one chain a
    rank; its sizes in test_one_rank_port_against_the_reference): the sharded
    run's moments within 0.05 (mean) and 0.1 (std) of the one-rank run's,
    the same samples on every rank, bitwise a re-run (2 ranks); the
    global diagnostics (leapfrog counts, accept and divergence rates,
    every chain's eps) the one rank's. On the CPU the samples are
    bitwise the one-rank run's too."""
    pool = pools(world)
    one = pool.run(cases.nuts, 4, False, n_samples, n_warmup)[0]
    sh = pool.run(cases.nuts, 4, True, n_samples, n_warmup)
    again = pool.run(cases.nuts, 4, True, n_samples, n_warmup) \
        if world == 2 else []
    assert sh[0]["d"] == world
    x = sh[0]["x"]
    assert x.shape == one["x"].shape == (4, n_samples, 8)
    _moments_close(one["x"], x)
    for o in sh[1:] + again:
        np.testing.assert_array_equal(o["x"], x)
    for key in ("leapfrog_warmup", "leapfrog_sample", "accept_rate",
                "divergence_rate"):
        assert sh[0]["diag"][key] == one["diag"][key], key
    np.testing.assert_array_equal(sh[0]["diag"]["eps"], one["diag"]["eps"])
    np.testing.assert_array_equal(x, one["x"])


def test_cpu_sharded_runs_are_bitwise_the_one_rank_runs(pools):
    """The finding on the CPU twins at the Gaussian target: each chain's
    log-density is its own whatever the rows beside it, so the sharded
    SMC and HMC runs over 4 ranks are bitwise the one-rank runs (NUTS:
    test_sharded_nuts_matches_one_rank)."""
    pool = pools(4)
    rows = pool.run(cases.target_rows, 4)
    for o in rows:
        assert torch.equal(o["local"], o["whole"][o["lo"]:o["hi"]])
    for case in (cases.smc, cases.hmc):
        one = pool.run(case, shard=False)[0]
        sh = pool.run(case, shard=True)[0]
        np.testing.assert_array_equal(sh["x"], one["x"])


def test_sharded_smc_matches_one_rank(pools):
    """tests/test_sharded_chains.py:56: SMC on the conjugate pair, 64
    particles: the mean within 0.15 of the posterior's 0.5 and within 0.2
    of the one-rank run, bitwise a re-run, the same on every rank."""
    pool = pools(4)
    one = pool.run(cases.smc, False)[0]
    sh = pool.run(cases.smc, True)
    again = pool.run(cases.smc, True)
    x = sh[0]["x"]
    assert x.shape == (64, 4)
    assert abs(x.mean() - 0.5) < 0.15, x.mean()
    assert abs(one["x"].mean() - x.mean()) < 0.2
    for o in sh[1:] + again:
        np.testing.assert_array_equal(o["x"], x)
    for key in ("temps", "acceptance", "eps", "n_stages", "log_evidence"):
        assert sh[0]["diag"][key] == one["diag"][key], key


def test_one_rank_port_against_the_reference():
    """The port on one rank (no process group) against the reference's
    unsharded run_nuts and run_smc on the same inputs, at
    tests/test_sharded_chains.py's limits (threefry and torch's generators
    differ: moments only)."""
    init = cases.gauss_init(4)
    kw = dict(n_samples=200, n_warmup=100, n_chains=4)
    s_ref, _ = ref_run_nuts(jax.random.PRNGKey(0),
                            lambda p: -0.5 * jnp.sum(p["x"] ** 2),
                            {"x": jnp.asarray(init)}, shard_chains=False,
                            **kw)
    s, _ = run_nuts(0, cases.gauss_logp, {"x": torch.from_numpy(init)}, **kw)
    _moments_close(np.asarray(s_ref["x"]), s["x"])

    p0 = np.random.default_rng(3).standard_normal((64, 4)).astype(np.float32)
    kw = dict(n_particles=64, n_mutations=1, n_leapfrog=4,
              mutation_eps=0.3, max_stages=20)
    p_ref, _ = ref_run_smc(
        jax.random.PRNGKey(2), lambda p: -0.5 * jnp.sum(p["x"] ** 2),
        lambda p: -0.5 * jnp.sum((p["x"] - 1.0) ** 2), {"x": jnp.asarray(p0)},
        shard_particles=False, **kw)
    p, _ = run_smc(2, cases.smc_log_prior, cases.smc_log_lik,
                   {"x": torch.from_numpy(p0)}, **kw)
    assert abs(p["x"].mean() - 0.5) < 0.15
    assert abs(np.asarray(p_ref["x"]).mean() - p["x"].mean()) < 0.2


def test_first_nuts_transitions_on_the_same_draws(pools):
    """Ten NUTS transitions at a fixed step size: every chain's position
    after each within 1e-6 of the one-rank run's, on 2 and 4 ranks."""
    for world in (2, 4):
        pool = pools(world)
        one = pool.run(cases.nuts_transitions, 4, False)[0]
        for o in pool.run(cases.nuts_transitions, 4, True):
            assert o["q"].shape == (10, 4, 8)
            np.testing.assert_allclose(o["q"], one["q"], rtol=0, atol=1e-6)


def test_every_rank_asks_the_generator_equally_often(pools):
    """Lockstep: every rank holding chains makes the one-rank run's
    generator calls (the loops end on the global OR); 6 chains on 4 ranks
    leave rank 3 without chains: it makes none and returns the same
    samples as the others, the one-rank run's."""
    pool = pools(4)
    one = pool.run(cases.nuts, 6, False, 10, 10)[0]
    sh = pool.run(cases.nuts, 6, True, 10, 10)
    assert [(o["d"], o["lo"], o["hi"]) for o in sh] == [
        (3, 0, 2), (3, 2, 4), (3, 4, 6), (3, 6, 6)]
    assert [o["diag"]["draws"] for o in sh] == [one["diag"]["draws"]] * 3 \
        + [0]
    for o in sh:
        assert o["x"].shape == (6, 10, 8)
        np.testing.assert_array_equal(o["x"], one["x"])
    tr = pool.run(cases.nuts_transitions, 4, True)
    assert len({o["draws"] for o in tr}) == 1
    for case in (cases.smc, cases.chees, cases.hmc):
        counts = [o["diag"]["draws"] for o in pool.run(case, True)]
        assert len(set(counts)) == 1 and counts[0] > 0, (case, counts)


def test_chees_pooled_adaptation_is_the_one_ranks(pools):
    """ChEES adapts eps, the trajectory length and the mass from every
    chain's statistics: after warmup on 2 and 4 ranks they equal the
    one-rank run's, and so do the samples."""
    for world in (2, 4):
        pool = pools(world)
        one = pool.run(cases.chees, False)[0]
        for o in pool.run(cases.chees, True):
            assert o["diag"]["eps"] == one["diag"]["eps"]
            assert (o["diag"]["trajectory_length"]
                    == one["diag"]["trajectory_length"])
            np.testing.assert_array_equal(o["x"], one["x"])


def test_sharded_hmc_returns_the_one_rank_shapes(pools):
    pool = pools(2)
    one = pool.run(cases.hmc, False)[0]
    sh = pool.run(cases.hmc, True)
    for o in sh:
        assert o["x"].shape == one["x"].shape == (4, 100, 8)
        assert o["diag"]["eps"].shape == (4,)
        assert o["diag"]["accept_rate"] == one["diag"]["accept_rate"]
    _moments_close(one["x"], sh[0]["x"])


def test_cli_validate_distributed_over_two_ranks(tmp_path):
    """`validate --distributed` over two CPU processes (a file://
    coordinator): the lead fits SVI and prints the one JSON line, the
    other rank prints nothing; its moments and diagnostics are the
    one-process command's."""
    argv = [sys.executable, "-m", "terastructure_tpu_torch.cli", "validate",
            "--simulate", "-n", "32", "-l", "64", "-k", "2", "--chains",
            "2", "--n-samples", "20", "--n-warmup", "20", "--force-cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("XLA_FLAGS", "JAX_PLATFORMS"):
        env.pop(key, None)
    coord = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        argv + ([] if r is None else [
            "--coordinator", coord, "--num-processes", "2",
            "--process-id", str(r)]),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (None, 0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    single, lead, other = (o.strip().splitlines() for o, _ in outs)
    assert other == [] and len(lead) == 1
    got, want = json.loads(lead[0]), json.loads(single[-1])
    assert set(got) == set(want) == {"theta_mae", "beta_mae", "svi_steps",
                                     "sampler", "convergence"}
    assert got == want
