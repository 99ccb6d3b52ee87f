"""The device-resident half of the biobank demo (data/simulate.py
simulate_packed_device_resident, data/dataset.py carve_eval_device, the
driver's eval rows read where they lie) and the multi-rank dry run
(parallel/dryrun.py), on the CPU device.

The reference's tests/test_dataset.py:104-205, ported: the resident
simulator bitwise the port's simulate_packed_device at l % chunk == 0
and its clamped tail write; the carve's semantics, and beside them its
pool, entries, recoded matrix and eval rows bitwise the reference's
carve_eval_device on the same matrix; a fit on a device-resident
GenotypeData. Then the dry run's four passes over 4 CPU ranks, each
reporting the branch it took.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.data.dataset import carve_eval_device as ref_carve
from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import (GenotypeData,
                                                  carve_eval_device)
from terastructure_tpu_torch.data.pack import unpack2bit
from terastructure_tpu_torch.data.simulate import (
    simulate_packed_device, simulate_packed_device_resident)
from terastructure_tpu_torch.models.psd import MISSING
from terastructure_tpu_torch.parallel import dryrun
from terastructure_tpu_torch.svi import driver, engine, fit


def test_simulate_packed_device_resident_parity():
    """tests/test_dataset.py:104: the resident matrix is bitwise the host
    copy's for the same seed and chunk where l % chunk == 0."""
    n, l, k = 64, 128, 3
    pk_host, th_host = simulate_packed_device(
        n, l, k, seed=7, chunk=32, missing_frac=0.05, device="cpu")
    pk_dev, th_dev = simulate_packed_device_resident(
        n, l, k, seed=7, chunk=32, missing_frac=0.05, device="cpu")
    assert isinstance(pk_dev, torch.Tensor) and pk_dev.dtype == torch.uint8
    np.testing.assert_array_equal(pk_dev.numpy(), pk_host)
    np.testing.assert_array_equal(th_dev, th_host)


def test_simulate_packed_device_resident_tail():
    """tests/test_dataset.py:122: l % chunk != 0; the tail chunk, drawn
    whole, is written at l - chunk: every row a PSD draw (codes 0/1/2, no
    stray MISSING), the rows before it the host copy's."""
    n, l, k = 64, 100, 3
    pk_dev, theta = simulate_packed_device_resident(n, l, k, seed=1,
                                                    chunk=32, device="cpu")
    pk = pk_dev.numpy()
    assert pk.shape == (l, n // 4)
    x = unpack2bit(pk, n)
    assert set(np.unique(x)) <= {0, 1, 2}
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-5)
    pk_host, _ = simulate_packed_device(n, l, k, seed=1, chunk=32,
                                        device="cpu")
    np.testing.assert_array_equal(pk[: l - 32], pk_host[: l - 32])


def test_carve_eval_device_semantics():
    """tests/test_dataset.py:139: entries come from the pool, their
    values preserved, the training copies recoded MISSING, nothing else
    touched, eval_rows the post-carve pool rows on the matrix's device;
    and all of it bitwise the reference's carve on the same matrix."""
    n, l = 256, 512
    pk_dev, _ = simulate_packed_device_resident(n, l, 3, seed=5,
                                                missing_frac=0.05,
                                                device="cpu")
    before = pk_dev.numpy().copy()
    pk_dev, val, held, pool, rows = carve_eval_device(
        pk_dev, n, validation_frac=0.01, heldout_frac=0.01, seed=5,
        eval_snp_pool=64)
    assert len(pool) == 64 and (np.diff(pool) > 0).all()
    after = pk_dev.numpy()
    x_before = unpack2bit(before, n)
    x_after = unpack2bit(after, n)
    seen = set()
    for es in (val, held):
        assert es is not None and len(es) > 0
        assert np.isin(es.snp_idx, pool).all()
        assert set(np.unique(es.x)) <= {0, 1, 2}
        np.testing.assert_array_equal(es.x, x_before[es.snp_idx, es.ind_idx])
        assert (x_after[es.snp_idx, es.ind_idx] == MISSING).all()
        pairs = set(zip(es.ind_idx.tolist(), es.snp_idx.tolist()))
        assert not (pairs & seen), "validation/heldout overlap"
        seen |= pairs
    mask = np.ones((l, n), bool)
    for es in (val, held):
        mask[es.snp_idx, es.ind_idx] = False
    np.testing.assert_array_equal(x_before[mask], x_after[mask])
    assert isinstance(rows, torch.Tensor) and rows.device == pk_dev.device
    np.testing.assert_array_equal(rows.numpy(), after[pool])

    r_pk, r_val, r_held, r_pool, r_rows = ref_carve(
        jnp.asarray(before), n, validation_frac=0.01, heldout_frac=0.01,
        seed=5, eval_snp_pool=64)
    np.testing.assert_array_equal(r_pool, pool)
    np.testing.assert_array_equal(np.asarray(r_pk), after)
    np.testing.assert_array_equal(np.asarray(r_rows), rows.numpy())
    for a, b in ((val, r_val), (held, r_held)):
        for f in ("ind_idx", "snp_idx", "x"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _resident(n, l, k, seed=0):
    pk, _ = simulate_packed_device_resident(n, l, k, seed=seed, device="cpu")
    pk, val, held, pool, rows = carve_eval_device(pk, n, seed=seed,
                                                  eval_snp_pool=64)
    return GenotypeData(n=n, l=l, packed=pk, validation=val, heldout=held,
                        eval_row_snps=pool, eval_rows_full=rows)


def test_fit_device_resident():
    """tests/test_dataset.py:183: a fit on a GenotypeData whose matrix and
    eval rows are tensors on the device (here the CPU): finite scores,
    the eval rows gathered there as a tensor, and every check's score
    and the state bitwise a fit of the same data held on the host."""
    n, l, k = 512, 256, 3
    data = _resident(n, l, k)
    uniq = np.unique(data.validation.snp_idx)
    rows = driver.eval_rows(data, uniq)
    assert isinstance(rows, torch.Tensor)
    np.testing.assert_array_equal(
        rows.numpy(), data.packed.numpy()[uniq])
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=25, max_steps=50,
                    lambda_mode="local")
    res = fit(cfg, data, device="cpu")
    assert np.isfinite(res.validation_ll)
    assert res.heldout_ll is None or np.isfinite(res.heldout_ll)
    host = GenotypeData(n=n, l=l, packed=data.packed.numpy().copy(),
                        validation=data.validation, heldout=data.heldout,
                        eval_row_snps=data.eval_row_snps,
                        eval_rows_full=data.eval_rows_full.numpy().copy())
    ref = fit(cfg, host, device="cpu")
    assert [r["validation_ll"] for r in res.trace] == [
        r["validation_ll"] for r in ref.trace]
    assert torch.equal(res.state.gamma, ref.state.gamma)
    assert res.heldout_ll == ref.heldout_ll


def test_device_matrix_is_used_where_it_lies():
    """engine.resident_packed keeps a device matrix whose width is a
    multiple of 128 (no copy) and pads another on its device, as the host
    path pads; the device eval rows are padded the same way."""
    pk = torch.randint(0, 256, (8, 128), dtype=torch.uint8)
    assert engine.resident_packed(pk, "cpu").data_ptr() == pk.data_ptr()
    odd = torch.randint(0, 256, (8, 100), dtype=torch.uint8)
    np.testing.assert_array_equal(
        engine.resident_packed(odd, "cpu").numpy(),
        engine.pad_width(odd.numpy()))
    data = GenotypeData(n=400, l=8, packed=odd)
    np.testing.assert_array_equal(
        driver.eval_rows(data, np.array([1, 5])).numpy(),
        engine.pad_width(odd.numpy()[[1, 5]]))


@pytest.mark.parametrize("n_ranks", [4])
def test_dryrun_passes_take_their_branches(n_ranks):
    """python -m terastructure_tpu_torch.parallel.dryrun --ranks 4
    --device cpu: the reference's four passes, each with finite gamma > 0
    and log-likelihood, the fused pass through K1's twin on every rank,
    the big-N pass through K3, K8, K4 and K7 (their twins), the default
    and pipelined bf16 passes on the branch their plans name."""
    rep = dryrun.dryrun(n_ranks, "cpu", timeout=300, threads=1)
    assert rep["failures"] == []
    passes = {p["name"]: p for p in rep["passes"]}
    assert list(passes) == ["default", "fused", "big-N", "comm_overlap+bf16"]
    assert passes["fused"]["branch"] == "fused"
    assert passes["fused"]["counts"]["K1"][1] >= 1
    big = passes["big-N"]
    assert big["branch"] == "kernels+K3+subsample"
    assert all(big["counts"][k][1] >= 1 for k in ("K3", "K4", "K7", "K8"))
    assert passes["default"]["grid"] == [2, 2]
    assert passes["comm_overlap+bf16"]["steps"] == 2
    # a check that sees another branch fails
    wrong = [dict(passes["fused"], branch="dense")]
    assert dryrun.check(wrong, "cpu")
