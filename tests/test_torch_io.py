"""The port's text export, checkpoint and fit hooks against the reference
(terastructure_tpu/io/export.py, io/checkpoint.py, svi/driver.py's
metrics_path / trace_path / checkpoint_dir) on the CPU.

Tolerances: the text files and checkpoints are compared byte for byte
and bit for bit; theta.txt and beta.txt are byte-identical to the
reference's too (the mean over K in f32 rounds the same at these
shapes); a resumed fit is bitwise an uninterrupted one."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from terastructure_tpu.io import export as ref_export
from terastructure_tpu.utils import profiling as ref_profiling
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.io import checkpoint as ckpt
from terastructure_tpu_torch.io import export
from terastructure_tpu_torch.svi import engine, fit
from terastructure_tpu_torch.utils import profiling


def _model(seed=0, n=37, l=53, k=4):
    rng = np.random.default_rng(seed)
    gamma = (rng.gamma(0.5, 3.0, (n, k)) + 1e-3).astype(np.float32)
    lamb = (rng.gamma(0.5, 50.0, (l, k, 2)) + 1e-3).astype(np.float32)
    gamma[0, 0] = np.float32(1e20)               # an exponent in the text
    lamb[1, 1, 0] = np.float32(1.0)              # an integral value
    return gamma, lamb


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ids", [None, "labels"])
def test_write_matrix_bytes_equal_reference(tmp_path, ids):
    mat = np.random.default_rng(1).normal(size=(300, 5)).astype(np.float32)
    mat[0] = [0.0, -0.0, 1e-30, 123456789.0, np.float32(1 / 3)]
    labels = [f"id{i}" for i in range(300)] if ids else None
    export._write_matrix(str(tmp_path / "p.txt"), mat, labels)
    ref_export._write_matrix(str(tmp_path / "r.txt"), mat, labels)
    assert _read(tmp_path / "p.txt") == _read(tmp_path / "r.txt")
    # float64 rows (the simulator's theta_true) too
    m64 = np.random.default_rng(2).random((9, 3))
    export._write_matrix(str(tmp_path / "p64.txt"), m64)
    ref_export._write_matrix(str(tmp_path / "r64.txt"), m64)
    assert _read(tmp_path / "p64.txt") == _read(tmp_path / "r64.txt")


def test_save_model_bytes_equal_reference(tmp_path):
    gamma, lamb = _model()
    ind = [f"i{i}" for i in range(gamma.shape[0])]
    snp = [f"s{j}" for j in range(lamb.shape[0])]
    # padded inputs, trimmed to n and l as the reference trims them
    gp = np.concatenate([gamma, np.ones((3, 4), np.float32)])
    lp = np.concatenate([lamb, np.ones((5, 4, 2), np.float32)])
    export.save_model(str(tmp_path / "p"), torch.from_numpy(gp),
                      torch.from_numpy(lp), n=37, l=53, ind_ids=ind,
                      snp_ids=snp)
    ref_export.save_model(str(tmp_path / "r"), gp, lp, n=37, l=53,
                          ind_ids=ind, snp_ids=snp)
    for name in ("gamma.txt", "lambda.txt", "theta.txt", "beta.txt"):
        assert _read(tmp_path / "p" / name) == _read(tmp_path / "r" / name), (
            name)


def test_load_model_and_state_from_text_model(tmp_path):
    gamma, lamb = _model(3, n=11, l=17, k=3)
    ref_export.save_model(str(tmp_path), gamma, lamb)
    g, lm = export.load_model(str(tmp_path))
    rg, rlm = ref_export.load_model(str(tmp_path))
    np.testing.assert_array_equal(g, rg)
    np.testing.assert_array_equal(lm, rlm)
    # 8 significant digits bring an f32 back to within one ulp
    np.testing.assert_allclose(g, gamma, rtol=2 ** -23, atol=0)
    cfg = SVIConfig(n=11, l=17, k=3, seed=5)
    st = export.state_from_text_model(str(tmp_path), cfg, step=7)
    assert st.t == 7 and st.seed == 5
    assert torch.equal(st.gamma, torch.from_numpy(rg))
    os.remove(tmp_path / "lambda.txt")          # theta-only: lambda at prior
    st = export.state_from_text_model(str(tmp_path), cfg)
    assert torch.equal(st.lamb[..., 0], torch.full((17, 3), cfg.beta_a))
    with pytest.raises(ValueError, match="gamma.txt shape"):
        export.state_from_text_model(str(tmp_path), cfg.replace(k=4))


def _data(seed=9, n=40, l=96, k=2, frac=0.02):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return GenotypeData.from_dense(x, validation_frac=frac,
                                   heldout_frac=frac, seed=seed)


def test_checkpoint_roundtrip_bitwise(tmp_path):
    data = _data(frac=0.0)
    cfg = SVIConfig(n=40, l=96, k=2, batch_size=16, seed=9,
                    lambda_mode="stored")
    packed = torch.from_numpy(engine.pad_width(data.packed))
    state = engine.make_run_chunk(cfg, 3)(engine.init_state(cfg), packed)
    ckpt.save_checkpoint(str(tmp_path / "ck"), state, cfg)
    state2, cfg2 = ckpt.restore_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == cfg and (state2.t, state2.seed) == (3, 9)
    assert torch.equal(state2.gamma, state.gamma)
    assert torch.equal(state2.lamb, state.lamb)
    # the config is the reference's layout: its SVIConfig reads it
    from terastructure_tpu.config import SVIConfig as RefConfig

    with open(tmp_path / "ck" / "config.json") as f:
        assert RefConfig.from_json(f.read()).to_json() == cfg.to_json()


@pytest.mark.parametrize("lambda_mode", ["local", "stored"])
def test_resumed_fit_is_bitwise_uninterrupted(tmp_path, lambda_mode):
    data = _data(frac=0.0)
    cfg = SVIConfig(n=40, l=96, k=2, batch_size=16, rfreq=20, seed=9,
                    lambda_mode=lambda_mode)
    first = fit(cfg.replace(max_steps=60), data, device="cpu",
                checkpoint_dir=str(tmp_path / "ck"))
    ckpt.save_checkpoint(str(tmp_path / "ck"), first.state, cfg)
    state, _ = ckpt.restore_checkpoint(str(tmp_path / "ck"))
    assert state.t == 60
    resumed = fit(cfg.replace(max_steps=120), data, device="cpu",
                  state=state)
    straight = fit(cfg.replace(max_steps=120), data, device="cpu")
    assert resumed.steps == straight.steps == 120
    assert torch.equal(resumed.state.gamma, straight.state.gamma)
    assert torch.equal(resumed.state.lamb, straight.state.lamb)


def test_async_mid_fit_checkpoint_holds_its_check(tmp_path, monkeypatch):
    """A save at a mid-fit check, written only after later chunks have
    stepped the stored lambda in place, restores to the state of that
    check (the snapshot is taken when the save is enqueued)."""
    data = _data(frac=0.0)
    cfg = SVIConfig(n=40, l=96, k=2, batch_size=16, rfreq=20, seed=9,
                    lambda_mode="stored")
    write = ckpt._write
    started = []

    def slow_write(*args):
        started.append(threading.current_thread().name)
        time.sleep(0.5)                        # later chunks step meanwhile
        write(*args)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    steps_seen = []
    fit(cfg.replace(max_steps=60), data, device="cpu",
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        callback=lambda rec: steps_seen.append(rec["step"]))
    assert steps_seen == [20, 40, 60] and len(started) == 1
    assert started[0].startswith("checkpoint")  # written off the loop
    state, _ = ckpt.restore_checkpoint(str(tmp_path / "ck"))
    at40 = fit(cfg.replace(max_steps=40), data, device="cpu")
    assert state.t == 40
    assert torch.equal(state.gamma, at40.state.gamma)
    assert torch.equal(state.lamb, at40.state.lamb)


def test_failed_async_write_raises_on_wait(tmp_path, monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    cfg = SVIConfig(n=4, l=8, k=2)
    ckpt.save_checkpoint(str(tmp_path), engine.init_state(cfg), cfg,
                         block=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_until_finished()
    ckpt.wait_until_finished()                  # raised once, then clear


def test_metrics_and_trace_files_match_the_trace(tmp_path):
    data = _data()
    cfg = SVIConfig(n=40, l=96, k=2, batch_size=16, rfreq=20, max_steps=60,
                    seed=9)
    recs = []
    res = fit(cfg, data, device="cpu", callback=recs.append,
              metrics_path=str(tmp_path / "metrics.jsonl"),
              trace_path=str(tmp_path / "validation.txt"))
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s) for s in lines] == res.trace == recs
    assert set(res.trace[0]) == {"step", "wall_s", "rho", "chunk_s",
                                 "predictive", "eval_s", "validation_ll"}
    assert "predictive" not in res.trace[1]
    # the reference's plain trace: step<TAB>ll:.8f<TAB>wall_s
    want = "".join(f"{r['step']}\t{r['validation_ll']:.8f}\t{r['wall_s']}\n"
                   for r in res.trace)
    assert (tmp_path / "validation.txt").read_text() == want
    assert set(res.timings) >= {"init_s", "export_s", "checkpoint_wait_s",
                                "heldout_s"}


def test_fit_takes_a_device_packed_and_refuses_it_streamed(tmp_path):
    data = _data()
    cfg = SVIConfig(n=40, l=96, k=2, batch_size=16, rfreq=20, max_steps=40,
                    seed=9)
    packed = engine.resident_packed(data.packed, "cpu")
    a = fit(cfg, data, device="cpu", packed=packed)
    b = fit(cfg, data, device="cpu")
    assert torch.equal(a.state.gamma, b.state.gamma)
    with pytest.raises(ValueError, match="host"):
        fit(cfg, data, device="cpu", packed=packed, stream=True)


def test_step_meter_on_fixed_records(monkeypatch):
    """The port's StepMeter gives the reference's rates on the same
    records at the same clock readings."""
    import types

    recs = [{"step": 100, "wall_s": 1.0}, {"step": 200}, {"step": 300},
            {"step": 400}, {"step": 400}]
    meters = []
    for mod in (profiling, ref_profiling):
        clock = iter([100.0, 101.0, 102.5, 104.5, 104.5])
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda clock=clock: next(clock)))
        meter = mod.StepMeter(64)
        for r in recs:
            meter(r)
        meters.append(meter)
    got, want = meters
    assert got.rates == want.rates == [6400.0, 6400 / 1.5, 3200.0]
    assert got.t0 == want.t0 == 99.0
    assert got.summary() == want.summary() == {
        "snp_updates_per_s": 6400 / 1.5, "chunks": 3, "steps": 400}
    assert np.isnan(profiling.StepMeter(8).snp_updates_per_s)


def test_trace_writes_a_chrome_trace_and_raises(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64).sum()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path / "u")):
            1 / 0
