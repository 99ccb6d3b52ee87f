"""The port's out-of-core streaming (svi/stream.py, fit(stream=True))
against the reference's, on the same numpy data (CPU; the reference's
Pallas kernels in interpret mode). The shapes are tests/test_stream.py's:
n = 300, l = 256, K = 3, B = 64, 3% missing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu.svi import fit as ref_fit
from terastructure_tpu.svi import stream as ref_stream
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.data.pack import unpack2bit_torch
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.svi import engine, fit, postprocess, stream

# gamma of the port's and the reference's streamed dense chunks after 200
# steps on the same batches from one state: the packages' f32 sums run in
# other orders, and each step carries the last step's gap on. Measured on
# this data (CPU): max |difference| 0.0074 against max gamma 477 (1.5e-5
# of it), max relative difference 5.2e-4 (on small entries).
TRACK_RTOL = 2e-3
TRACK_ATOL = 5e-5          # of max |gamma|


def _data(n=300, l=256, k=3, seed=7):
    theta, _, x = simulate_psd(n, l, k, seed=seed, missing_frac=0.03)
    split = dict(validation_frac=0.01, heldout_frac=0.01, seed=seed)
    return theta, GenotypeData.from_dense(x, **split), RefData.from_dense(
        x, **split)


def _cfg(data, **kw):
    base = dict(n=data.n, l=data.l, k=3, batch_size=64, seed=11,
                kernel="dense", lambda_mode="local", rfreq=50,
                max_steps=200)
    base.update(kw)
    return SVIConfig(**base)


def _states(cfg):
    """One initial state in both packages (the reference's draw)."""
    s0 = ref_engine.init_state(cfg)
    return s0, engine.state_from_reference(s0.gamma, s0.lamb, s0.t, cfg.seed)


@pytest.mark.parametrize("memmap", [False, True])
@pytest.mark.parametrize("g", [1, 8])
def test_batches_are_the_references_bitwise(tmp_path, g, memmap):
    _, data, ref = _data()
    packed = data.packed
    if memmap:
        mm = np.lib.format.open_memmap(str(tmp_path / "p.npy"), mode="w+",
                                       dtype=np.uint8, shape=packed.shape)
        mm[:] = packed
        mm.flush()
        packed = np.load(str(tmp_path / "p.npy"), mmap_mode="r")
    cfg = _cfg(data, snp_group=g)
    bs = stream.BatchStream(cfg, packed)
    rbs = ref_stream.BatchStream(cfg, packed)
    wrapped = 0
    for t in range(12):
        got = bs.ready(bs.batch(t))
        assert got.dtype == torch.uint8 and got.shape == (64, 128)
        np.testing.assert_array_equal(got.numpy(), np.asarray(rbs.batch(t)))
        wrapped += int((bs.starts(t) > data.l - g).sum())
    assert bs.g == g and (wrapped > 0 or g == 1)       # groups wrap at L
    assert (got.numpy()[:, data.packed.shape[1]:] == 0xFF).all()


def test_stream_step_dense_matches_reference():
    """Bitwise the port's dense core + global update on the same rows (the
    reference holds its own stream step to its engine at rtol 1e-6, atol
    1e-7); against the reference's stream step, whose f32 sums run in
    another order, to 1e-5 (measured: 2.3e-6 relative at most)."""
    _, data, ref = _data()
    cfg = _cfg(data)
    rows = np.array(jax.device_get(
        ref_stream.BatchStream(cfg, ref.packed).batch(0)))
    s0, st = _states(cfg)
    want = ref_stream.make_stream_step(cfg, data.l)(s0, jnp.asarray(rows))
    got = stream.make_stream_step(cfg, data.l)(st, torch.from_numpy(rows))
    xb = unpack2bit_torch(torch.from_numpy(rows), cfg.n)
    _, stat = engine.step_core_dense(cfg, st.gamma, xb,
                                      engine._prior_lamb(cfg, 64, "cpu"))
    assert torch.equal(got.gamma, engine._global_update(cfg, st.gamma, stat,
                                                        0, data.l))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               rtol=1e-5, atol=1e-7)
    assert got.t == int(want.t) == 1


def test_stream_step_pallas_matches_reference():
    """kernel="pallas" (and "auto", which the stream resolves the same
    way) at N = 300, where the column subsample does not engage: the
    reference's Pallas kernels in interpret mode, the port's twins."""
    _, data, ref = _data()
    cfg = _cfg(data, kernel="pallas")
    rows = np.array(jax.device_get(
        ref_stream.BatchStream(cfg, ref.packed).batch(3)))
    s0, st = _states(cfg)
    s0 = s0._replace(t=jnp.int32(3))
    want = ref_stream.make_stream_step(cfg, data.l)(s0, jnp.asarray(rows))
    calls = pk.batch_stats_fused_v2_packed.twin_calls
    got = stream.make_stream_step(cfg, data.l)(st._replace(t=3),
                                               torch.from_numpy(rows))
    assert pk.batch_stats_fused_v2_packed.twin_calls == calls + 1
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               rtol=2e-4, atol=2e-4)
    auto = stream.make_stream_step(cfg.replace(kernel="auto"), data.l)(
        st._replace(t=3), torch.from_numpy(rows))
    assert torch.equal(auto.gamma, got.gamma)


def test_stream_step_is_the_resident_big_n_step_bitwise():
    """A streamed step on rows r is step_core_packed + _global_update on
    r with the resident step's subsample stream (N = 4096, so the column
    subsample engages)."""
    n, k, b = 4096, 3, 16
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, size=(64, n // 4), dtype=np.uint8)
    cfg = SVIConfig(n=n, l=64, k=k, batch_size=b, seed=2, local_sub_n=512,
                    kernel="pallas", snp_group=4)
    st = engine.init_state(cfg)._replace(t=5)
    bs = stream.BatchStream(cfg, packed)
    rows = bs.ready(bs.batch(5))
    got = stream.make_stream_step(cfg, 64)(st, rows)
    gen = engine.step_generator(cfg.seed, 5, "cpu", engine.SUB_TAG)
    assert engine.subsample_columns(cfg, 1024, gen) is not None
    gen = engine.step_generator(cfg.seed, 5, "cpu", engine.SUB_TAG)
    _, stat = engine.step_core_packed(cfg, st.gamma, rows, gen=gen)
    want = engine._global_update(cfg, st.gamma, stat, 5, 64)
    assert torch.equal(got.gamma, want) and got.t == 6


def test_streamed_chunks_track_the_reference():
    """200 streamed dense steps (four chunks of 50) from one state: the
    same batches in both packages, so gamma tracks to TRACK_RTOL and
    TRACK_ATOL; the port's re-run is bitwise equal."""
    _, data, ref = _data()
    cfg = _cfg(data)
    s0, st = _states(cfg)
    ref_chunk = ref_stream.make_stream_chunk(cfg, 50, data.l)
    chunk = stream.make_stream_chunk(cfg, 50, data.l)
    ref_state, a, b = s0, st, st
    for _ in range(4):
        ref_state = ref_chunk(ref_state, ref.packed)
        a = chunk(a, data.packed)
        b = chunk(b, data.packed)
    assert a.t == int(ref_state.t) == 200
    assert torch.equal(a.gamma, b.gamma)
    want = np.asarray(ref_state.gamma)
    np.testing.assert_allclose(a.gamma.numpy(), want, rtol=TRACK_RTOL,
                               atol=TRACK_ATOL * np.abs(want).max())


def test_stream_fit_matches_reference_fit():
    """fit(stream=True) in both packages (their initial gammas come from
    different generators, so the two are compared as test_torch_fit
    compares resident fits): finite scores, heldouts within 0.05 nats,
    lambda exported; the port's re-run is bitwise equal."""
    theta, data, ref = _data()
    cfg = _cfg(data)
    res = fit(cfg, data, device="cpu", stream=True)
    again = fit(cfg, data, device="cpu", stream=True)
    want = ref_fit(cfg, ref, stream=True)
    assert torch.equal(res.state.gamma, again.state.gamma)
    assert res.steps == 200 and np.isfinite(res.validation_ll)
    assert np.isfinite(res.heldout_ll) and np.isfinite(want.heldout_ll)
    assert abs(res.heldout_ll - want.heldout_ll) < 0.05
    assert res.state.lamb.shape == (data.l, 3, 2)
    assert float((res.state.lamb - 1.0).abs().max()) > 1.0
    assert isinstance(data.packed, np.ndarray)          # never moved


def test_compute_lambda_stream_is_the_resident_export():
    """Chunks of 64 rows, a multiple of the 32-row block: bitwise the
    port's resident compute_lambda. Against the reference's
    compute_lambda_stream within 2e-4 on the plain schedule (with the
    accel tail, sum order moves a few coordinates further: test_torch_
    engine.test_compute_lambda_matches_reference)."""
    _, data, ref = _data(n=123, l=96)
    for accel in (True, False):
        cfg = _cfg(data, max_steps=50, local_accel=accel,
                   local_iters=7 if accel else 16)
        s0, st = _states(cfg)
        gamma = st.gamma + 0.3
        got = stream.compute_lambda_stream(cfg, gamma, data.packed, block=32,
                                           chunk_bytes=64 * 128)
        resident = postprocess.compute_lambda(
            cfg, gamma, torch.from_numpy(engine.pad_width(data.packed)),
            block=32)
        assert got.shape == (96, 3, 2) and got.dtype == np.float32
        np.testing.assert_array_equal(got, resident.numpy())
    want = ref_stream.compute_lambda_stream(cfg, s0.gamma + 0.3, ref.packed,
                                            block=32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    beta = stream.compute_beta_stream(cfg, gamma, data.packed, block=32)
    np.testing.assert_allclose(beta, got[..., 0] / got.sum(-1), rtol=1e-6)


def test_stream_refuses_what_it_cannot_do():
    _, data, _ = _data()
    with pytest.raises(ValueError, match="lambda_mode='local'"):
        fit(_cfg(data, lambda_mode="stored"), data, device="cpu",
            stream=True)
    with pytest.raises(ValueError, match="C-contiguous"):
        stream.BatchStream(_cfg(data), data.packed[:, ::2])


def test_worker_exception_propagates(monkeypatch):
    _, data, _ = _data()
    cfg = _cfg(data)
    chunk = stream.make_stream_chunk(cfg, 5, data.l)
    st = engine.init_state(cfg)
    gather = stream.BatchStream.gather

    def failing(self, t, out):
        if t == 3:
            raise OSError("read failed at step 3")
        gather(self, t, out)

    monkeypatch.setattr(stream.BatchStream, "gather", failing)
    with pytest.raises(OSError, match="step 3"):
        chunk(st, data.packed)


def test_launch_grids_and_workspaces_hold_at_config5_width():
    """The shapes the streamed big-N step hands the kernels at N = 1M
    (W = 250,000 bytes, padded to 250,112; B = 4096; K = 10): every grid
    dimension in the CUDA limits (x < 2^31, y and z <= 65,535), the
    column splits covering W, and the partial-sum workspaces sized as the
    launchers allocate them."""
    k = 10
    for w in (250_000, 250_112):
        for b in (4096, 4092, 1024):
            nsplit, chunk = pk.lambda_grid(b, w, k)    # K4 (eval, export)
            assert 1 <= nsplit <= 65_535 and chunk % 16 == 0
            assert (nsplit - 1) * chunk < w <= nsplit * chunk
            assert -(-b // pk.LAMBDA_ROWS) < 2 ** 31
            gs = pk.gamma_grid(b, w, k)               # K5
            assert 1 <= gs <= 65_535 and -(-w // pk.GAMMA_COLS) < 2 ** 31
            for dtype in (torch.float32, torch.bfloat16):  # K7
                nwt = -(-w // pk.V2_TILE_COLS)
                nbt = -(-b // pk.v2_tile_rows(k, dtype))
                assert nwt < 2 ** 31 and nbt <= 65_535
        # K8 runs on the subsample's 2,048 columns at every N
        assert pk.lambda_grid(4096, 2048, k)[0] <= 65_535
    # K7's partials at the step's shape, f32: (B/128, 4W, K) gamma and
    # (W/256, B, K, 2) lambda floats, ~1.3 GB and ~0.32 GB
    w, b = 250_112, 4096
    gpart = -(-b // pk.v2_tile_rows(k)) * 4 * w * k * 4
    lpart = -(-w // pk.V2_TILE_COLS) * b * k * 2 * 4
    assert 1.2e9 < gpart < 1.4e9 and 0.3e9 < lpart < 0.35e9
    # the batch's entries pass 2^31: the kernels index in 64 bits
    assert b * 4 * w > 2 ** 31
