"""The port's spectral init (svi/init.py) against the reference's
(terastructure_tpu/svi/init.py) and numpy's exact SVD, on the CPU.

Tolerances, stated per test: the standardized block within 1e-6; the
embedding where the sketch is exact (r = N: Y spans M's whole range)
each column |cos| >= 0.999 and norms within 1e-3 of the exact SVD's and
the reference's; at the default oversample the two packages draw other
sketches (torch generator against threefry), so their (k-1)-dimensional
subspaces are held to the exact one (each principal cosine >= 0.98);
k-means from the same embedding and first centre within 1e-5; the
reference's own recovery thresholds for the init and a fit from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.data.simulate import simulate_psd
from terastructure_tpu.svi import init as ref_init
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.svi import fit
from terastructure_tpu_torch.svi import init
from terastructure_tpu_torch.utils.labels import mean_abs_theta_error


@pytest.fixture(scope="module")
def recovery_data():
    """The reference's test_spectral_init_starts_near_truth_and_fits data."""
    theta, _, x = simulate_psd(200, 2000, 3, seed=4, structured=True)
    return theta, x, pack2bit(x.T)


def _exact_embedding(packed, n, k):
    z = init._standardized_block(torch.from_numpy(packed), n).double()
    _, s, vt = np.linalg.svd(z.numpy(), full_matrices=False)
    return vt[:k - 1].T * s[:k - 1]


def _principal_cosines(a, b):
    qa, qb = np.linalg.qr(a)[0], np.linalg.qr(b)[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_standardized_block_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (50, 37)).astype(np.int8)
    x[rng.random(x.shape) < 0.1] = 3                   # missing
    x[7] = 3                                           # a SNP all missing
    x[8] = 0                                           # monomorphic: clipped
    packed = pack2bit(x)
    got = init._standardized_block(torch.from_numpy(packed), 37).numpy()
    want = np.asarray(ref_init._standardized_block(jnp.asarray(packed), 37))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[x == 3] == 0).all()


def test_pca_embedding_exact_sketch_matches_svd_and_reference():
    _, _, x = simulate_psd(64, 512, 3, seed=4, structured=True)
    packed = pack2bit(x.T)
    over = 64 - 2                                       # r = N
    got = init.pca_embedding(packed, 64, 3, oversample=over, seed=0,
                             block=100, device="cpu").numpy()
    ref = np.asarray(ref_init.pca_embedding(jnp.asarray(packed), 64, 3,
                                            oversample=over, seed=0))
    exact = _exact_embedding(packed, 64, 3)
    for want in (exact, ref):
        for j in range(2):
            cos = abs(got[:, j] @ want[:, j]) / (
                np.linalg.norm(got[:, j]) * np.linalg.norm(want[:, j]))
            assert cos >= 0.999, (j, cos)
            assert np.linalg.norm(got[:, j]) == pytest.approx(
                np.linalg.norm(want[:, j]), rel=1e-3)


def test_pca_embedding_default_sketch_spans_the_exact_subspace(
        recovery_data):
    _, _, packed = recovery_data
    exact = _exact_embedding(packed, 200, 3)
    got = init.pca_embedding(torch.from_numpy(packed), 200, 3, seed=0)
    ref = np.asarray(ref_init.pca_embedding(jnp.asarray(packed), 200, 3))
    assert got.shape == (200, 2) and got.dtype == torch.float32
    for emb in (got.numpy(), ref):
        assert (_principal_cosines(emb, exact) >= 0.98).all()
    # slab size changes the second pass's sum order only
    other = init.pca_embedding(packed, 200, 3, seed=0, block=300,
                               device="cpu")
    np.testing.assert_allclose(other.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-3)
    assert init.slab_rows(2504) == 65536 and init.slab_rows(1_000_000) == 268


def test_kmeans_matches_reference_from_the_same_first_centre():
    rng = np.random.default_rng(3)
    e = np.concatenate([rng.normal(c, 0.3, (40, 2)) for c in
                        ((0, 0), (4, 0), (0, 4), (4, 4))]).astype(np.float32)
    for k, seed in ((4, 0), (3, 7)):
        first = int(jax.random.randint(jax.random.PRNGKey(seed), (), 0,
                                       len(e)))
        want = np.asarray(ref_init._kmeans(jnp.asarray(e), k, seed))
        got = init._kmeans(torch.from_numpy(e), k, seed, first=first)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # an empty cluster's centre is the zero vector, as the reference's
    e2 = np.repeat(np.array([[1.0, 2.0], [3.0, 1.0]], np.float32), 5, 0)
    want = np.asarray(ref_init._kmeans(jnp.asarray(e2), 3, 0))
    first = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 10))
    got = init._kmeans(torch.from_numpy(e2), 3, 0, first=first).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got == 0).all(axis=1).any()


def test_spectral_init_starts_near_truth_and_fits(recovery_data):
    """The reference's test (tests/test_recovery.py:62) on the port: the
    init within theta MAE 0.15 of the truth (uniform sits at ~0.39), and a
    fit from it converged within 0.05."""
    theta, x, packed = recovery_data
    g = init.spectral_gamma(packed, 200, 3, alpha=1 / 3, seed=0,
                            device="cpu").numpy()
    err0 = mean_abs_theta_error(g / g.sum(1, keepdims=True), theta)
    assert err0 < 0.15, err0
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.01, seed=0)
    cfg = SVIConfig(n=200, l=2000, k=3, batch_size=128, rfreq=50,
                    max_steps=4000, seed=0, init="spectral")
    res = fit(cfg, data, device="cpu")
    th = psd.theta_mean(res.state.gamma).numpy()
    assert res.converged
    assert mean_abs_theta_error(th, theta) < 0.05


def test_fit_starts_from_spectral_gamma(recovery_data):
    """fit(init="spectral") starts from spectral_gamma of the carved
    matrix with the config's alpha, seed and L (no step at max_steps 0)."""
    _, x, _ = recovery_data
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.01, seed=0)
    cfg = SVIConfig(n=200, l=2000, k=3, max_steps=0, seed=2,
                    init="spectral", lambda_mode="stored")
    res = fit(cfg, data, device="cpu")
    want = init.spectral_gamma(data.packed, 200, 3, alpha=cfg.alpha_value,
                               seed=2, l_real=2000, device="cpu")
    assert res.steps == 0 and torch.equal(res.state.gamma, want)
    one = init.spectral_gamma(data.packed, 200, 1, alpha=1.0, device="cpu")
    assert torch.equal(one, torch.full((200, 1), 6.0))


def test_batched_replicates_refuse_spectral_init(recovery_data):
    from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

    _, x, _ = recovery_data
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.01, seed=0)
    cfg = SVIConfig(n=200, l=2000, k=3, init="spectral")
    with pytest.raises(NotImplementedError, match="random gamma"):
        fit_replicates_batched(cfg, data, [0, 1], device="cpu")
