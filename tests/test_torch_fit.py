"""A whole port fit against a reference fit on the same data split (CPU).

Seeds cannot line up (threefry vs the torch generator), so the two fits
are compared statistically: both scores finite, heldout log-likelihoods
within 0.05 nats (as tests/test_fused.py:84-103 holds two reference
modes), theta MAE against the truth within Monte-Carlo error.
"""

import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.models import psd as ref_psd
from terastructure_tpu.svi import fit as ref_fit
from terastructure_tpu.utils.labels import mean_abs_theta_error
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.svi import fit


def test_port_fit_matches_reference_fit():
    n, l, k = 64, 256, 2
    theta_true, _, x = simulate_psd(n, l, k, seed=33)
    split = dict(validation_frac=0.02, heldout_frac=0.02, seed=33)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=100, max_steps=800,
                    seed=33)
    ref = ref_fit(cfg.replace(kernel="dense"), RefData.from_dense(x, **split))
    res = fit(cfg, GenotypeData.from_dense(x, **split), device="cpu")

    assert np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)
    assert np.isfinite(ref.validation_ll) and np.isfinite(ref.heldout_ll)
    assert abs(res.heldout_ll - ref.heldout_ll) < 0.05, (res.heldout_ll,
                                                         ref.heldout_ll)
    mae = mean_abs_theta_error(psd.theta_mean(res.state.gamma).numpy(),
                               theta_true)
    ref_mae = mean_abs_theta_error(
        np.asarray(ref_psd.theta_mean(ref.state.gamma)), theta_true)
    assert mae < 0.1 and abs(mae - ref_mae) < 0.03, (mae, ref_mae)
    # exported lambda is the converged recomputation, not the prior
    assert res.state.lamb.shape == (l, k, 2)
    assert float((res.state.lamb - 1.0).abs().max()) > 1.0
    assert res.trace and all("chunk_s" in r and "eval_s" in r
                             for r in res.trace)


def test_port_fit_dense_and_fused_agree():
    """kernel='dense' and the default fused path: same quality."""
    n, l, k = 64, 256, 2
    _, _, x = simulate_psd(n, l, k, seed=34)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0.02, seed=34)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=100, max_steps=600,
                    seed=34)
    fused = fit(cfg, data, device="cpu")
    dense = fit(cfg.replace(kernel="dense"), data, device="cpu")
    assert abs(fused.heldout_ll - dense.heldout_ll) < 0.05
