"""Steps to convergence from a spectral and from a random gamma start, in
the port and in the JAX reference.

The test fits both packages from the spectral start on the reference's
recovery data (200 x 2,000, K = 3, B = 128, rfreq 50, as
tests/test_recovery.py:62): both converge to theta MAE < 0.05, within
0.01 of each other, and the port's steps lie within 30% of the
reference's (the two packages draw the init's sketch and the minibatches
from other generators, so their steps differ by the draws alone).

Run as a script, it measures: the data is config #3's structure cut in
L: N = 2,504, K = 8, drawn by
the port's `simulate_packed_device(n, l, 8, seed=0)` on the CPU, and one
packed matrix goes to both packages' `GenotypeData.from_packed` (the
same split, seed 0, and an eval pool of 2,048 SNPs). Each fit runs at
B = 1,024, rfreq 100, the default stopping rule, with `cfg.seed` the
given seed (the init's draws and the minibatch stream). One JSON line a
fit: steps, converged, the init's and the fit's theta MAE against the
generating theta, the validation and heldout log-likelihoods, seconds.

    JAX_PLATFORMS=cpu python tests/test_torch_spectral_start.py \\
        --package port --init spectral --seeds 0 1 2 [--l 50000]

`--package port --device cuda` runs the port on the card instead (the
data then drawn there, so other genotypes than the CPU's for the same
seed; no JAX is imported), e.g. at config #3's L = 1,000,000.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N, K = 2504, 8


# the measuring run's setting (config #3's runner: B 1,024, a pool of
# 2,048 eval SNPs); the test passes the recovery test's
SETTING = dict(batch_size=1024, rfreq=100, validation_frac=0.005,
               heldout_frac=0.005, eval_snp_pool=2048)


def _theta_mae(gamma, theta) -> float:
    from terastructure_tpu_torch.utils.labels import mean_abs_theta_error

    g = np.asarray(gamma, np.float64)[: theta.shape[0]]
    return mean_abs_theta_error(g / g.sum(1, keepdims=True), theta)


def _fit_port(packed, n, k, l, init, seed, max_steps, device,
              setting=SETTING):
    from terastructure_tpu_torch import SVIConfig
    from terastructure_tpu_torch.data import GenotypeData
    from terastructure_tpu_torch.svi import fit
    from terastructure_tpu_torch.svi.init import spectral_gamma

    data = GenotypeData.from_packed(
        packed, n, validation_frac=setting["validation_frac"],
        heldout_frac=setting["heldout_frac"], seed=0,
        eval_snp_pool=setting["eval_snp_pool"])
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=setting["batch_size"],
                    rfreq=setting["rfreq"], max_steps=max_steps, seed=seed,
                    init=init)
    g0 = (spectral_gamma(packed, n, k, alpha=cfg.alpha_value, seed=seed,
                         l_real=l, device=device).cpu().numpy()
          if init == "spectral" else None)
    t = time.time()
    res = fit(cfg, data, device=device)
    return g0, res, res.state.gamma.cpu().numpy(), time.time() - t


def _fit_reference(packed, n, k, l, init, seed, max_steps, device,
                   setting=SETTING):
    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.dataset import GenotypeData
    from terastructure_tpu.svi import fit
    from terastructure_tpu.svi.init import spectral_gamma

    data = GenotypeData.from_packed(
        packed, n, validation_frac=setting["validation_frac"],
        heldout_frac=setting["heldout_frac"], seed=0,
        eval_snp_pool=setting["eval_snp_pool"])
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=setting["batch_size"],
                    rfreq=setting["rfreq"], max_steps=max_steps, seed=seed,
                    init=init)
    g0 = (np.asarray(spectral_gamma(packed, n, k, alpha=cfg.alpha_value,
                                    seed=seed, l_real=l))
          if init == "spectral" else None)
    t = time.time()
    res = fit(cfg, data)
    return g0, res, np.asarray(res.state.gamma), time.time() - t


def test_spectral_start_converges_as_the_references():
    from terastructure_tpu_torch.data.pack import pack2bit
    from terastructure_tpu_torch.data.simulate import simulate_psd

    theta, _, x = simulate_psd(200, 2000, 3, seed=4, structured=True)
    packed = pack2bit(np.ascontiguousarray(x.T))
    setting = dict(batch_size=128, rfreq=50, validation_frac=0.01,
                   heldout_frac=0.01, eval_snp_pool=0)
    ours = _fit_port(packed, 200, 3, 2000, "spectral", 0, 4000, "cpu",
                     setting)
    ref = _fit_reference(packed, 200, 3, 2000, "spectral", 0, 4000, "cpu",
                         setting)
    maes = []
    for g0, res, gamma, _ in (ours, ref):
        assert res.converged
        assert _theta_mae(g0, theta) < 0.15
        maes.append(_theta_mae(gamma, theta))
        assert maes[-1] < 0.05
    assert abs(maes[0] - maes[1]) < 0.01, maes
    assert abs(ours[1].steps - ref[1].steps) <= 0.3 * ref[1].steps, (
        ours[1].steps, ref[1].steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["port", "reference"],
                    required=True)
    ap.add_argument("--init", choices=["spectral", "random"], required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--l", type=int, default=50_000)
    ap.add_argument("--max-steps", type=int, default=20_000)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the reference runs on the CPU)")
    args = ap.parse_args(argv)
    if args.package == "reference" and args.device != "cpu":
        ap.error("the reference runs on the CPU only")

    import torch

    from terastructure_tpu_torch.data.simulate import simulate_packed_device

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    packed, theta = simulate_packed_device(N, args.l, K, seed=0,
                                           device=args.device)
    l = args.l
    run = _fit_port if args.package == "port" else _fit_reference
    for seed in args.seeds:
        g0, res, gamma, wall = run(packed, N, K, l, args.init, seed,
                                   args.max_steps, args.device)
        print(json.dumps(dict(
            package=args.package, device=args.device, init=args.init,
            seed=seed, l=args.l,
            steps=int(res.steps), converged=bool(res.converged),
            init_theta_mae=(None if g0 is None
                            else round(_theta_mae(g0, theta), 5)),
            theta_mae=round(_theta_mae(gamma, theta), 5),
            validation_ll=float(res.validation_ll),
            heldout_ll=(None if res.heldout_ll is None
                        else float(res.heldout_ll)),
            fit_s=round(wall, 1))), flush=True)


if __name__ == "__main__":
    main()
