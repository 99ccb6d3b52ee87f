"""The port and chip_smoke.py import and run with jax and the JAX package
blocked: the machine with the card has no JAX, and the port keeps its own
copies of what it needs (config, label alignment, the .bed ingest and its
native core, whose library is the port's own, never the reference's
_bedops.so), a small batched replicate fit, and the command line's
simulate and fit (spectral init, text model, checkpoint), and a tiny
NUTS validation (compare_svi_mcmc), and the multi-card fit's modules
(parallel/: a world of one rank, resident and streamed, and the sharded
compute-beta). `fit` without a device runs on the card, and raises where
there is none."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.modules["terastructure_tpu"] = None      # and any import of the reference
import numpy as np
import chip_smoke
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.svi import fit
_, _, x = simulate_psd(32, 128, 2, seed=1)
data = GenotypeData.from_dense(x, validation_frac=0.02, heldout_frac=0.02,
                               seed=1)
res = fit(SVIConfig(n=32, l=128, k=2, batch_size=16, rfreq=20, max_steps=40,
                    seed=1), data, device="cpu")
assert res.steps == 40 and np.isfinite(res.heldout_ll), res
# batched replicates
from terastructure_tpu_torch.svi.replicates import fit_replicates_batched
rep = fit_replicates_batched(SVIConfig(n=32, l=128, k=2, batch_size=16,
                                       rfreq=20, max_steps=40, seed=1),
                             data, [1, 2], device="cpu")
assert rep.replicates[0].steps == 40 and rep.states.gamma.shape == (2, 32, 2)
assert all(np.isfinite(r.heldout_ll) for r in rep.replicates), rep
# the streamed fit, its .bed ingest and the native core it builds
import tempfile
from terastructure_tpu_torch import native
from terastructure_tpu_torch.data import bed
from terastructure_tpu_torch.svi import stream
with tempfile.TemporaryDirectory() as tmp:
    bed.write_bed(tmp + "/d.bed", data.packed, 32)
    bed.write_fam(tmp + "/d.fam", range(32))
    bed.write_bim(tmp + "/d.bim", range(128))
    cache, _, _ = bed.bed_to_packed_cache(tmp + "/d.bed", tmp + "/c.npy")
    res = fit(SVIConfig(n=32, l=128, k=2, batch_size=16, rfreq=20,
                        max_steps=40, seed=1),
              GenotypeData.from_packed(cache, 32, validation_frac=0.02,
                                       heldout_frac=0.02, seed=1),
              device="cpu", stream=True)
    assert res.steps == 40 and np.isfinite(res.heldout_ll), res
# the command line, the text model, the checkpoint and the spectral init
from terastructure_tpu_torch import cli, viz  # noqa: F401
from terastructure_tpu_torch.io import checkpoint, export  # noqa: F401
from terastructure_tpu_torch.svi import init  # noqa: F401
from terastructure_tpu_torch.utils import profiling  # noqa: F401
with tempfile.TemporaryDirectory() as tmp:
    cli.main(["simulate", "-n", "32", "-l", "128", "-k", "2", "-o",
              tmp + "/s"])
    cli.main(["fit", "--bed", tmp + "/s.bed", "-k", "2", "--batch-size",
              "16", "--rfreq", "20", "--max-steps", "40", "--init-mode",
              "spectral", "--out-base", tmp, "--force-cpu"])
    g, _ = export.load_model(tmp + "/n32-k2-l128-run")
    st, _ = checkpoint.restore_checkpoint(tmp + "/n32-k2-l128-run/checkpoint")
    assert st.t == 40 and g.shape == (32, 2), (st.t, g.shape)
# the MCMC validator: SVI, then NUTS on the same matrix
from terastructure_tpu_torch.mcmc.validate import compare_svi_mcmc
rep = compare_svi_mcmc(x[:, :64], 2, sampler="nuts", seed=1, device="cpu",
                       svi_config=SVIConfig(n=32, l=64, k=2, batch_size=16,
                                            rfreq=20, max_steps=40, seed=1),
                       n_samples=10, n_warmup=10, n_chains=2, max_depth=4)
assert np.isfinite(rep.theta_mae) and rep.theta_mcmc.shape == (32, 2), rep
# the multi-card fit (parallel/): a world of one rank on the CPU, the
# sharded compute-beta, and the sharded stream
from terastructure_tpu_torch.parallel import (fit_sharded, make_mesh,  # noqa
                                              mesh, multihost, sharded,
                                              stream as pstream)
cfg = SVIConfig(n=32, l=128, k=2, batch_size=16, rfreq=20, max_steps=40,
                seed=1, snp_shards=1)
m = make_mesh(mesh.MeshSpec(1, 1), device="cpu")
res = fit_sharded(cfg, data, mesh=m)
assert res.steps == 40 and np.isfinite(res.heldout_ll), res
res_s = fit_sharded(cfg, data, mesh=m, stream=True)
assert (res_s.state.gamma == res.state.gamma).all()
plan, packed = sharded.prepare(cfg, data, m)
lamb = sharded.make_sharded_compute_lambda(cfg, plan, m)(res.state.gamma,
                                                        packed)
assert lamb.shape == (128, 2, 2) and bool(lamb.isfinite().all())
maps = open("/proc/self/maps").read()
assert "libbedops_" in maps and "_bedops.so" not in maps
assert not {"jax", "terastructure_tpu"} & {
    m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
sys.exit(chip_smoke.main())        # no CUDA card here: must refuse
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_no_jax_import_statement_in_the_port():
    files = sorted(p for p in (ROOT / "terastructure_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts)      # build outputs
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "terastructure_tpu"), (
                    path, name)


def test_fit_without_device_raises_without_a_card():
    """No device named means the first CUDA card; here there is none."""
    import numpy as np
    import pytest
    import torch

    from terastructure_tpu_torch import SVIConfig
    from terastructure_tpu_torch.data import GenotypeData
    from terastructure_tpu_torch.svi import fit

    assert not torch.cuda.is_available()
    x = np.random.default_rng(0).integers(0, 3, (64, 16)).astype(np.int8)
    data = GenotypeData.from_dense(x, validation_frac=0.05,
                                   heldout_frac=0.05, seed=0)
    cfg = SVIConfig(n=64, l=16, k=2, batch_size=8, max_steps=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(cfg, data)
