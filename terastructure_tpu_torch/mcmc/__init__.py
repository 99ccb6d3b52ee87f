"""MCMC validators of the SVI posterior (port of terastructure_tpu/mcmc/):
NUTS, HMC, ChEES-HMC and tempered SMC on the PSD model's log-posterior,
and `validate.compare_svi_mcmc`, which fits SVI and a sampler on one
genotype matrix and compares their moments."""

from terastructure_tpu_torch.mcmc.potential import PSDPotential  # noqa: F401
from terastructure_tpu_torch.mcmc.hmc import run_hmc  # noqa: F401
from terastructure_tpu_torch.mcmc.nuts import run_nuts  # noqa: F401
from terastructure_tpu_torch.mcmc.chees import run_chees  # noqa: F401
from terastructure_tpu_torch.mcmc.smc import run_smc  # noqa: F401
