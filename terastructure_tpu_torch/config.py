"""Run configuration: the port's copy of the reference's `SVIConfig`
(terastructure_tpu/config.py).

A copy and not an import, because the port imports nothing of the JAX
package, not even its modules that do not import JAX: the machine that
runs the port has no JAX. The fields, defaults, validation and helpers
are the reference's, so a config serialized by one package loads in the
other (tests/test_torch_config.py holds the two together). The field
notes below say what each option does in the port; the reference's copy
keeps the measurements on the TPU that chose its defaults.

Options the port does not run yet raise `NotImplementedError` where they
would take effect (svi/engine.py, svi/driver.py). The dataclass is
frozen and hashable, like the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SVIConfig:
    """Hyperparameters and run options for SVI on the PSD model.

    Symmetric Dirichlet prior ``alpha = 1/K``, uniform Beta(1,1) prior on
    allele frequencies, Robbins-Monro step size
    ``rho_t = (tau0 + t)^-kappa``.
    """

    n: int = 0                  # individuals
    l: int = 0                  # SNPs (loci)
    k: int = 3                  # ancestral populations

    # Priors.
    alpha: Optional[float] = None   # None -> 1/K
    beta_a: float = 1.0             # Beta prior on allele freqs
    beta_b: float = 1.0

    # Robbins-Monro step-size schedule.
    tau0: float = 1.0
    kappa: float = 0.5

    # Minibatch of SNPs per iteration.
    batch_size: int = 64

    # SNP-group sampling granularity: the minibatch is drawn as
    # batch_size/snp_group uniform groups of snp_group consecutive SNPs.
    # Group draws keep the gamma natural-gradient estimate unbiased
    # (every SNP equally likely; scale L/B unchanged). 1 (default) draws
    # SNPs independently. Groups engage only at L > 65536 with L and
    # batch_size multiples of snp_group. In the fused branch a group of
    # >= 8 (a multiple of 8) selects the group-addressed solve (kernel
    # K2, ops/fused_step.fused_local_solve_dma); in the big-N and dense
    # branches it shapes the stored-lambda mode's gather.
    snp_group: int = 1

    # Local coordinate-ascent (phi <-> lambda) iterations per minibatch.
    # Default 7 pairs with local_accel (5 loop passes + 2 feeding the
    # extrapolation); 16 with local_accel=False is the plain schedule.
    local_iters: int = 7
    local_tol: float = 1e-4     # mean |delta lambda| early-exit threshold

    # Aitken-accelerated local solve: one clamped per-coordinate Aitken
    # delta^2 extrapolation after the last coordinate-ascent pass
    # (ops/stats_dense.aitken_final).
    local_accel: bool = True

    # Big-N inner-loop subsampling: run the lambda coordinate-ascent
    # iterations on a per-step random byte-aligned subsample of this many
    # individuals (N/Ns-scaled statistics), then one exact full-N pass
    # for the final lambda and gamma statistics. 0 disables; active only
    # when the padded N is at least 4x this value.
    local_sub_n: int = 8192

    # With local_sub_n active: one exact full-N refinement sweep between
    # the subsampled solve and the final statistics pass.
    local_refine_full: bool = False

    # With local_sub_n active: decode the subsample's allele counts once
    # per step into (B, 4, W_sub) bf16 planes (exact: counts are
    # {0, 1, 2}) and iterate over them (kernel K8) instead of unpacking
    # the 2-bit rows every pass (kernel K4).
    sub_decode_once: bool = True

    # With local_sub_n active: the subsampled iterations divide with the
    # fast approximate divide; the exact full-N passes never do.
    local_sub_approx_div: bool = True

    # Which kernel computes the exact full-N statistics pass of the
    # big-N step (engine.step_core_packed):
    #   "pair"     - the lambda pass (K4) and the gamma pass (K5);
    #   "fused"    - one pass (K6, v1): K7's kernel at the exact divide;
    #   "fused_v2" - one pass, lambda as per-column-tile partials (K7).
    stats_kernel: str = "fused_v2"

    # Compute the exact statistics pass's divides with the fast divide
    # too. Unlike local_sub_approx_div this perturbs the final lambda and
    # gamma statistics (~2^-12 relative); off unless a quality A/B at the
    # configuration shows the change is below Monte-Carlo error.
    stats_approx_div: bool = False

    # At L >= dma_gather_min_l (with L % 8 == 0 and batch_size % 128 ==
    # 0) draw the minibatch as batch_size/8 uniform blocks of 8
    # consecutive SNPs and copy them with the row-block gather (kernel
    # K3); unbiased for the gamma estimate, as snp_group. Elsewhere
    # independent per-row draws and a plain index gather.
    dma_gather: bool = True
    # Smallest L the block gather engages at.
    dma_gather_min_l: int = 65537

    # Heldout/validation entry fractions.
    validation_frac: float = 0.005
    heldout_frac: float = 0.005

    # Heldout predictive form: "plugin" = Binom(2, E[theta]^T E[beta]);
    # "variational" = E_q[Binom(2, s)] in closed form (models/psd.py).
    predictive: str = "plugin"

    # Convergence assessment.
    rfreq: int = 100            # validation log-lik every rfreq iterations
    max_steps: int = 10_000
    conv_tol: float = 1e-5      # relative validation-ll improvement floor
    conv_patience: int = 3      # consecutive non-improving checks to stop

    # Numerics of the hot loop's products: "float32", or "bfloat16" (their
    # operands rounded to bf16, sums in f32; every kernel of every path).
    compute_dtype: str = "float32"

    # Hot-loop implementation: "fused" (the whole local solve in one
    # kernel sequence, K1 or K2), "pallas" (the big-N per-iteration
    # kernels, engine.step_core_packed), "dense" (plain torch matmuls over
    # the unpacked minibatch), or "auto" (fused where its shape gate
    # passes, else the big-N path).
    kernel: str = "auto"

    # Lambda handling. "local" (default): lambda is the local variable it
    # is; each minibatch's coordinate ascent cold-starts from the Beta
    # prior, nothing is gathered from or scattered into the (L, K, 2)
    # array while stepping, and validation/export lambdas are re-solved
    # from the current gamma. "stored": warm-start from and scatter back
    # into the stored lambda array every step; the scorer reads it.
    lambda_mode: str = "local"

    # Init scale for gamma.
    gamma_init_scale: float = 0.1

    # gamma initialization: "random", or "spectral" (svi/init.py: the
    # randomized-PCA + soft k-means warm start).
    init: str = "random"

    seed: int = 0
    label: str = "run"

    # Sharding: mesh axis sizes; 0 = auto (multi-GPU, not ported yet).
    ind_shards: int = 0
    snp_shards: int = 0

    # Software-pipeline the sharded chunk runner (multi-GPU, not ported
    # yet).
    comm_overlap: bool = True

    # Precision of the gamma natural-gradient statistic where it would
    # cross the sharded reduction: "f32", or "bf16" (rounded to bf16 and
    # back once, the single-device mirror of the sharded bf16 reduction).
    gamma_psum_dtype: str = "f32"

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.gamma_psum_dtype not in ("f32", "bf16"):
            raise ValueError("gamma_psum_dtype must be 'f32' or 'bf16', "
                             f"got {self.gamma_psum_dtype!r}")

    @property
    def alpha_value(self) -> float:
        return (1.0 / self.k) if self.alpha is None else self.alpha

    def rho(self, t):
        """Robbins-Monro step size at iteration t."""
        return (self.tau0 + t) ** (-self.kappa)

    # ---- run-dir convention: n{N}-k{K}-l{L}-{label}/
    def run_dir_name(self) -> str:
        return f"n{self.n}-k{self.k}-l{self.l}-{self.label}"

    def make_run_dir(self, base: str = ".") -> str:
        path = os.path.join(base, self.run_dir_name())
        os.makedirs(path, exist_ok=True)
        return path

    # ---- (de)serialization for checkpoints / CLI round-trips
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SVIConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "SVIConfig":
        return dataclasses.replace(self, **kw)
