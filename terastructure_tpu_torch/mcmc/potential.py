"""Unconstrained log-posterior for the PSD model, the MCMC target (port of
terastructure_tpu/mcmc/potential.py).

Parameterization:

  theta_i = g_i / sum(g_i),  g_ik = exp(z_theta_ik),
    with g_ik ~ Gamma(alpha, 1)  =>  theta_i ~ Dirichlet(alpha 1_K)
    log-density of z (log-gamma + Jacobian): alpha*z - exp(z) - lgamma(alpha)

  beta_jk = sigmoid(z_beta_jk),
    with beta ~ Beta(a, b); density x Jacobian gives
    a*log sigmoid(z) + b*log sigmoid(-z) - logBeta(a, b)

  x_ij ~ Binomial(2, theta_i^T beta_.j) on observed entries.

Everything is a function of the parameter dict {"z_theta": (..., N, K),
"z_beta": (..., L, K)}, where the leading axes, if any, are chains or
particles: every method returns one value per chain.

Two precision boundaries of the reference are explicit here:

- acc_dtype: the dtype of the energy sums. The reference widens them to
  float64 through JAX's global x64 flag (its `_acc_dtype`): at validator
  shapes (|log p| ~ 1e6) a float32 sum carries ~0.1-1 nat of rounding
  noise, which swamps the integrator's O(eps^2) error and freezes the
  chains. `mcmc.validate` passes torch.float64. Dynamics, gradients and
  the product theta beta^T stay float32.
- the likelihood's product theta beta^T runs in true float32, never TF32,
  whatever torch.backends.cuda.matmul allows (the reference pins
  Precision.HIGHEST: a reduced-precision product froze every chain on the
  TPU). It is elementwise products summed over K (`psd.f32_product`), which
  no matmul setting touches; K is small for the validators.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import numpy as np
import torch
import torch.nn.functional as F

from terastructure_tpu_torch.models.psd import MISSING, f32_product
from terastructure_tpu_torch.mcmc.hmc import as_generator
from terastructure_tpu_torch.mcmc.hmc import batched as _batched


class _Density(torch.autograd.Function):
    """w_prior * log_prior + w_lik * log_lik of a PSDPotential, one value
    per chain, as one autograd node whose backward is the closed-form
    gradient. The elementwise formula (`PSDPotential.plain`) is ~50
    autograd nodes, and a sampler pays their per-op cost on every
    leapfrog step; tests/test_torch_mcmc.py holds this node to the
    formula's autograd gradient and to the reference's jax.grad."""

    @staticmethod
    def forward(ctx, zt, zb, pot, w_prior, w_lik):
        grad = any(ctx.needs_input_grad[:2])
        g = torch.exp(zt)
        theta = g / torch.sum(g, dim=-1, keepdim=True)
        beta = torch.sigmoid(zb)
        val, dp = 0.0, None
        if w_prior:
            val = pot._prior_value(zt, zb, g)
        if w_lik:
            p = f32_product(theta, beta)                 # (..., N, L)
            lo, hi = torch.finfo(p.dtype).tiny, 1.0 - 1e-7
            pc = p.clamp(lo, hi)
            ll = pot._xm * torch.log(pc) + pot._xc * torch.log1p(-pc)
            if pot._mask is not None:
                ll = torch.where(pot._mask, ll, 0.0)
            lik = torch.sum(ll, dim=(-2, -1), dtype=pot.acc_dtype) \
                + pot._log_coeff
            term = lik if w_lik == 1.0 else w_lik * lik
            val = val + term if w_prior else term
            if grad:
                # d/dp of x log p + (2 - x) log(1 - p); zero where the
                # clamp holds p, or the entry is missing
                ok = (p >= lo) & (p <= hi)
                if pot._mask is not None:
                    ok = ok & pot._mask
                dp = torch.where(ok, pot._xm / pc - pot._xc / (1.0 - pc),
                                 0.0)
        ctx.pot, ctx.w_prior, ctx.w_lik = pot, w_prior, w_lik
        if grad:
            ctx.save_for_backward(zt, theta, beta, dp)
        return val

    @staticmethod
    def backward(ctx, gout):
        zt, theta, beta, dp = ctx.saved_tensors
        pot = ctx.pot
        go = gout.to(theta.dtype)[..., None, None]
        d_zt = torch.zeros_like(theta)
        d_zb = torch.zeros_like(beta)
        if ctx.w_lik:
            dpw = dp * (go * ctx.w_lik)
            g_theta = torch.sum(dpw[..., :, :, None] * beta[..., None, :, :],
                                dim=-2)                  # (..., N, K)
            g_beta = torch.sum(dpw[..., :, :, None] * theta[..., :, None, :],
                               dim=-3)                   # (..., L, K)
            # through theta = softmax(z_theta) and beta = sigmoid(z_beta)
            d_zt = theta * (g_theta - torch.sum(theta * g_theta, dim=-1,
                                                keepdim=True))
            d_zb = g_beta * beta * (1.0 - beta)
        if ctx.w_prior:
            t_prior, b_prior = pot._prior_grad(zt, theta, beta)
            d_zt = d_zt + go * t_prior
            d_zb = d_zb + go * b_prior
        return d_zt, d_zb, None, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class PSDPotential:
    """Callable log-posterior (up to a constant) and transforms.

    scale_sigma: the z_theta parameterization carries one unidentified
    direction per individual, the row scale w_i = log sum_k exp(z_ik),
    whose posterior equals its prior (the likelihood sees only theta).
    Setting scale_sigma replaces the scale's implied Gamma(K*alpha, 1)
    prior with log s_i ~ N(0, scale_sigma^2), pinning the nuisance
    without changing the theta/beta posterior; per row the prior becomes

        alpha * sum_k z_ik - K*alpha * w_i - w_i^2 / (2 sigma^2).

    None keeps the iid-Gamma prior (the exact Dirichlet-times-Gamma
    factorization). See the reference's docstring for the measurements
    that chose it.

    log_prior, log_lik, their sum (the call) and `tempered` are one
    autograd node each (`_Density`); `plain` is the elementwise formula.
    """

    x: torch.Tensor          # (N, L) int8 genotypes, MISSING allowed
    alpha: float
    beta_a: float = 1.0
    beta_b: float = 1.0
    scale_sigma: Optional[float] = None
    acc_dtype: torch.dtype = torch.float32
    batched: ClassVar[bool] = True

    def __post_init__(self):
        x = torch.as_tensor(self.x)
        mask = x != MISSING
        xm = torch.where(mask, x, 0).to(torch.float32)
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "_mask", None if bool(mask.all()) else mask)
        object.__setattr__(self, "_xm", xm)
        object.__setattr__(self, "_xc", 2.0 - xm)
        # sum of log C(2, x) over the observed entries: a constant
        object.__setattr__(self, "_log_coeff", math.log(2.0) * float(
            ((x == 1) & mask).sum()))

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def l(self):
        return self.x.shape[1]

    @property
    def mask(self):
        return self.x != MISSING

    def constrain(self, params):
        """Unconstrained params -> (theta (..., N, K), beta (..., L, K))."""
        g = torch.exp(params["z_theta"])
        theta = g / torch.sum(g, dim=-1, keepdim=True)
        beta = torch.sigmoid(params["z_beta"])
        return theta, beta

    def _prior_value(self, zt, zb, g):
        """log prior per chain; g = exp(zt)."""
        acc = self.acc_dtype
        if self.scale_sigma is not None:
            k = zt.shape[-1]
            w = torch.logsumexp(zt, dim=-1)
            lp_t = (self.alpha * torch.sum(zt, dim=(-2, -1), dtype=acc)
                    - k * self.alpha * torch.sum(w, dim=-1, dtype=acc)
                    - torch.sum(w * w, dim=-1, dtype=acc)
                    / (2.0 * self.scale_sigma**2))
        else:
            lp_t = torch.sum(self.alpha * zt - g - math.lgamma(self.alpha),
                             dim=(-2, -1), dtype=acc)
        lp_b = torch.sum(
            self.beta_a * F.logsigmoid(zb) + self.beta_b * F.logsigmoid(-zb),
            dim=(-2, -1), dtype=acc)
        return lp_t + lp_b

    def _prior_grad(self, zt, theta, beta):
        """d log prior / d (z_theta, z_beta)."""
        if self.scale_sigma is not None:
            k = zt.shape[-1]
            w = torch.logsumexp(zt, dim=-1, keepdim=True)
            # d w / d z_theta = theta
            d_zt = self.alpha + theta * (-k * self.alpha
                                         - w / self.scale_sigma**2)
        else:
            d_zt = self.alpha - torch.exp(zt)
        d_zb = self.beta_a * (1.0 - beta) - self.beta_b * beta
        return d_zt, d_zb

    def _density(self, params, w_prior, w_lik):
        return _Density.apply(params["z_theta"], params["z_beta"], self,
                              w_prior, w_lik)

    @_batched
    def log_prior(self, params):
        return self._density(params, 1.0, 0.0)

    @_batched
    def log_lik(self, params):
        return self._density(params, 0.0, 1.0)

    def __call__(self, params):
        return self._density(params, 1.0, 1.0)

    def tempered(self, temp):
        """log_prior + temp * log_lik, for SMC likelihood tempering."""

        @_batched
        def f(params):
            return self._density(params, 1.0, float(temp))

        return f

    def plain(self, params, *, prior=True, lik=True, product=f32_product):
        """The same log-density as the elementwise formula, for autograd to
        differentiate op by op: the one-node density's plain twin. product
        computes theta beta^T (a TF32 matmul, say, to measure what
        f32_product avoids)."""
        zt, zb = params["z_theta"], params["z_beta"]
        theta, beta = self.constrain(params)
        val = 0.0
        if prior:
            val = self._prior_value(zt, zb, torch.exp(zt))
        if lik:
            p = product(theta, beta)
            p = p.clamp(torch.finfo(p.dtype).tiny, 1.0 - 1e-7)
            ll = self._xm * torch.log(p) + self._xc * torch.log1p(-p)
            if self._mask is not None:
                ll = torch.where(self._mask, ll, 0.0)
            val = val + torch.sum(ll, dim=(-2, -1), dtype=self.acc_dtype) \
                + self._log_coeff
        return val


def init_params(pot: PSDPotential, key, k: int, n_chains: int = 0):
    """Unconstrained init: z_theta ~ N(0, 0.1), z_beta ~ N(0, 0.5).

    key: an int seed or a torch.Generator on the potential's device."""
    dev = pot.x.device
    g = as_generator(key, dev)
    lead = (n_chains,) if n_chains else ()
    zt = 0.1 * torch.randn(lead + (pot.n, k), generator=g, device=dev)
    if pot.scale_sigma is not None:
        # start each row on the pinned shell (w = 0)
        zt = zt - torch.logsumexp(zt, dim=-1, keepdim=True)
    zb = 0.5 * torch.randn(lead + (pot.l, k), generator=g, device=dev)
    return {"z_theta": zt, "z_beta": zb}


def q_z_moments(gamma, lamb, *, scale_sigma=None, k_alpha=None,
                device=None):
    """Mean and variance of the unconstrained z under the fitted
    variational posterior q(theta) = Dir(gamma), q(beta) = Beta(lamb).

    Closed forms (all exact):
      z_theta_k = w + log theta_k with w independent of theta:
        E[log theta_k]  = psi(gamma_k) - psi(gamma_0)
        Var[log theta_k] = psi1(gamma_k) - psi1(gamma_0)
        w ~ N(0, scale_sigma^2) under the pinned prior, or
        w = log Gamma(K alpha, 1) (mean psi(Ka), var psi1(Ka)).
      z_beta = logit(beta) = log G(a) - log G(b) for independent gammas:
        E = psi(a) - psi(b),  Var = psi1(a) + psi1(b).

    gamma: (N, K); lamb: (L, K, 2), arrays or tensors. Returns ({mean},
    {var}) as float32 tensors on `device` (default: gamma's, or the CPU).
    """
    from scipy.special import digamma as psi, polygamma

    if device is None:
        device = gamma.device if isinstance(gamma, torch.Tensor) else "cpu"
    psi1 = lambda a: polygamma(1, a)
    g = _host64(gamma)
    lam = _host64(lamb)
    g0 = g.sum(-1, keepdims=True)
    mu_t = psi(g) - psi(g0)
    v_t = psi1(g) - psi1(g0)
    if scale_sigma is not None:
        v_t = v_t + scale_sigma**2
    else:
        if k_alpha is None:
            raise ValueError("legacy scale needs k_alpha = K * alpha")
        mu_t = mu_t + psi(k_alpha)
        v_t = v_t + psi1(k_alpha)
    a, b = lam[..., 0], lam[..., 1]

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return ({"z_theta": t(mu_t), "z_beta": t(psi(a) - psi(b))},
            {"z_theta": t(v_t), "z_beta": t(psi1(a) + psi1(b))})


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def svi_informed_inits(gamma, lamb, key, *, n_chains=0, overdisperse=2.0,
                       scale_sigma=None, k_alpha=None, device=None):
    """Chain initializations drawn from the (overdispersed) fitted
    variational posterior, plus a diagonal mass preconditioner.

    Chains start inside the posterior's typical set, and the initial
    inverse mass is q's z-space variance. Only efficiency is affected:
    inits are overdispersed (q-draws scaled by `overdisperse` around the
    q-mean) so split R-hat keeps its power to flag SVI-vs-posterior
    disagreement. key: an int seed or a numpy Generator (the q draws are
    made on the host).

    Returns (params0 with a leading chain axis iff n_chains > 1, inv_mass
    dict without a chain axis), float32 tensors on `device`.
    """
    mean, var = q_z_moments(gamma, lamb, scale_sigma=scale_sigma,
                            k_alpha=k_alpha, device=device)
    rng = key if isinstance(key, np.random.Generator) \
        else np.random.default_rng(key)
    n_draws = max(n_chains, 1)
    gam = _host64(gamma)
    lam = _host64(lamb)
    # exact q draws in z-space: theta ~ Dir(gamma) via normalized gammas;
    # w from the scale prior; logit-beta via two gammas
    log_gt = np.log(rng.standard_gamma(gam, (n_draws,) + gam.shape))
    log_theta = log_gt - logsumexp_last(log_gt)
    if scale_sigma is not None:
        w = scale_sigma * rng.standard_normal((n_draws,) + gam.shape[:-1])
    else:
        w = np.log(rng.standard_gamma(float(k_alpha),
                                      (n_draws,) + gam.shape[:-1]))
    zt = log_theta + w[..., None]
    ga = rng.standard_gamma(lam[..., 0], (n_draws,) + lam.shape[:-1])
    gb = rng.standard_gamma(lam[..., 1], (n_draws,) + lam.shape[:-1])
    zb = np.log(ga) - np.log(gb)
    dev = mean["z_theta"].device
    c = float(overdisperse)
    params0 = {}
    for name, d in (("z_theta", zt), ("z_beta", zb)):
        d = torch.as_tensor(d.astype(np.float32), device=dev)
        m = mean[name][None]
        params0[name] = (m + c * (d - m)).to(torch.float32)
    if not n_chains:
        params0 = {k_: v[0] for k_, v in params0.items()}
    return params0, var


def logsumexp_last(a: np.ndarray) -> np.ndarray:
    """log sum exp over the last axis, kept (numpy; scipy's version
    dispatches on the array API and fails where `jax` is blocked)."""
    m = a.max(-1, keepdims=True)
    return m + np.log(np.exp(a - m).sum(-1, keepdims=True))
