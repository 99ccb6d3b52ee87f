"""PSD/admixture model math in torch (port of terastructure_tpu/models/psd.py).

Model: theta_i ~ Dir(alpha), beta_kj ~ Beta(a, b),
x_ij ~ Binomial(2, theta_i^T beta_.j). Variational family
q(theta_i) = Dir(gamma_i), gamma (N, K); q(beta_kj) = Beta(lamb_jk0,
lamb_jk1), lamb (L, K, 2) with lamb[..., 0] counting allele 1.

Digammas are `torch.special.digamma`. The priors and the full-data
log-likelihood at the end serve the MCMC validators (mcmc/) and tests.
"""

from __future__ import annotations

import math

import torch

# Genotype codes in the 2-bit packed representation (data/pack.py).
# 0, 1, 2 = minor-allele counts; 3 = missing or held-out entry.
MISSING = 3


def elog_dirichlet(gamma: torch.Tensor) -> torch.Tensor:
    """E_q[log theta] for Dirichlet(gamma). gamma: (..., K) -> (..., K)."""
    return (torch.special.digamma(gamma)
            - torch.special.digamma(gamma.sum(-1, keepdim=True)))


def elog_beta(lamb: torch.Tensor):
    """E_q[log beta], E_q[log(1-beta)] for Beta(lamb0, lamb1).

    lamb: (..., 2) -> two tensors of shape lamb.shape[:-1].
    """
    total = torch.special.digamma(lamb[..., 0] + lamb[..., 1])
    return (torch.special.digamma(lamb[..., 0]) - total,
            torch.special.digamma(lamb[..., 1]) - total)


def theta_mean(gamma: torch.Tensor) -> torch.Tensor:
    """Point estimate theta_hat = gamma / sum(gamma)."""
    return gamma / gamma.sum(-1, keepdim=True)


def beta_mean(lamb: torch.Tensor) -> torch.Tensor:
    """Point estimate beta_hat = lamb0 / (lamb0 + lamb1). (..., 2) -> (...)."""
    return lamb[..., 0] / (lamb[..., 0] + lamb[..., 1])


def binomial2_loglik(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """log Binomial(2, p) pmf at x in {0,1,2}, elementwise (plug-in
    predictive for validation and heldout scoring)."""
    x = x.to(p.dtype)
    eps = torch.finfo(p.dtype).tiny
    p = p.clamp(eps, 1.0 - 1e-7)
    log_coeff = torch.where(x == 1.0, math.log(2.0), 0.0).to(p.dtype)
    return log_coeff + x * torch.log(p) + (2.0 - x) * torch.log1p(-p)


def variational_predictive_probs(gamma_e: torch.Tensor, lamb_e: torch.Tensor):
    """Closed-form E_q[Binom(2, s)], s = theta^T beta, from the first two
    moments of s under q (see the reference for the derivation).

    gamma_e: (..., K); lamb_e: (..., K, 2). Returns (p0, p1, p2), each (...,).
    """
    g0 = gamma_e.sum(-1)
    l0, l1 = lamb_e[..., 0], lamb_e[..., 1]
    eb = l0 / (l0 + l1)
    eb2 = l0 * (l0 + 1.0) / ((l0 + l1) * (l0 + l1 + 1.0))
    es = (gamma_e * eb).sum(-1) / g0
    denom = g0 * (g0 + 1.0)
    cross = ((gamma_e * eb).sum(-1) ** 2
             - (gamma_e ** 2 * eb ** 2).sum(-1)) / denom
    diag = (gamma_e * (gamma_e + 1.0) * eb2).sum(-1) / denom
    es2 = cross + diag
    return 1.0 - 2.0 * es + es2, 2.0 * (es - es2), es2


def variational_predictive_loglik(gamma_e, lamb_e, x):
    """log p(x) under the variational predictive. gamma_e (M, K),
    lamb_e (M, K, 2), x (M,) in {0,1,2} -> (M,)."""
    probs = torch.stack(variational_predictive_probs(gamma_e, lamb_e), -1)
    probs = probs.clamp(torch.finfo(probs.dtype).tiny, 1.0)
    return torch.log(probs.gather(-1, x.long()[..., None])[..., 0])


def predictive_loglik(gamma, lamb, ind_idx, snp_idx, x, form="plugin"):
    """Per-entry predictive log-likelihood for entries (ind_idx, snp_idx).

    form: "plugin" (Binom(2, E[theta]^T E[beta])) or "variational".
    """
    if form == "variational":
        return variational_predictive_loglik(gamma[ind_idx], lamb[snp_idx], x)
    th = theta_mean(gamma[ind_idx])
    be = beta_mean(lamb[snp_idx])
    return binomial2_loglik(x, (th * be).sum(-1))


def f32_product(theta: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """theta @ beta^T over the last axis in the inputs' dtype, with no
    tensor-core or TF32 path: (..., N, K), (..., L, K) -> (..., N, L). The
    reference runs this product at Precision.HIGHEST."""
    return torch.sum(theta[..., :, None, :] * beta[..., None, :, :], dim=-1)


def log_dirichlet_prior(theta, alpha):
    """log Dir(theta | alpha * 1_K), theta: (..., K) on the simplex."""
    k = theta.shape[-1]
    log_norm = math.lgamma(k * alpha) - k * math.lgamma(alpha)
    return log_norm + torch.sum((alpha - 1.0) * torch.log(theta), dim=-1)


def log_beta_prior(beta, a, b):
    """log Beta(beta | a, b) elementwise."""
    log_norm = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    return (log_norm + (a - 1.0) * torch.log(beta)
            + (b - 1.0) * torch.log1p(-beta))


def data_loglik(theta, beta, x, mask=None):
    """Full-data log-likelihood sum log Binomial(2, theta^T beta) at x.

    theta: (N, K); beta: (L, K); x: (N, L) int in {0,1,2} with MISSING=3
    allowed when mask is given (or derived).
    """
    p = f32_product(theta, beta)                 # (N, L)
    if mask is None:
        mask = x != MISSING
    ll = binomial2_loglik(torch.where(mask, x, 0), p)
    return torch.sum(torch.where(mask, ll, 0.0))
