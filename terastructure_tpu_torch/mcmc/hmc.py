"""Hamiltonian Monte Carlo with warmup adaptation (port of
terastructure_tpu/mcmc/hmc.py), and the pieces the other samplers share.

Chains are a leading axis of every tensor: positions, momenta and
gradients are flat (C, dim) float32 tensors, one row a chain, in the
order of the parameter dict's sorted keys (the order of the reference's
`ravel_pytree`). `Target` turns a log-density on a parameter dict into
one on those rows, with its gradient from `torch.autograd`: directly
where the log-density takes the chain axis itself (`batched`, as
`potential.PSDPotential` does) or there is one chain, else under
`torch.func.vmap`. It evaluates at most `Target.CHUNK` chains at a time,
so a large particle cloud never holds more than a chunk's intermediates
(each chain's sum is its own, so the chunk changes no bit).

Random draws come from a draw source (`TorchDraws`, one
`torch.Generator` for all chains) that the kernels call in the
reference's order; a test hands in a source that replays the reference's
draws. Warmup adapts a per-parameter diagonal mass matrix (Welford) and
the step size (dual averaging in float64, Nesterov/Hoffman-Gelman
constants). The reference runs its transitions as bounded device programs
(`_chunk_runner`); here the transitions are a host loop and
`dispatch_chunk` only sets how many of them run between the copies of the
samples to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# log-densities on flat chain rows


def batched(fn):
    """Mark `fn` as taking a parameter dict with a leading chain axis and
    returning one log-density per chain."""
    fn.batched = True
    return fn


def is_batched(fn) -> bool:
    return bool(getattr(fn, "batched", False))


def as_batched(fn):
    """`fn` itself where it is batched, else `fn` under torch.func.vmap."""
    if is_batched(fn):
        return fn
    return batched(torch.func.vmap(fn))


class Target:
    """A log-density on flat (C, dim) positions.

    log_prob takes a dict of tensors; template is one chain's dict (no
    chain axis), which fixes the keys, shapes and the flat layout."""

    CHUNK = 64      # chains a log-density evaluation and its gradient take

    def __init__(self, log_prob: Callable, template: dict):
        self.keys = sorted(template)
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        sizes = [math.prod(s) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        self.dim = self.offsets[-1]
        self.log_prob = log_prob
        self.vmapped = as_batched(log_prob)

    def fn(self, q: torch.Tensor) -> torch.Tensor:
        """log p of each row of q (C, dim) -> (C,): one call for a batched
        log-density, and for one row of any other (vmap costs several
        times the call itself at small sizes)."""
        if q.shape[0] == 1 and not is_batched(self.log_prob):
            return self.log_prob(self.unflat(q[0]))[None]
        return self.vmapped(self.unflat(q))

    def flat(self, params: dict) -> torch.Tensor:
        """dict with a leading chain axis -> (C, dim)."""
        lead = params[self.keys[0]].shape[:-len(self.shapes[0]) or None]
        return torch.cat([params[k].reshape(lead + (-1,)) for k in self.keys],
                         dim=-1)

    def unflat(self, q: torch.Tensor) -> dict:
        """(..., dim) -> dict of views shaped (..., *shape)."""
        lead = tuple(q.shape[:-1])
        return {k: q[..., a:b].reshape(lead + s) for k, s, a, b in zip(
            self.keys, self.shapes, self.offsets[:-1], self.offsets[1:])}

    def value(self, q: torch.Tensor) -> torch.Tensor:
        """log p at each row of q (C, dim) -> (C,)."""
        with torch.no_grad():
            return torch.cat([self.fn(q[s:s + self.CHUNK])
                              for s in range(0, q.shape[0], self.CHUNK)])

    def value_and_grad(self, q: torch.Tensor):
        """(log p (C,), its gradient (C, dim)) at each row of q."""
        lps, grads = [], []
        for s in range(0, q.shape[0], self.CHUNK):
            qc = q[s:s + self.CHUNK].detach().requires_grad_(True)
            with torch.enable_grad():
                lp = self.fn(qc)
                (g,) = torch.autograd.grad(lp.sum(), qc)
            lps.append(lp.detach())
            grads.append(g)
        return torch.cat(lps), torch.cat(grads)


# --------------------------------------------------------------------------
# draws


def as_generator(key, device) -> torch.Generator:
    """A torch.Generator on `device`: `key` itself, or one seeded with it."""
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(key))
    return g


class TorchDraws:
    """The samplers' random draws, all from one torch.Generator. The
    kernels ask for them by role, in the reference's order, so a source
    that replays another generator's draws can stand in for this one."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.calls = 0          # the generator's calls (lockstep checks)

    def normal(self, shape, dtype, device):
        self.calls += 1
        return torch.randn(shape, generator=self.gen, dtype=dtype,
                           device=device)

    def uniform(self, shape, dtype, device):
        self.calls += 1
        return torch.rand(shape, generator=self.gen, dtype=dtype,
                          device=device)

    # HMC: momentum noise, then the accept uniform
    def momentum(self, shape, dtype, device):
        return self.normal(shape, dtype, device)

    def accept_uniform(self, shape, dtype, device):
        return self.uniform(shape, dtype, device)

    # NUTS: momentum; each doubling its direction, its leaves' uniforms,
    # its merge uniform
    def direction(self, shape, device):
        """True: integrate forward."""
        return self.uniform(shape, torch.float32, device) < 0.5

    def leaf_uniform(self, shape, dtype, device):
        return self.uniform(shape, dtype, device)

    def merge_uniform(self, shape, dtype, device):
        return self.uniform(shape, dtype, device)


# --------------------------------------------------------------------------
# dual averaging and Welford's mass


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(eps0):
    """eps0: a tensor (one per chain) or a number; the state is float64."""
    eps0 = torch.as_tensor(eps0, dtype=torch.float64)
    zero = torch.zeros_like(eps0)
    return DualAveragingState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        h_avg=zero,
        mu=torch.log(10.0 * eps0),
        count=zero,
    )


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_eps = state.mu - torch.sqrt(count) / gamma * h_avg
    w = count ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, state.mu, count)


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(q):
    return WelfordState(mean=torch.zeros_like(q), m2=torch.zeros_like(q),
                        count=torch.zeros((), dtype=torch.float32,
                                          device=q.device))


def welford_update(state: WelfordState, q):
    count = state.count + 1.0
    delta = q - state.mean
    mean = state.mean + delta / count
    delta2 = q - mean
    m2 = state.m2 + delta * delta2
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, regularize=True, prior=None):
    """Sample variance, shrunk toward `prior` (Stan-style; Stan's fixed
    target is 1e-3, the default)."""
    v = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
    if regularize:
        w = state.count / (state.count + 5.0)
        pv = 1e-3 if prior is None else prior
        v = w * v + (1.0 - w) * pv
    return torch.clamp(v, min=1e-8)


# --------------------------------------------------------------------------
# the HMC transition


class StepGraph:
    """fn() on static buffers: called as it is on the CPU; on a card
    captured once as a CUDA graph and replayed, so that the host enqueues
    one graph a step in place of the step's ~100 ops (each a few tens of
    microseconds of host time, which bound a sampler's step at validator
    shapes). fn must read and write only tensors that outlive it, in
    place; the capture's two warm-up calls run fn on whatever the buffers
    hold, so the caller fills them after constructing this."""

    def __init__(self, fn, device):
        self.fn = fn
        self.graph = None
        device = torch.device(device)
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    fn()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                fn()

    def __call__(self):
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()


def kinetic(p, inv_mass, dtype=None):
    """0.5 p^T M^-1 p per chain, summed in `dtype` (default p's)."""
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1, dtype=dtype)


class Leapfrog:
    """One leapfrog step for every chain on static buffers q, p, g (C,
    dim) and lp (C,): e is the step size (C, 1), inv_mass (C, dim). A
    chain steps while its count `left` (C,) is positive, and each of its
    steps takes one from it; the others pass through unchanged. Load the
    buffers, call the step up to max(left) times, read them."""

    def __init__(self, target: Target, q, lp):
        self.target = target
        self.q, self.p, self.g = (torch.zeros_like(q) for _ in range(3))
        self.lp = torch.zeros_like(lp)
        self.e = torch.zeros((q.shape[0], 1), dtype=q.dtype, device=q.device)
        self.inv_mass = torch.ones_like(q)
        self.left = torch.zeros(q.shape[0], dtype=torch.int64,
                                device=q.device)
        self.step = StepGraph(self._step, q.device)

    def load(self, q, p, g, lp, e, inv_mass, steps):
        """Fill the buffers; e: a number or (C, 1); inv_mass: (dim,) or
        (C, dim); steps: a number or (C,)."""
        for buf, val in ((self.q, q), (self.p, p), (self.g, g),
                         (self.lp, lp), (self.e, e),
                         (self.inv_mass, inv_mass), (self.left, steps)):
            buf.copy_(torch.as_tensor(val, device=buf.device).expand(
                buf.shape))

    def _step(self):
        live = self.left > 0
        m = live[:, None]
        p = self.p + 0.5 * self.e * self.g
        q = self.q + self.e * self.inv_mass * p
        lp, g = self.target.value_and_grad(q)
        self.p.copy_(torch.where(m, p + 0.5 * self.e * g, self.p))
        self.q.copy_(torch.where(m, q, self.q))
        self.lp.copy_(torch.where(live, lp, self.lp))
        self.g.copy_(torch.where(m, g, self.g))
        self.left.sub_(live.long())


def hmc_kernel(target: Target, n_leapfrog: int):
    """One HMC proposal + MH step for every chain.

    kernel(draws, q, log_p, grad, eps, inv_mass) -> (q, log_p, grad,
    accept_prob), with grad the gradient at q (reused by the integrator's
    first half-step, as it equals the reference's recomputation). The
    leapfrog steps run through one `Leapfrog` (a CUDA graph on a card)."""
    state = {}

    def kernel(draws, q, log_p, grad, eps, inv_mass):
        dev = q.device
        if "lf" not in state:
            state["lf"] = Leapfrog(target, q, log_p)
        lf = state["lf"]
        # trajectory arithmetic in the parameter dtype, whatever dtype the
        # step size was adapted in
        eps = torch.as_tensor(eps, device=dev).to(q.dtype)
        noise = draws.momentum(q.shape, q.dtype, dev)
        p = noise / torch.sqrt(inv_mass)
        h0 = -log_p + kinetic(p, inv_mass)
        lf.load(q, p, grad, log_p, eps.reshape(-1, 1), inv_mass, n_leapfrog)
        for _ in range(n_leapfrog):
            lf.step()
        h1 = -lf.lp + kinetic(lf.p, inv_mass)
        log_accept = torch.clamp(h0 - h1, max=0.0)
        log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                                 -math.inf)
        u = draws.accept_uniform(log_p.shape, log_accept.dtype, dev)
        accept = torch.log(u) < log_accept
        q = torch.where(accept[:, None], lf.q, q)
        grad = torch.where(accept[:, None], lf.g, grad)
        log_p = torch.where(accept, lf.lp, log_p)
        return q, log_p, grad, torch.exp(log_accept)

    return kernel


# --------------------------------------------------------------------------
# shared pieces of the samplers


def chain_start(log_prob, init_params, n_chains, inv_mass0):
    """(Target, q0 (C, dim), inv_mass0 as flat (dim,)) for a sampler's
    init_params: with a leading chain axis iff n_chains > 1."""
    params = {k: torch.as_tensor(v) for k, v in init_params.items()}
    if n_chains <= 1:
        params = {k: v[None] for k, v in params.items()}
    template = {k: v[0] for k, v in params.items()}
    target = Target(log_prob, template)
    q0 = target.flat(params).to(torch.float32)
    if inv_mass0 is None:
        im0 = torch.ones(target.dim, dtype=q0.dtype, device=q0.device)
    else:
        im0 = target.flat({k: torch.as_tensor(v, device=q0.device)[None]
                           for k, v in inv_mass0.items()})[0].to(q0.dtype)
    return target, q0, im0


def warmup_windows(n_warmup: int):
    """The Stan-style windows: eps only (30%), eps + Welford (40%), eps
    re-adapted under the new mass (30%)."""
    n1 = max(int(0.3 * n_warmup), 1)
    n3 = max(int(0.3 * n_warmup), 1)
    n2 = max(n_warmup - n1 - n3, 1)
    return n1, n2, n3


class SampleSink:
    """Collects one (C, dim) row block a transition on the device and
    copies them to the host every `every` transitions."""

    def __init__(self, every: int):
        self.every = max(int(every), 1)
        self.pending, self.host = [], []

    def add(self, q):
        self.pending.append(q)
        if len(self.pending) >= self.every:
            self.flush()

    def flush(self):
        if self.pending:
            self.host.append(torch.stack(self.pending, 1).cpu().numpy())
            self.pending = []

    def result(self) -> np.ndarray:
        """(C, S, dim) on the host."""
        self.flush()
        return np.concatenate(self.host, axis=1)


def samples_dict(target: Target, qs: np.ndarray, vmapped: bool) -> dict:
    """(C, S, dim) host samples -> dict of (C, S, ...) arrays, or (S, ...)
    for a single chain."""
    out = target.unflat(qs)
    return out if vmapped else {k: v[0] for k, v in out.items()}


def gather_samples(split, sink: SampleSink) -> np.ndarray:
    """(C, S, dim) host samples of every chain, in chain order, from this
    rank's sink (mcmc/chains.py)."""
    qs = sink.result()
    return split.gather(torch.from_numpy(qs)).numpy() if split.sharded \
        else qs


def stack_chains(split, xs) -> torch.Tensor:
    """(S, C): S per-transition tensors of this rank's chains (C_local,),
    every chain's, laid out as torch.stack(xs) lays them out on one rank
    (so their mean sums in the same order)."""
    return split.gather(torch.stack(xs, 1)).T.contiguous()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_hmc(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    n_leapfrog: int = 32,
    init_eps: float = 0.1,
    target_accept: float = 0.8,
    n_chains: int = 1,
    thin: int = 1,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
):
    """Run `n_chains` HMC chains. Returns (samples, diagnostics).

    key: an int seed or a torch.Generator on the parameters' device.
    samples: dict of host numpy arrays with leading axes (n_chains,
    n_samples // thin), or (n_samples // thin,) for one chain.
    init_params must have a leading chain axis iff n_chains > 1.
    inv_mass0: optional diagonal preconditioner dict (no chain axis, e.g.
    potential.svi_informed_inits' q-variances) used through warmup
    phases 1-2 and as the Welford shrinkage target in phase 3.
    In a process group (shard_chains), the chains are split over the
    ranks (mcmc/chains.py) and every rank returns every chain's result;
    diagnostics["draws"] counts this rank's generator calls.
    """
    from terastructure_tpu_torch.mcmc import chains

    vmapped = n_chains > 1
    split = chains.split(n_chains, shard_chains)
    if not split.holds:
        return split.idle()
    target, q, im0 = chain_start(log_prob, split.local(init_params),
                                 n_chains, inv_mass0)
    dev = q.device
    draws = split.draws(TorchDraws(as_generator(key, dev)))
    kernel = hmc_kernel(target, n_leapfrog)
    c = q.shape[0]
    lp, g = target.value_and_grad(q)
    inv_mass = im0.expand(c, -1)

    def warm(q, lp, g, da, wf, inv_mass, n):
        for _ in range(n):
            q, lp, g, acc = kernel(draws, q, lp, g, torch.exp(da.log_eps),
                                   inv_mass)
            da = da_update(da, acc, target=target_accept)
            wf = welford_update(wf, q)
        return q, lp, g, da, wf

    n1, n2, n3 = warmup_windows(n_warmup)
    da = da_init(torch.full((c,), float(init_eps), dtype=torch.float64,
                            device=dev))
    q, lp, g, da, _ = warm(q, lp, g, da, welford_init(q), inv_mass, n1)
    q, lp, g, da, wf = warm(q, lp, g, da, welford_init(q), inv_mass, n2)
    inv_mass = welford_variance(wf, prior=None if inv_mass0 is None else im0)
    q, lp, g, da, _ = warm(q, lp, g, da_init(torch.exp(da.log_eps)),
                           welford_init(q), inv_mass, n3)
    eps = torch.exp(da.log_eps_avg)

    sink = SampleSink(dispatch_chunk)
    accs = []
    for _ in range(n_samples // thin):
        acc_sum = torch.zeros(c, dtype=lp.dtype, device=dev)
        for _ in range(thin):
            q, lp, g, acc = kernel(draws, q, lp, g, eps, inv_mass)
            acc_sum = acc_sum + acc / thin
        sink.add(q)
        accs.append(acc_sum)
    samples = samples_dict(target, gather_samples(split, sink), vmapped)
    eps_out = split.gather(eps).cpu().numpy()
    return split.share((samples, {
        "accept_rate": float(stack_chains(split, accs).mean()),
        "eps": eps_out if vmapped else eps_out[0],
        "draws": draws.calls,
    }))
