"""Placement of MCMC chains and SMC particles over ranks (port of
terastructure_tpu/mcmc/chains.py).

The samplers keep chains (or particles) on a leading axis of every
tensor. The reference spreads that axis over a 1-D mesh of d devices, d
the largest divisor of the chain count that is at most the device count
(`chain_mesh`), and leaves placement out of what is sampled. The port's
unit of multi-card work is the rank (parallel/: one process a card over
torch.distributed, NCCL on cards, gloo on the CPU), so here the axis is
split over ranks:

  - rank r < d holds the contiguous chains [r n/d, (r + 1) n/d); ranks
    >= d hold none and only receive the result;
  - every rank seeds the same generator and draws the whole (n, ...)
    tensor of each draw, keeping its own rows (`ChainSplit.draws`), so
    chain c sees the draws it sees on one rank, provided every rank asks
    the generator equally often: the host loops that stop when no chain
    is active (NUTS's leaves and doublings) test a global OR
    (`ChainSplit.any`) so that every rank runs them in lockstep;
  - the cross-chain quantities (ChEES's adaptation, SMC's weights,
    resampling and pooled acceptance) are computed on every rank from
    the per-chain values gathered in chain order (`ChainSplit.gather`):
    the same sum over all chains, in the same order, as on one rank;
  - the result (samples, per-chain step sizes, the diagnostics) is
    gathered, so every rank returns the one-rank call's shapes.

With no process group, or a world of one rank, or shard=False, the split
is the identity and the samplers run as on one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def chain_grid(n: int, world: int) -> Optional[int]:
    """The number of ranks that hold chains: the largest divisor of n that
    is at most `world`, or None where that is 1 (the reference's
    chain_mesh, over ranks)."""
    d = min(n, world)
    while d > 1 and n % d:
        d -= 1
    return d if d > 1 else None


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _SliceDraws:
    """A draw source whose every chain-leading draw is made at the full
    chain count and cut to this rank's rows: the same generator calls on
    every rank, whatever it holds. Draws of shape () pass through."""

    def __init__(self, inner, split: "ChainSplit"):
        self.inner = inner
        self.split = split

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if not callable(fn):
            return fn
        sp = self.split

        def draw(shape, *args, **kw):
            shape = tuple(shape)
            if not shape:
                return fn(shape, *args, **kw)
            if shape[0] != sp.per:
                raise ValueError(f"a {name} draw of {shape[0]} rows on a rank "
                                 f"holding {sp.per} chains")
            return fn((sp.n,) + shape[1:], *args, **kw)[sp.lo:sp.hi]

        return draw


class ChainSplit:
    """This rank's share of n chains (see the module's docstring).

    d: the ranks holding chains (1: the identity); group: the process
    group of ranks 0..d-1 (None: the default group, d = world)."""

    def __init__(self, n: int, d: int = 1, rank: int = 0, world: int = 1,
                 group=None):
        self.n, self.d, self.rank, self.world = n, d, rank, world
        self.group = group
        self.per = n // d
        r = min(rank, d)
        self.lo, self.hi = r * self.per, min(r + 1, d) * self.per
        if rank >= d:
            self.lo = self.hi = n
        nccl = d > 1 and dist.get_backend() == "nccl"
        # NCCL moves card tensors only; gloo takes host tensors
        self.comm = (torch.device("cuda", torch.cuda.current_device())
                     if nccl else torch.device("cpu"))

    @property
    def sharded(self) -> bool:
        return self.d > 1

    @property
    def holds(self) -> bool:
        """Whether this rank holds chains (every rank of the identity)."""
        return self.rank < self.d

    def local(self, tree):
        """This rank's rows of the leading axis of every tensor in `tree`
        (a dict, list or tuple of tensors, or a tensor)."""
        if not self.sharded:
            return tree
        if isinstance(tree, dict):
            return {k: self.local(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.local(v) for v in tree)
        return torch.as_tensor(tree)[self.lo:self.hi]

    def draws(self, source):
        """`source` with its chain-leading draws made whole and cut to
        this rank's rows."""
        return _SliceDraws(source, self) if self.sharded else source

    def _collective(self, what, fn):
        try:
            return fn()
        except RuntimeError as e:
            raise RuntimeError(
                f"chains over ranks {list(range(self.d))}: {what} failed on "
                f"rank {self.rank} ({e})") from e

    def any(self, flag: torch.Tensor) -> bool:
        """Whether any element of `flag` is true on any rank holding
        chains: one all-reduce of one value (a host sync either way)."""
        local = bool(flag.any())
        if not self.sharded:
            return local
        x = torch.tensor([int(local)], dtype=torch.int32, device=self.comm)
        self._collective("the OR of the active chains", lambda: dist.all_reduce(
            x, op=dist.ReduceOp.MAX, group=self.group))
        return bool(x.item())

    def _reduce_int(self, v: int, op, what) -> int:
        if not self.sharded:
            return int(v)
        x = torch.tensor([int(v)], dtype=torch.int64, device=self.comm)
        self._collective(what, lambda: dist.all_reduce(x, op=op,
                                                       group=self.group))
        return int(x.item())

    def sum_int(self, v: int) -> int:
        """v summed over the ranks holding chains (exact)."""
        return self._reduce_int(v, dist.ReduceOp.SUM, "a count's sum")

    def max_int(self, v: int) -> int:
        """The largest v of the ranks holding chains."""
        return self._reduce_int(v, dist.ReduceOp.MAX, "a count's maximum")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The (n, ...) tensor of every chain, in chain order, from each
        holding rank's (n/d, ...) rows x: one broadcast from each holding
        rank (gloo broadcasts what it cannot all-gather), bits unchanged.
        Returned on x's device."""
        if not self.sharded:
            return x
        mine = x.detach().to(self.comm).contiguous()
        parts = []
        for r in range(self.d):
            buf = mine if r == self.rank else torch.empty_like(mine)
            self._collective(f"the gather of rank {r}'s chains",
                             lambda: dist.broadcast(buf, src=r,
                                                    group=self.group))
            parts.append(buf)
        return torch.cat(parts).to(x.device)

    def idle(self):
        """What a rank without chains returns: the lead's (samples,
        diagnostics), with "draws" (the generator calls of this rank) 0."""
        samples, diag = self.share(None)
        return samples, dict(diag, draws=0)

    def share(self, result):
        """The lead's result on every rank: the identity where every rank
        holds chains, else one broadcast of the picklable `result` from
        rank 0 over the whole world (ranks >= d pass None)."""
        if self.d >= self.world:
            return result
        box = [result]
        self._collective("the result's broadcast to the idle ranks",
                         lambda: dist.broadcast_object_list(box, src=0))
        return box[0]


def split(n: int, shard: bool = True) -> ChainSplit:
    """This rank's ChainSplit of n chains over the process group's ranks
    (chain_grid): the identity with no group, one rank or shard=False.
    Collective where only some ranks hold chains (the group of ranks
    0..d-1 is made): every rank calls it, in the same order."""
    rank, world = _world()
    d = chain_grid(n, world) if shard and world > 1 else None
    if d is None:
        return ChainSplit(n)
    group = None if d == world else dist.new_group(list(range(d)))
    return ChainSplit(n, d, rank, world, group)


def maybe_shard_leading(tree, n: int, shard: bool):
    """This rank's rows of the leading (chain/particle) axis of every
    tensor in `tree`, n the axis' size: the tree itself on one device (no
    process group or a world of one) or with shard=False."""
    rank, world = _world()
    d = chain_grid(n, world) if shard and world > 1 else None
    if d is None:
        return tree
    return ChainSplit(n, d, rank, world).local(tree)
