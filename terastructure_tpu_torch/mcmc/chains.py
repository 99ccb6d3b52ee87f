"""Placement of MCMC chains and SMC particles (port of
terastructure_tpu/mcmc/chains.py).

The samplers keep chains (or particles) on a leading axis of every
tensor. On one device that axis simply stays where the tensors are, which
is what the reference does when it sees one device. Spreading the axis
over several cards (NUTS's lockstep `.any()` and SMC's resampling across
ranks) is the second part of the multi-card slice, not ported yet: the
multi-card SVI fit (parallel/) does not cover it. Asked for with more
than one CUDA card visible, it raises rather than quietly running on one
card.
"""

from __future__ import annotations

import torch

_NEXT = ("slice S8 part 2, chains and particles over cards: ROADMAP "
         "Queue 1, next after the multi-card SVI fit")


def maybe_shard_leading(tree, n: int, shard: bool):
    """The leading (chain/particle) axis of every tensor in `tree` over the
    local cards: the identity on one device. n is the axis' size."""
    if shard and n > 1 and _on_cuda(tree) \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "chains/particles over several CUDA cards are not ported yet "
            f"({_NEXT}); pass shard_chains=False (shard_particles=False) to "
            "run them on one card")
    return tree


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_on_cuda(v) for v in tree)
    return False
