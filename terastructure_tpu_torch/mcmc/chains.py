"""Placement of MCMC chains and SMC particles (port of
terastructure_tpu/mcmc/chains.py).

The samplers keep chains (or particles) on a leading axis of every
tensor. On one device that axis simply stays where the tensors are, which
is what the reference does when it sees one device. Spreading the axis
over several cards belongs to the multi-GPU slice (S8) and is not ported
yet: asked for with more than one CUDA card visible, it raises rather
than quietly running on one card.
"""

from __future__ import annotations

import torch

_S8 = "slice S8, multi-GPU"


def maybe_shard_leading(tree, n: int, shard: bool):
    """The leading (chain/particle) axis of every tensor in `tree` over the
    local cards: the identity on one device. n is the axis' size."""
    if shard and n > 1 and _on_cuda(tree) \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "chains/particles over several CUDA cards are not ported yet "
            f"({_S8}); pass shard_chains=False (shard_particles=False) to "
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
