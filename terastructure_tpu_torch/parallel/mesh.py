"""The (ind x snp) grid of ranks (port of terastructure_tpu/parallel/mesh.py).

The reference runs one SPMD program over a device mesh. The port runs one
process (rank) per card, as `torchrun` starts them, over torch.distributed:

  - gamma and the exp-Elog-theta factor are split over the 'ind' axis,
  - lambda and the packed genotype matrix over the 'snp' axis,

so the per-minibatch lambda statistics are all-reduced over the ranks
that share an SNP shard (`ind_group`), and the gamma statistic over the
ranks that share an individual shard (`snp_group`).

Rank r sits at (i, s) = divmod(r, snp), the reference's device order
(`np.asarray(devices).reshape(ind, snp)`). Placement, as the reference's
specs: rank (i, s) holds gamma rows of shard i (GAMMA_SPEC: split over
'ind', the same on every s), lambda rows of shard s (LAMB_SPEC) and the
packed block (rows of s, byte columns of i) (PACKED_SPEC).

A world of one rank (no process group initialized) runs the same code
with every reduction the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

IND_AXIS = "ind"
SNP_AXIS = "snp"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    ind: int
    snp: int

    @property
    def n_devices(self):
        return self.ind * self.snp

    @property
    def shape(self) -> dict:
        return {IND_AXIS: self.ind, SNP_AXIS: self.snp}


def choose_mesh_shape(n_devices: int, ind: int = 0, snp: int = 0) -> MeshSpec:
    """Pick (ind, snp) axis sizes for n_devices ranks. Defaults put every
    rank on 'snp' (its all-reduce payload, N_local x K, shrinks as 'ind'
    grows, so 'ind' is kept for hosts). Raises where the sizes do not
    multiply to n_devices."""
    if ind and snp:
        spec = MeshSpec(ind, snp)
    elif ind:
        spec = MeshSpec(ind, n_devices // ind)
    elif snp:
        spec = MeshSpec(n_devices // snp, snp)
    else:
        spec = MeshSpec(1, n_devices)
    if spec.n_devices != n_devices or min(spec.ind, spec.snp) < 1:
        raise ValueError(f"mesh {ind or '*'}x{snp or '*'} does not fit "
                         f"{n_devices} devices (world size {n_devices})")
    return spec


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid and the groups it reduces over.

    ind_group: the ranks that share this rank's SNP shard s (they reduce
    the lambda statistics); snp_group: the ranks that share its individual
    shard i (they reduce the gamma statistic). None where the group is
    this rank alone (the reduction is the identity) or the whole world
    (the default group)."""

    spec: MeshSpec
    rank: int
    device: torch.device
    backend: Optional[str]
    ind_group: object = None
    snp_group: object = None

    @property
    def world(self) -> int:
        return self.spec.n_devices

    @property
    def i(self) -> int:
        return self.rank // self.spec.snp

    @property
    def s(self) -> int:
        return self.rank % self.spec.snp

    @property
    def shape(self) -> dict:
        return self.spec.shape

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def ind_ranks(self, s=None) -> list:
        """Global ranks of ind_group(s) (this rank's s by default)."""
        s = self.s if s is None else s
        return [i * self.spec.snp + s for i in range(self.spec.ind)]

    def snp_ranks(self, i=None) -> list:
        """Global ranks of snp_group(i) (this rank's i by default)."""
        i = self.i if i is None else i
        return [i * self.spec.snp + s for s in range(self.spec.snp)]

    def reduce_ind(self, l0, l1):
        """Sum (l0, l1) over ind_group in one all-reduce: the ind_reduce
        hook of the local solves. Every rank of the group gets the same
        bits."""
        if self.spec.ind == 1:
            return l0, l1
        x = torch.stack([l0, l1])
        dist.all_reduce(x, group=self.ind_group)
        return x[0], x[1]

    def reduce_snp(self, x, async_op=False):
        """Sum x over snp_group in place; returns the collective's work
        handle (None when not async or the group is this rank alone)."""
        if self.spec.snp == 1:
            return None
        return dist.all_reduce(x, group=self.snp_group, async_op=async_op)

    def gather(self, x, ranks, group, total):
        """Concatenate the equal blocks x (rows) of `ranks` in rank order
        into a (total, ...) tensor on every member of `group`: one
        broadcast from each member (gloo broadcasts CUDA tensors, where it
        gathers only CPU ones). Rows past `total` are cut."""
        if len(ranks) == 1:
            return x[:total]
        parts = []
        for r in ranks:
            buf = x.clone() if r == self.rank else torch.empty_like(x)
            dist.broadcast(buf, src=r, group=group)
            parts.append(buf)
        return torch.cat(parts)[:total]

    def broadcast_float(self, value: float) -> float:
        """The lead's value on every rank (the driver's decisions)."""
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())


def _group(ranks, world):
    """dist.new_group(ranks): collective, so every rank calls it for every
    group in one order. None where the group is the whole world."""
    return None if len(ranks) == world else dist.new_group(ranks)


def make_mesh(spec: Optional[MeshSpec] = None, *, device=None) -> Mesh:
    """This rank's Mesh. spec None: every rank on 'snp'
    (choose_mesh_shape). device: where this rank's tensors live; None is
    this rank's card (multihost.device: the one the process group was
    initialized for, else card LOCAL_RANK), raising where there is none;
    the CPU only where asked for ("cpu").

    With a process group initialized, its world size must equal
    spec.n_devices; the sub-groups are made here, every rank making
    every group in the same order. Without one, spec must be 1 x 1."""
    from terastructure_tpu_torch.parallel import multihost

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    spec = choose_mesh_shape(world) if spec is None else spec
    if spec.n_devices != world:
        raise ValueError(f"mesh {spec.ind}x{spec.snp} != {world} ranks "
                         f"(world size {world})")
    if device is None:
        device = multihost.device()
    mesh = Mesh(spec=spec, rank=rank, device=torch.device(device),
                backend=dist.get_backend() if initialized else None)
    if world == 1:
        return mesh
    ind_groups = {s: _group([i * spec.snp + s for i in range(spec.ind)],
                            world)
                  for s in range(spec.snp)} if spec.ind > 1 else {}
    snp_groups = {i: _group([i * spec.snp + s for s in range(spec.snp)],
                            world)
                  for i in range(spec.ind)} if spec.snp > 1 else {}
    mesh.ind_group = ind_groups.get(mesh.s)
    mesh.snp_group = snp_groups.get(mesh.i)
    return mesh
