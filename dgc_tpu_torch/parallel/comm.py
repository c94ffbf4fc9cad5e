"""Collectives for the flat engine's exchange.

Counterpart of ``dgc_tpu/parallel/mesh.py`` (a JAX mesh axis plus
``all_gather``/``psum`` inside ``shard_map``). A :class:`Comm` serves the
workers that live in this process — ``comm.ranks`` lists their global
ranks — and every call takes and returns one tensor per local worker:

* :class:`ProcessGroupComm` — one worker per process over
  ``torch.distributed`` (NCCL on the card, gloo on the CPU);
* :class:`LocalComm` — W workers simulated in one process, in lockstep,
  so a W-worker exchange runs on one card (or the CPU).

:meth:`Comm.split` makes the two tiers of the hierarchical exchange: a
**local** group (the ``local_size`` consecutive ranks of one node, over
NVLink on a real machine) and a **cross** group (the ranks with the same
local index on every node). Each is a :class:`Comm` over this process's
workers: its ``world`` is the group's size and ``ranks`` each local
worker's index in its own group. ``LocalComm`` simulates both in one
process; ``ProcessGroupComm`` builds them with ``dist.new_group``, every
group created in the same order on every rank. :meth:`Comm.swap` is the
pairwise exchange of Adasum's recursive doubling (each worker gets the
tensor of ``rank ^ d``).
"""

from typing import List, Sequence, Tuple

import torch

__all__ = ["Comm", "LocalComm", "ProcessGroupComm"]


class Comm:
    """Collectives over ``world`` workers, of which ``ranks`` are local."""

    world: int
    ranks: Tuple[int, ...]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per local worker, the [world, *x.shape] stack of every worker's
        ``x`` in rank order."""
        raise NotImplementedError

    def all_reduce(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per local worker, the sum of every worker's ``x``."""
        raise NotImplementedError

    def swap(self, xs: Sequence[torch.Tensor], d: int) -> List[torch.Tensor]:
        """Per local worker of rank r, the ``x`` of rank ``r ^ d`` (``d`` a
        power of two below a power-of-two world)."""
        raise NotImplementedError

    def split(self, local_size: int) -> Tuple["Comm", "Comm"]:
        """``(local, cross)`` groups of ``local_size`` workers a node."""
        raise NotImplementedError


def _check_split(world: int, local_size: int) -> None:
    if local_size < 1 or world % local_size:
        raise ValueError(f"local_size {local_size} must divide the world "
                         f"{world}")


class LocalComm(Comm):
    """W simulated workers in one process. The sum adds worker 0, 1, ...
    in rank order. The returned tensors are shared by all local workers
    and must not be modified in place."""

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.ranks = tuple(range(world))

    def _check(self, xs):
        if len(xs) != self.world:
            raise ValueError(f"LocalComm({self.world}) takes one tensor per "
                             f"worker, got {len(xs)}")

    def all_gather(self, xs):
        self._check(xs)
        g = torch.stack(list(xs))
        return [g] * self.world

    def all_reduce(self, xs):
        self._check(xs)
        s = xs[0]
        for x in xs[1:]:
            s = s + x
        return [s] * self.world

    def swap(self, xs, d):
        self._check(xs)
        return [xs[r ^ d] for r in self.ranks]

    def split(self, local_size):
        _check_split(self.world, local_size)
        nodes = self.world // local_size
        local = [[n * local_size + i for i in range(local_size)]
                 for n in range(nodes)]
        cross = [[n * local_size + i for n in range(nodes)]
                 for i in range(local_size)]
        return _GroupedLocalComm(local), _GroupedLocalComm(cross)


class _GroupedLocalComm(Comm):
    """A :class:`LocalComm`'s workers in disjoint groups (``groups``: lists
    of global ranks, each in rank order): every call works within each
    worker's own group, whose size is ``world``; ``ranks`` are the local
    workers' indices in their groups. Sums add a group's members in order;
    the returned tensors are shared inside a group."""

    def __init__(self, groups: List[List[int]]):
        self.groups = groups
        self.world = len(groups[0])
        total = sum(len(g) for g in groups)
        self._of = [None] * total            # rank -> (group, index)
        for gi, g in enumerate(groups):
            for i, r in enumerate(g):
                self._of[r] = (gi, i)
        self.ranks = tuple(self._of[r][1] for r in range(total))

    def _check(self, xs):
        if len(xs) != len(self._of):
            raise ValueError(f"a group split of LocalComm({len(self._of)}) "
                             f"takes one tensor per worker, got {len(xs)}")

    def all_gather(self, xs):
        self._check(xs)
        stacks = [torch.stack([xs[r] for r in g]) for g in self.groups]
        return [stacks[self._of[r][0]] for r in range(len(xs))]

    def all_reduce(self, xs):
        self._check(xs)
        sums = []
        for g in self.groups:
            s = xs[g[0]]
            for r in g[1:]:
                s = s + xs[r]
            sums.append(s)
        return [sums[self._of[r][0]] for r in range(len(xs))]

    def swap(self, xs, d):
        self._check(xs)
        out = []
        for r in range(len(xs)):
            gi, i = self._of[r]
            out.append(xs[self.groups[gi][i ^ d]])
        return out


class ProcessGroupComm(Comm):
    """One worker per process over a ``torch.distributed`` process group
    (the default group unless one is given)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.world = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def swap(self, xs, d):
        (x,) = xs
        dist = self._dist
        peer = self.ranks[0] ^ d
        if self.group is not None:
            peer = dist.get_global_rank(self.group, peer)
        y = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), peer, self.group),
            dist.P2POp(dist.irecv, y, peer, self.group)])
        for q in reqs:
            q.wait()
        return [y]

    def split(self, local_size):
        """Both tiers' groups over the default group's ranks (a node is
        ``local_size`` consecutive ranks); every rank creates every group,
        in the same order."""
        dist = self._dist
        world = dist.get_world_size()
        _check_split(world, local_size)
        me = dist.get_rank()
        nodes = world // local_size
        mine = {}
        for n in range(nodes):
            g = dist.new_group([n * local_size + i
                                for i in range(local_size)])
            if me // local_size == n:
                mine["local"] = g
        for i in range(local_size):
            g = dist.new_group([n * local_size + i for n in range(nodes)])
            if me % local_size == i:
                mine["cross"] = g
        return ProcessGroupComm(mine["local"]), ProcessGroupComm(mine["cross"])

    def all_gather(self, xs):
        (x,) = xs
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._dist.all_gather(parts, x.contiguous(), group=self.group)
        return [torch.stack(parts)]

    def all_reduce(self, xs):
        (x,) = xs
        y = x.clone()
        self._dist.all_reduce(y, group=self.group)
        return [y]
