"""Collectives for the flat engine's exchange.

Counterpart of ``dgc_tpu/parallel/mesh.py`` (a JAX mesh axis plus
``all_gather``/``psum`` inside ``shard_map``). A :class:`Comm` serves the
workers that live in this process — ``comm.ranks`` lists their global
ranks — and every call takes and returns one tensor per local worker:

* :class:`ProcessGroupComm` — one worker per process over
  ``torch.distributed`` (NCCL on the card, gloo on the CPU);
* :class:`LocalComm` — W workers simulated in one process, in lockstep,
  so a W-worker exchange runs on one card (or the CPU).
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


class ProcessGroupComm(Comm):
    """One worker per process over a ``torch.distributed`` process group
    (the default group unless one is given)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.world = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

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
