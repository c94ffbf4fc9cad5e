"""The Adasum delta-optimizer variant.

Counterpart of ``dgc_tpu/optim/adasum.py`` (the reference's
``_DistributedAdasumOptimizer``): the base optimizer steps on each
worker's LOCAL gradient first, and the resulting parameter delta is what
goes through the compressor and the exchange, combined across workers
with the Adasum operator instead of averaged. Compressed payloads are
scatter-add summed (the reference divides only under Average); the dense
block is combined pairwise by :func:`adasum_pair`.

The combine ``fa * a + fb * b`` is evaluated op by op (two multiplies and
an add, no fused multiply-add), so it is bitwise the JAX functions run op
by op given the same dot products; XLA fuses it under jit (ROADMAP.md §3).
The dot products are reductions whose order differs between devices.
"""

from typing import Dict, List, Sequence

import torch

from dgc_tpu_torch.optim.distributed import DistributedOptimizer

__all__ = ["adasum_pair", "adasum_reduce", "adasum_allreduce",
           "AdasumDistributedOptimizer"]


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(1 - <a,b>/2|a|^2) a + (1 - <a,b>/2|b|^2) b``: identical vectors
    give the vector back, orthogonal ones add."""
    dot = torch.sum(a * b)
    asq = torch.sum(a * a)
    bsq = torch.sum(b * b)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    fa = torch.where(asq > 0, 1.0 - dot / (2 * asq), one)
    fb = torch.where(bsq > 0, 1.0 - dot / (2 * bsq), one)
    return fa * a + fb * b


def adasum_reduce(vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pairwise-recursive Adasum over workers' vectors in rank order
    (neighbours first, then pairs of pairs; an odd one out carries up)."""
    vecs = list(vecs)
    while len(vecs) > 1:
        nxt = [adasum_pair(vecs[i], vecs[i + 1])
               for i in range(0, len(vecs) - 1, 2)]
        if len(vecs) % 2:
            nxt.append(vecs[-1])
        vecs = nxt
    return vecs[0]


def adasum_allreduce(xs: Sequence[torch.Tensor], comm) -> List[torch.Tensor]:
    """Each local worker's Adasum of every worker's ``x`` over ``comm``.

    At a power-of-two world this is recursive doubling over
    ``comm.swap``: log2(W) rounds, each worker pairing with ``rank ^ d``
    and both members evaluating :func:`adasum_pair` with the lower rank's
    value first, so every worker ends bitwise equal (the same tree as
    :func:`adasum_reduce`). Other worlds gather and reduce the ``[W, P]``
    stack in rank order."""
    world = comm.world
    if world == 1:
        return list(xs)
    if world & (world - 1) == 0:
        xs = list(xs)
        d = 1
        while d < world:
            others = comm.swap(xs, d)
            xs = [adasum_pair(x, o) if r & d == 0 else adasum_pair(o, x)
                  for x, o, r in zip(xs, others, comm.ranks)]
            d *= 2
        return xs
    gathered = comm.all_gather(list(xs))
    return [adasum_reduce(list(g)) for g in gathered]


class AdasumDistributedOptimizer(DistributedOptimizer):
    """The delta-optimizer composition: a local base-optimizer step, then
    the compressed Adasum exchange of the delta. The base optimizer steps
    on local gradients, so its state is per worker (``TrainState`` keeps
    one a local worker; the checkpoint writes it into each ``w<r>.pt``).

    Two tiers (``local_size > 1``): the deltas are dense-averaged over the
    node first and each node is one Adasum participant across the cross
    group (Horovod's hierarchical Adasum on the reference's "sparsified
    nodes")."""

    per_worker_opt_state = True

    def init_per_worker(self, flat_params: torch.Tensor) -> list:
        return [self.optimizer.init(flat_params)
                for _ in range(len(self.comm.ranks))]

    def update_flat(self, flat_grads: Sequence[torch.Tensor], opt_states,
                    flat_params: torch.Tensor, mems: List, phases, engine,
                    health=None, telemetry: bool = False, send_frac=None):
        """Each local worker's base step on its own gradient (its own
        optimizer state), then the engine's exchange of the deltas under
        ``op="adasum"``. Returns ``(new params, opt states, reduced
        deltas)``. The telemetry taps and the adaptive send fraction are
        refused, as in the reference."""
        if telemetry:
            raise NotImplementedError(
                "telemetry taps are not wired through the Adasum flat path")
        if send_frac is not None:
            raise NotImplementedError(
                "straggler-adaptive send fractions are not wired through "
                "the Adasum flat path")
        upds, new_states = [], []
        for g, s in zip(flat_grads, opt_states):
            u, s = self.optimizer.update(g, s, flat_params)
            upds.append(u)
            new_states.append(s)
        reduced = self._flat_exchange(engine, upds, mems, phases, "adasum",
                                      health)
        return flat_params + reduced[0], new_states, reduced

    def update(self, grads: Sequence[Dict[str, torch.Tensor]], opt_states,
               flat_params: torch.Tensor, mem_states: List[Dict],
               phases: Sequence[Dict[str, int]], layout):
        """The per-tensor Adasum exchange: each worker's base step on its
        flattened local gradient, then each tensor's delta through the
        compressor — a compressed one gathered and scatter-add summed, a
        dense one combined by :func:`adasum_allreduce` and given the
        memory's non-accumulating correction. Returns ``(new params, opt
        states, exchanged deltas)``."""
        comp = self.compressor
        if getattr(comp, "checksum", False):
            raise ValueError(self._PER_TENSOR_CHECKSUM)
        upds, new_states = [], []
        for g, s in zip(grads, opt_states):
            flat = layout.flatten(g, device=flat_params.device)
            u, s = self.optimizer.update(flat, s, flat_params)
            upds.append(layout.unflatten_named(u))
            new_states.append(s)
        if self.local_size > 1:
            upds = self._node_mean_named(upds)
        comm = self.cross_comm
        names = list(upds[0])
        local = range(len(upds))
        outs = [{} for _ in local]
        for name in names:
            payloads, ctx = [], None
            for w in local:
                p, ctx, mem_states[w] = comp.compress(
                    mem_states[w], name, upds[w][name],
                    phases[w].get(name, 0))
                payloads.append(p)
            if getattr(ctx, "compressed", False):
                gathered = comp.communicate(payloads, ctx, comm)
                for w in local:
                    outs[w][name], mem_states[w] = comp.decompress(
                        gathered[w], ctx, mem_states[w], comm.world,
                        op="adasum")
            else:
                red = adasum_allreduce([upds[w][name] for w in local], comm)
                for w in local:
                    corrected, mem_states[w] = comp.memory.compensate(
                        mem_states[w], name, red[w].reshape(-1),
                        accumulate=False)
                    outs[w][name] = corrected.reshape(upds[w][name].shape)
        flat = layout.flatten(outs[0], device=flat_params.device)
        return flat_params + flat, new_states, outs
