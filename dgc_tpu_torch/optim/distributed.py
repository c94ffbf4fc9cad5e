"""Distributed optimizer — compressed exchange, then the base optimizer.

Counterpart of ``dgc_tpu/optim/distributed.py``, over a :class:`Comm` that
serves this process's workers (``comm.ranks``) in one call:

* the flat path (``make_flat`` / ``update_flat``): the compressor's flat
  engine exchanges each worker's flat [P] gradient;
* the per-tensor path (``init_memory`` / ``exchange`` / ``update``): the
  compressor's batched compensate (``compensate_all``, where it has one),
  then ``compress`` -> ``communicate`` -> ``decompress`` tensor by
  tensor, with every sparse payload in two all-gathers under
  ``fuse_payloads`` (``exchange_fused``), dense ones through the
  all-reduce.

Either way the wrapped optimizer steps the (replicated) flat parameters:
the per-tensor path flattens the exchanged gradient into the parameters'
layout first (``dgc_sgd`` is elementwise, so per tensor and flat give the
same numbers).

**Two tiers** (``local_size > 1``; the reference also names the local
mesh axis, the port's groups come from the ``Comm``; the "#Sparsified
Nodes < #GPUs" regime, ``configs/dgc/twotier.py``): ``comm`` splits into
a local group (the ``local_size`` ranks of one node, NVLink on a real
machine) and a cross group (the ranks with the same local index on every node;
:meth:`Comm.split`). Each worker's gradient is first averaged densely over
its node (full precision), then the DGC exchange runs on the node
gradient over the cross group among ``num_nodes`` participants. A node's
workers hold the same node gradient, draw the same sampling phases (the
trainer seeds their generators by the node's index) and so keep the same
memory: the memory is per node.
"""

from typing import Dict, List, Optional, Sequence

import torch

from dgc_tpu_torch.compression.flat import ParamLayout, node_mean
from dgc_tpu_torch.parallel.comm import Comm
from dgc_tpu_torch.utils.pytree import named_flatten

__all__ = ["DistributedOptimizer"]


class DistributedOptimizer:
    #: True when the wrapped optimizer steps on local gradients and its
    #: state is per worker (the Adasum scheme)
    per_worker_opt_state = False

    _PER_TENSOR_CHECKSUM = (
        "the payload checksum (DGCCompressor(checksum=True)) covers the flat "
        "engine's bucket payload only, as in the JAX package: the "
        "per-tensor exchange refuses it")

    def __init__(self, optimizer, compressor, comm: Comm,
                 fuse_payloads: bool = True, local_size: int = 1):
        if local_size < 1:
            raise ValueError(f"local_size must be >= 1, got {local_size}")
        if comm.world % local_size:
            raise ValueError(f"local_size {local_size} must divide the "
                             f"world {comm.world}")
        self.optimizer = optimizer
        self.compressor = compressor
        self.comm = comm
        self.fuse_payloads = fuse_payloads
        #: workers a node (1: flat data parallelism)
        self.local_size = int(local_size)
        #: sparse-exchange participants (nodes under two tiers)
        self.num_nodes = comm.world // self.local_size
        if self.local_size > 1:
            self.local_comm, self.cross_comm = comm.split(self.local_size)
        else:
            self.local_comm, self.cross_comm = None, comm

    def init(self, flat_params: torch.Tensor):
        return self.optimizer.init(flat_params)

    # -------------------------------------------------------------- #
    # the flat path                                                  #
    # -------------------------------------------------------------- #

    def make_flat(self, params_tree, plan=None):
        """The ``(ParamLayout, engine)`` pair; call again after the warm-up
        schedule changes the ratio (the layout does not change). ``plan``:
        an exchange plan (``compression.planner``), re-fit to this
        geometry through ``Plan.replan`` on a probe engine, or a regime
        sequence taken as it is."""
        layout = ParamLayout.for_compressor(params_tree, self.compressor)
        if plan is not None and hasattr(plan, "replan"):
            plan = plan.replan(self.compressor.make_flat_exchange(layout))
        if plan is None:
            return layout, self.compressor.make_flat_exchange(layout)
        return layout, self.compressor.make_flat_exchange(layout, plan=plan)

    def _flat_exchange(self, engine, flat_grads, mems, phases, op, health,
                       telemetry=False, send_frac=None):
        kw = {}
        if op != "average":
            kw["op"] = op
        if self.local_comm is not None:
            kw["local_comm"] = self.local_comm
        if health is not None:
            kw["health"] = health
        if telemetry:
            kw["telemetry"] = True
        if send_frac is not None:
            kw["send_frac"] = send_frac
        return engine.exchange(flat_grads, mems, phases, self.cross_comm,
                               **kw)

    def update_flat(self, flat_grads: Sequence[torch.Tensor], opt_state,
                    flat_params: torch.Tensor, mems: List, phases,
                    engine, health: Optional[Dict] = None,
                    telemetry: bool = False, send_frac=None):
        """Exchange every local worker's gradient (memories update in
        place; ``health`` receives the payload checksum's mismatch count;
        ``send_frac``: each local worker's adaptive send fraction), then
        one optimizer step on the replicated parameters. Every local
        worker's exchanged gradient is the same, so the first one drives
        the step. Returns ``(new params, opt state, exchanged
        gradients)``, and with ``telemetry`` each local worker's stats
        dict (the engine's) as a fourth element."""
        out = self._flat_exchange(engine, flat_grads, mems, phases,
                                  "average", health, telemetry, send_frac)
        exchanged, stats = out if telemetry else (out, None)
        upd, opt_state = self.optimizer.update(exchanged[0], opt_state,
                                               flat_params)
        if telemetry:
            return flat_params + upd, opt_state, exchanged, stats
        return flat_params + upd, opt_state, exchanged

    # -------------------------------------------------------------- #
    # the per-tensor path                                            #
    # -------------------------------------------------------------- #

    def init_memory(self, params_tree, device=None) -> Dict:
        """One worker's per-name memory state over every parameter."""
        return self.compressor.memory.init(named_flatten(params_tree).items(),
                                           device)

    def _node_mean_named(self, grads: Sequence[Dict[str, torch.Tensor]],
                         op: str = "average"):
        """Each worker's gradients replaced by its node's mean (two tiers),
        tensor by tensor over the local group."""
        names = list(grads[0])
        out = [{} for _ in grads]
        for n in names:
            for w, g in enumerate(node_mean([g[n] for g in grads],
                                            self.local_comm, op)):
                out[w][n] = g
        return out

    def exchange(self, grads: Sequence[Dict[str, torch.Tensor]],
                 mem_states: List[Dict], phases: Sequence[Dict[str, int]]):
        """Compress, communicate and decompress every gradient of every
        local worker: ``grads[w]`` maps names to worker w's gradients,
        ``phases[w]`` names to its strided-sample phases
        (``compressor.draw_phases``). Returns ``(outs, mem_states)``,
        ``outs[w]`` worker w's exchanged gradients in ``grads[w]``'s
        order (the memories update in place). Under two tiers the node
        mean goes through the exchange over the cross group."""
        comp = self.compressor
        if getattr(comp, "checksum", False):
            raise ValueError(self._PER_TENSOR_CHECKSUM)
        if self.local_size > 1:
            grads = self._node_mean_named(grads)
        comm = self.cross_comm
        names = list(grads[0])
        local = range(len(grads))
        compressed = [{} for _ in local]       # name -> (payload, ctx)
        dense = [{} for _ in local]
        # every local worker's compensates first, in one batched call where
        # the compressor has one (one kernel launch on the card)
        batched = getattr(comp, "compensate_all", None)
        pre = batched(mem_states, grads) if batched is not None else None
        for w in local:
            for name in names:
                done = {} if pre is None or name not in pre[w] else {
                    "compensated": pre[w][name]}
                payload, ctx, mem_states[w] = comp.compress(
                    mem_states[w], name, grads[w][name],
                    phases[w].get(name, 0), **done)
                (compressed if ctx.compressed else dense)[w][name] = (
                    payload, ctx)
        outs = [{} for _ in local]
        for name in dense[0]:
            ctx = dense[0][name][1]
            gathered = comp.communicate([d[name][0] for d in dense], ctx,
                                        comm)
            # every local worker's at once (clipping reduces across them)
            res, mem_states = comp.decompress_all(gathered, ctx, mem_states,
                                                  comm.world)
            for w in local:
                outs[w][name] = res[w]
        if compressed[0]:
            fused = getattr(comp, "exchange_fused", None)
            if self.fuse_payloads and fused is not None and len(
                    compressed[0]) > 1:
                fused_out, mem_states = fused(compressed, comm, comm.world,
                                              mem_states)
                for w in local:
                    outs[w].update(fused_out[w])
            else:
                for name in compressed[0]:
                    ctx = compressed[0][name][1]
                    gathered = comp.communicate(
                        [c[name][0] for c in compressed], ctx, comm)
                    for w in local:
                        outs[w][name], mem_states[w] = comp.decompress(
                            gathered[w], ctx, mem_states[w], comm.world)
        return [{n: o[n] for n in names} for o in outs], mem_states

    def update(self, grads: Sequence[Dict[str, torch.Tensor]], opt_state,
               flat_params: torch.Tensor, mem_states: List[Dict],
               phases: Sequence[Dict[str, int]], layout: ParamLayout):
        """The per-tensor exchange, then one optimizer step on the flat
        parameters over ``layout`` (the first local worker's exchanged
        gradient, which every worker shares). Returns ``(new params, opt
        state, exchanged gradients)``."""
        exchanged, _ = self.exchange(grads, mem_states, phases)
        flat = layout.flatten(exchanged[0], device=flat_params.device)
        upd, opt_state = self.optimizer.update(flat, opt_state, flat_params)
        return flat_params + upd, opt_state, exchanged
