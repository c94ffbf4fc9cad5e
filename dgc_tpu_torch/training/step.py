"""The data-parallel DGC train steps: the flat step and the per-tensor one.

Counterpart of ``dgc_tpu/training/step.py``: :func:`train_step` is its flat
path (``flat=make_flat_setup(...)``), :func:`train_step_per_tensor` its
``flat=None`` path. Both keep the parameters and the BatchNorm statistics
in flat buffers (:class:`ParamLayout`); the per-tensor step uses them as
storage only and exchanges tensor by tensor.

The flat step, per local worker:
forward/backward over ``num_batches_per_step`` micro-batches (each loss
scaled by ``1/nbps``, gradients summed) with the parameters bound as views
of the flat buffer, so autograd delivers the flat gradient directly and
BatchNorm updates that worker's flat statistics in place. Then one
exchange across all workers (compensate -> sparsify -> all_gather ->
apply, plus the dense-tail all-reduce), the ``dgc_sgd`` update of the
replicated parameters, and the loss all-reduce.

As in the reference, the weights that ``ParamLayout.convert_hoist_risky``
names are bound through an opaque copy instead of a view of the flat
buffer: ``kernels.opaque_view_from`` (read straight from the flat buffer)
where the view is tile-aligned, else ``kernels.opaque_view`` of the view.
Both pass the gradient through unchanged, so the step computes the same
numbers either way.

The per-tensor step binds the weights as the flat step does (the opaque
copies change no number), hands each worker's gradients to the
distributed optimizer's ``update`` as ``{name: view of the flat
gradient}`` (the compressor's ``compress`` -> ``communicate`` ->
``decompress`` per tensor, the memory's compensate through the
``fused_compensate`` kernel), and steps the flat parameters with
``dgc_sgd`` over the flattened exchanged gradient (elementwise, so the
same numbers as per tensor). The JAX harness has no switch for it, so
neither has the port's CLI: this function is the path's entry point, as
``build_train_step(flat=None)`` is there.

A model that draws dropout (VGG-16-BN's classifier) takes each worker's
masks from that worker's own ``torch.Generator`` on the device
(``dropout_gens[w]``; the JAX harness folds a dropout key per worker and
micro-batch instead). A model whose compute dtype is narrower than f32
(``configs/bf16.py``) is the reference's ``model_dtype`` path: the step
differentiates with respect to the f32 [P] buffer through one cast of it
to that dtype, and the model binds plain views of the narrow copy (no
opaque copies), so the gradient, the optimizer and the whole compression
pipeline stay f32.

Guards (``train_step(..., guards=GuardConfig(...))``, the reference's
``build_train_step(guards=...)``): an armed ``nan@K`` fault poisons the
gradients after the backward; each worker's non-finite flag rides the
loss all-reduce as a stacked ``[2]`` vector (no extra collective);
:func:`~dgc_tpu_torch.resilience.guard.apply` decides the skip on the
device, and a skipped step is reverted atomically — the parameters, the
optimizer state, every worker's whole memory (its transmit record
included) and BatchNorm statistics take their pre-step values (the memory
and the statistics are written in place, so the guarded step copies them
first; the unguarded step copies nothing). The exchange still runs on a
skipped step, so its checksum count and its phase draws are kept, as in
the reference. The guarded step returns ``{"loss", "step", "guards"}``.

Telemetry (``train_step(..., telemetry=True)``, the reference's
``build_train_step(telemetry=...)``): the engine returns each worker's
``STEP_METRICS`` and the step means them in one packed all-reduce
(``telemetry.taps.pmean_stats``); with ``fleet=True`` one packed all-gather
gives the means and the per-worker fleet lanes instead
(``telemetry.fleet.gather_stats``), fed the host's prep interval as
``clock``; with ``adaptive=AdaptiveConfig(...)`` each worker sends last
step's ``state.adaptive["w_frac"][rank]`` of its quota and the next
fractions come from the gathered clocks. The stats stay on the device.
The stages run inside the phase markers ``fwd_bwd``, ``update`` and
``loss`` (``telemetry.trace``; nothing while tracing is off).

The flat step also runs the dense baseline's engine
(:class:`~dgc_tpu_torch.compression.flat.FlatDenseExchange`), which
samples nothing and keeps no memory. :func:`eval_step` is the
reference's ``build_eval_step``: each worker's top-k hit counts with its
own BatchNorm statistics, summed over the workers.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.models import (compute_dtype, param_tree, stats_tree,
                                  uses_dropout)
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.resilience import adaptive as _adaptive
from dgc_tpu_torch.resilience import faults as _faults
from dgc_tpu_torch.resilience import guard as _guard
from dgc_tpu_torch.telemetry import fleet as _fleet
from dgc_tpu_torch.telemetry import taps as _taps
from dgc_tpu_torch.telemetry.trace import phase
from dgc_tpu_torch.training.state import TrainState

__all__ = ["FlatSetup", "make_flat_setup", "make_per_tensor_setup",
           "make_flat_state", "train_step", "train_step_per_tensor",
           "worker_grad", "eval_step", "topk_hits", "resolve_pending_skip"]


class FlatSetup(NamedTuple):
    layout: ParamLayout        # over the parameters
    stats_layout: ParamLayout  # over the BatchNorm statistics
    engine: object             # the compressor's flat engine; None for
                               # the per-tensor path


def make_flat_setup(model, dist_opt, plan=None) -> FlatSetup:
    """Layouts + engine; rebuild after a warm-up ratio change. ``plan``:
    the exchange plan, re-fit to the fresh bucket geometry."""
    layout, engine = (dist_opt.make_flat(param_tree(model)) if plan is None
                      else dist_opt.make_flat(param_tree(model), plan=plan))
    return FlatSetup(layout, ParamLayout(stats_tree(model)), engine)


def make_per_tensor_setup(model, dist_opt) -> FlatSetup:
    """The per-tensor path's layouts (the flat engine's, as storage) and no
    engine: the exchange reads the compressor's attributes live, so a
    warm-up ratio change needs no rebuild."""
    return FlatSetup(ParamLayout.for_compressor(param_tree(model),
                                                dist_opt.compressor),
                     ParamLayout(stats_tree(model)), None)


def make_flat_state(model, dist_opt, setup: FlatSetup, device,
                    flat_params=None, flat_stats=None,
                    guards=None, adaptive=None) -> TrainState:
    """Initial state from the model's own weights, or from given flat
    buffers (e.g. carried from the JAX package). The memory is the flat
    engine's, or the per-name state of the per-tensor path when
    ``setup`` has no engine; the optimizer state one a local worker under
    the Adasum scheme; ``guards``: a ``GuardConfig`` whose fresh state the
    train state carries; ``adaptive``: an ``AdaptiveConfig`` whose policy
    state (every worker at full send fraction) it carries."""
    if flat_params is None:
        flat_params = setup.layout.flatten(param_tree(model), device=device)
    if flat_stats is None:
        flat_stats = setup.stats_layout.flatten(stats_tree(model),
                                                device=device)
    local = len(dist_opt.comm.ranks)
    params = flat_params.to(device)
    return TrainState(
        step=0, params=params,
        opt_state=(dist_opt.init_per_worker(params)
                   if dist_opt.per_worker_opt_state
                   else dist_opt.init(params)),
        memory=[setup.engine.init_memory(device) if setup.engine is not None
                else dist_opt.init_memory(param_tree(model), device)
                for _ in range(local)],
        batch_stats=[flat_stats.to(device).clone() for _ in range(local)],
        guards=None if guards is None else _guard.init_state(guards, device),
        adaptive=(None if adaptive is None
                  else _adaptive.init_state(dist_opt.comm.world, device)))


def _read_later(skip: torch.Tensor):
    """``(host copy, event)`` of a device verdict, copied without a sync:
    waiting on the event later waits for this step's end only, not for
    the work queued after it."""
    if skip.device.type != "cuda":
        return skip, None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(skip, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def resolve_pending_skip(state: TrainState) -> TrainState:
    """Read the last guarded step's skip verdict and take back the
    optimizer state's step count where it skipped: the count is a host
    int, the rest of the revert happened on the device. The read waits
    (one host sync) only while the device is still on that step."""
    pending = state.pending_skip
    if pending is None:
        return state
    state.pending_skip = None
    skip, ready = pending
    if ready is not None and not ready.query():
        # the device is still on that step: wait for its end only
        ready.synchronize()
    if bool(skip):
        if isinstance(state.opt_state, list):
            state.opt_state = [s._replace(count=s.count - 1)
                               for s in state.opt_state]
        else:
            state.opt_state = state.opt_state._replace(
                count=state.opt_state.count - 1)
    return state


def _binding(layout: ParamLayout, flat: torch.Tensor):
    """``{module path: tensor}`` over ``flat``: views, and the opaque copies
    of the layout's convert-hoist-risky weights (compressed ones only)."""
    views = layout.unflatten_named(flat)
    for n in layout.convert_hoist_risky():
        base, size = layout.offsets[n], layout.sizes[n]
        if kernels.opaque_view_eligible(layout.total, base, size):
            views[n] = kernels.opaque_view_from(flat, base, size).view(
                layout.shapes[n])
        else:
            views[n] = kernels.opaque_view(views[n])
    return {n.replace("/", "."): v for n, v in views.items()}


def _narrow_binding(layout: ParamLayout, flat: torch.Tensor,
                    dtype: torch.dtype):
    """``{module path: view}`` of one cast of ``flat`` to ``dtype``."""
    return {n.replace("/", "."): v for n, v in
            layout.unflatten_named(flat.to(dtype)).items()}


def worker_grad(model, setup: FlatSetup, params: torch.Tensor,
                stats: torch.Tensor, images: torch.Tensor,
                labels: torch.Tensor, nbps: int = 1,
                dropout_gen: Optional[torch.Generator] = None):
    """One worker's flat [P] f32 gradient and (scaled, summed) loss;
    ``stats`` is updated in place. ``images`` NCHW, ``labels`` int64;
    ``dropout_gen`` draws the masks of a model with dropout. A model
    computing in a narrower dtype binds views of one cast of the
    parameters."""
    fp = params.detach().requires_grad_(True)
    dtype = compute_dtype(model)
    binding = {**(_narrow_binding(setup.layout, fp, dtype)
                  if dtype.itemsize < 4 else _binding(setup.layout, fp)),
               **_binding(setup.stats_layout, stats)}
    kwargs = {"train": True}
    if uses_dropout(model):
        kwargs["dropout_generator"] = dropout_gen
    loss_sum = torch.zeros((), device=params.device)
    for x, y in zip(images.chunk(nbps), labels.chunk(nbps)):
        logits = functional_call(model, binding, (x,), kwargs)
        loss = F.cross_entropy(logits.float(), y) * (1.0 / nbps)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    return fp.grad, loss_sum


def train_step(model, setup: FlatSetup, dist_opt, state: TrainState,
               images: Sequence[torch.Tensor], labels: Sequence[torch.Tensor],
               gens: Sequence[torch.Generator], nbps: int = 1,
               dropout_gens: Optional[Sequence[torch.Generator]] = None,
               guards: Optional[_guard.GuardConfig] = None,
               faults: Optional[_faults.FaultPlan] = None,
               telemetry: bool = False, fleet: bool = False,
               adaptive: Optional[_adaptive.AdaptiveConfig] = None,
               clock: Optional[torch.Tensor] = None):
    """One step for this process's workers (``images[w]`` / ``labels[w]``
    / ``gens[w]`` / ``dropout_gens[w]`` per local worker). Returns
    ``(state, mean loss)``, the loss on the device; with ``guards``
    (``state.guards`` must hold their state) or ``telemetry``
    ``(state, metrics)``: ``"loss"``, with guards ``"step"`` and
    ``"guards"``, with telemetry ``"telemetry"`` (the ``STEP_METRICS``
    mean over every worker, one packed all-reduce) and with ``fleet``
    ``"fleet"`` (``FLEET_METRICS``: one packed all-gather gives both,
    :func:`~dgc_tpu_torch.telemetry.fleet.gather_stats`), all on the
    device. ``faults``: the armed fault plan (``nan@K``).

    ``fleet`` needs ``telemetry`` and ``clock``, the [world] f32 prep
    interval (``telemetry.fleet.make_clock``; worker r reads ``clock[r]``;
    host wall clock taken outside the step). ``adaptive`` (an
    ``AdaptiveConfig``; needs ``fleet`` and a state made with
    ``make_flat_state(..., adaptive=cfg)``): each worker sends last step's
    ``state.adaptive["w_frac"][rank]`` of its quota, and the next verdict
    is computed from the gathered ``w_clock`` lane (no collective more).
    Telemetry needs the flat engine (``setup.engine``), as in the
    reference."""
    engine = setup.engine
    if fleet and not telemetry:
        raise ValueError("fleet dispersion taps require telemetry=True "
                         "(they extend the telemetry lane)")
    if adaptive is not None and not fleet:
        raise ValueError("adaptive straggler exchange requires fleet=True "
                         "(the policy reads the gathered w_clock lane)")
    if telemetry and engine is None:
        raise ValueError("telemetry taps require the flat engine path "
                         "(pass setup=make_flat_setup(...))")
    if fleet and clock is None:
        raise ValueError("fleet=True needs clock= (telemetry.fleet."
                         "make_clock of the host's prep interval)")
    if adaptive is not None and state.adaptive is None:
        raise ValueError("adaptive= needs a state made with "
                         "make_flat_state(..., adaptive=cfg)")
    if getattr(engine, "checksum", False) and guards is None:
        raise ValueError(
            "DGCCompressor(checksum=True) needs guards= on the train step — "
            "the mismatch counter travels in the guard metrics")
    if guards is not None and state.guards is None:
        raise ValueError("guards= needs a state made with "
                         "make_flat_state(..., guards=cfg)")
    comm = dist_opt.comm
    if guards is not None:
        # the pre-step values a skip restores: the statistics are written
        # during the forward and the memory during the exchange, in place
        stats0 = _guard.snapshot(state.batch_stats)
    grads: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    with phase("fwd_bwd"):
        for w in range(len(comm.ranks)):
            g, loss = worker_grad(model, setup, state.params,
                                  state.batch_stats[w], images[w],
                                  labels[w], nbps,
                                  dropout_gens[w] if dropout_gens else None)
            grads.append(g)
            losses.append(kernels.vtag(loss, "dgcver.src.loss"))
    grads = _faults.inject_nan_grads(faults, grads, state.step)
    phases = [engine.draw_phases(gen) for gen in gens]
    resolve_pending_skip(state)
    kw = {}
    if telemetry:
        kw["telemetry"] = True
    frac = None
    if adaptive is not None:
        # each worker's send fraction: LAST step's replicated verdict
        frac = kw["send_frac"] = [state.adaptive["w_frac"][r]
                                  for r in comm.ranks]
    if guards is not None:
        mem0 = _guard.snapshot(state.memory)
        kw["health"] = {} if getattr(engine, "checksum", False) else None
    with phase("update"):
        out = dist_opt.update_flat(grads, state.opt_state, state.params,
                                   state.memory, phases, engine, **kw)
    params, opt_state = out[0], out[1]
    with phase("loss"):
        if guards is None:
            mean_loss = comm.all_reduce(losses)[0] / comm.world
        else:
            # the flag rides the loss all-reduce: one collective, as
            # unguarded
            packed = comm.all_reduce([torch.stack([
                loss, _guard.nonfinite_flag(g, loss)])
                for g, loss in zip(grads, losses)])[0]
            mean_loss = packed[0] / comm.world
    metrics = {"loss": mean_loss}
    if fleet:
        # ONE packed all_gather yields the telemetry means AND the
        # per-worker dispersion columns (it replaces the all-reduce)
        g_stale = g_forced = None
        if "gossip_age" in state.memory[0]:
            # gossip on: the ages are replicated by construction, so each
            # worker reads its own entry, no collective
            g_stale = [m["gossip_age"][r]
                       for m, r in zip(state.memory, comm.ranks)]
            g_forced = state.memory[0]["gossip_forced"]
        metrics["telemetry"], metrics["fleet"] = _fleet.gather_stats(
            out[3], comm, clock=clock, total_elems=setup.layout.total,
            eff_ratio=frac, staleness=g_stale, forced=g_forced)
    elif telemetry:
        metrics["telemetry"] = _taps.pmean_stats(out[3], comm)
    if adaptive is not None:
        # next step's verdict from this step's gathered clock column: a
        # pure function of gathered values, memoryless
        state.adaptive = {"w_frac": _adaptive.update_policy(
            adaptive, metrics["fleet"]["w_clock"])}
    if guards is None:
        state.step += 1
        state.params = params
        state.opt_state = opt_state
        return state, (metrics if telemetry else mean_loss)
    skip, gstate, gmetrics = _guard.apply(
        guards, kernels.vtag(state.guards, "dgcver.src.guards"),
        bad_count=packed[1], mean_loss=mean_loss,
        checksum_failures=(kw["health"] or {}).get("checksum_failures"))
    state.params = _guard.tree_select(skip, state.params, params)
    state.opt_state = _guard.tree_select(skip, state.opt_state, opt_state)
    state.memory = _guard.tree_select(skip, mem0, state.memory)
    state.batch_stats = _guard.tree_select(skip, stats0, state.batch_stats)
    state.guards = gstate
    state.pending_skip = _read_later(skip)
    metrics.update(step=state.step, guards=gmetrics)
    state.step += 1
    return state, metrics


def train_step_per_tensor(model, setup: FlatSetup, dist_opt,
                          state: TrainState,
                          images: Sequence[torch.Tensor],
                          labels: Sequence[torch.Tensor],
                          gens: Sequence[torch.Generator], nbps: int = 1,
                          telemetry: bool = False):
    """One per-tensor step for this process's workers (``setup`` from
    :func:`make_per_tensor_setup`, ``state.memory`` per-name): each
    worker's gradients as ``{name: tensor}``, the distributed optimizer's
    per-tensor ``update`` (phases drawn from ``gens[w]``), the loss
    all-reduce. Returns ``(state, mean loss)``; the loss stays on the
    device. The step guards and the telemetry taps are the flat path's,
    as in the reference: ``telemetry=True`` is refused."""
    if telemetry:
        raise ValueError("telemetry taps require the flat engine path "
                         "(pass setup=make_flat_setup(...))")
    comm = dist_opt.comm
    grads: List[dict] = []
    losses: List[torch.Tensor] = []
    for w in range(len(comm.ranks)):
        g, loss = worker_grad(model, setup, state.params,
                              state.batch_stats[w], images[w], labels[w],
                              nbps)
        grads.append(setup.layout.unflatten_named(g))
        losses.append(loss)
    phases = [dist_opt.compressor.draw_phases(gen) for gen in gens]
    params, opt_state, _ = dist_opt.update(
        grads, state.opt_state, state.params, state.memory, phases,
        setup.layout)
    mean_loss = comm.all_reduce(losses)[0] / comm.world
    state.step += 1
    state.params = params
    state.opt_state = opt_state
    return state, mean_loss


def topk_hits(logits: torch.Tensor, labels: torch.Tensor,
              k: int) -> torch.Tensor:
    """Per example, whether the label is among the ``k`` largest logits
    with ties to the lower class, as ``lax.top_k`` orders them, counted
    without a sort: ``#{j : l_j > l_y} + #{j < y : l_j == l_y} < k``."""
    ly = logits.gather(1, labels[:, None])
    cls = torch.arange(logits.shape[1], device=logits.device)[None, :]
    ahead = (logits > ly) | ((logits == ly) & (cls < labels[:, None]))
    return ahead.sum(dim=1) < min(k, logits.shape[1])


def eval_step(model, setup: FlatSetup, params: torch.Tensor,
              batch_stats: Sequence[torch.Tensor],
              images: Sequence[torch.Tensor], labels: Sequence[torch.Tensor],
              comm, topk: Tuple[int, ...] = (1, 5)
              ) -> Dict[str, torch.Tensor]:
    """Inference of each local worker's batch (``images[w]`` NCHW,
    ``labels[w]`` int64) with its own BatchNorm statistics
    (``batch_stats[w]``): ``{"top{k}": hits, "count": examples}``, int64
    tensors summed over every worker with ``comm.all_reduce``."""
    counts: Dict[str, List[torch.Tensor]] = {f"top{k}": [] for k in topk}
    counts["count"] = []
    with torch.no_grad():
        for stats, x, y in zip(batch_stats, images, labels):
            binding = {**_binding(setup.layout, params),
                       **_binding(setup.stats_layout, stats)}
            logits = functional_call(model, binding, (x,),
                                     {"train": False}).float()
            for k in topk:
                counts[f"top{k}"].append(
                    topk_hits(logits, y, k).sum(dtype=torch.int64))
            counts["count"].append(torch.tensor(y.shape[0],
                                                device=y.device))
    return {key: comm.all_reduce(v)[0] for key, v in counts.items()}
