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
from dgc_tpu_torch.training.state import TrainState

__all__ = ["FlatSetup", "make_flat_setup", "make_per_tensor_setup",
           "make_flat_state", "train_step", "train_step_per_tensor",
           "worker_grad", "eval_step", "topk_hits"]


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
                    flat_params=None, flat_stats=None) -> TrainState:
    """Initial state from the model's own weights, or from given flat
    buffers (e.g. carried from the JAX package). The memory is the flat
    engine's, or the per-name state of the per-tensor path when
    ``setup`` has no engine."""
    if flat_params is None:
        flat_params = setup.layout.flatten(param_tree(model), device=device)
    if flat_stats is None:
        flat_stats = setup.stats_layout.flatten(stats_tree(model),
                                                device=device)
    local = len(dist_opt.comm.ranks)
    return TrainState(
        step=0, params=flat_params.to(device),
        opt_state=dist_opt.init(flat_params.to(device)),
        memory=[setup.engine.init_memory(device) if setup.engine is not None
                else dist_opt.init_memory(param_tree(model), device)
                for _ in range(local)],
        batch_stats=[flat_stats.to(device).clone() for _ in range(local)])


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
               dropout_gens: Optional[Sequence[torch.Generator]] = None):
    """One step for this process's workers (``images[w]`` / ``labels[w]``
    / ``gens[w]`` / ``dropout_gens[w]`` per local worker). Returns
    ``(state, mean loss)``; the loss stays on the device."""
    comm = dist_opt.comm
    grads: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    for w in range(len(comm.ranks)):
        g, loss = worker_grad(model, setup, state.params,
                              state.batch_stats[w], images[w], labels[w],
                              nbps, dropout_gens[w] if dropout_gens else None)
        grads.append(g)
        losses.append(loss)
    phases = [setup.engine.draw_phases(gen) for gen in gens]
    params, opt_state, _ = dist_opt.update_flat(
        grads, state.opt_state, state.params, state.memory, phases,
        setup.engine)
    mean_loss = comm.all_reduce(losses)[0] / comm.world
    state.step += 1
    state.params = params
    state.opt_state = opt_state
    return state, mean_loss


def train_step_per_tensor(model, setup: FlatSetup, dist_opt,
                          state: TrainState,
                          images: Sequence[torch.Tensor],
                          labels: Sequence[torch.Tensor],
                          gens: Sequence[torch.Generator], nbps: int = 1):
    """One per-tensor step for this process's workers (``setup`` from
    :func:`make_per_tensor_setup`, ``state.memory`` per-name): each
    worker's gradients as ``{name: tensor}``, the distributed optimizer's
    per-tensor ``update`` (phases drawn from ``gens[w]``), the loss
    all-reduce. Returns ``(state, mean loss)``; the loss stays on the
    device."""
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
