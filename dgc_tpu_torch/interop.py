"""Weights carry between the JAX package and the port.

The port's models (CIFAR and ImageNet ResNets) keep flax's parameter
names and layouts (HWIO conv kernels, ``[in, out]`` dense kernels, BatchNorm
``scale``/``bias``/``mean``/``var``), and its flat buffers the reference's
layouts, so carrying a flax model's ``params`` / ``batch_stats`` (nested
dicts of numpy arrays, e.g. from ``jax.device_get``) over is a flatten by
name into the port's buffers, and the reverse an unflatten; no array is
transposed (the models permute HWIO to PyTorch's OIHW inside ``forward``).
Parity tests use this to make both packages compute the same thing from
the same weights.

The per-tensor path's memory state (``{"momentums": {name: 1-D array},
"velocities": {name: 1-D array}}``, the reference's checkpoint format)
carries both ways too: :func:`carry_memory` keeps each array's dtype (a
bf16 state, ml_dtypes' ``bfloat16`` in numpy, arrives as ``torch.bfloat16``
bit for bit); :func:`export_memory` writes a bf16 state as float32, which
holds every bf16 value exactly (numpy has no bf16 of its own, and the
reference's ``load_state_dict`` casts to the live state's dtype).

The optimizers' state (``SGDState``: the step count and the momentum
buffer, or none) carries across with :func:`carry_opt_state`, and a whole
flat train state (e.g. one the JAX ``CheckpointManager`` restored: the
flat parameters and optimizer state, and the memory and BatchNorm
statistics with their leading ``[world]`` axis) with
:func:`carry_train_state`, which also carries the step guards' state
(:func:`carry_guard_state`) and, under the Adasum scheme, the optimizer
state per worker (:func:`carry_per_worker_opt_state`, from its leading
``[world]`` axis).
"""

from typing import Dict, Tuple

import numpy as np
import torch

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.optim.sgd import SGDState
from dgc_tpu_torch.training.state import TrainState
from dgc_tpu_torch.utils.pytree import named_flatten, nest

__all__ = ["carry_variables", "export_variables", "carry_memory",
           "export_memory", "carry_opt_state", "carry_train_state",
           "carry_guard_state", "carry_per_worker_opt_state"]

_MEMORY_KEYS = ("momentums", "velocities")


def carry_variables(params, batch_stats, layout: ParamLayout,
                    stats_layout: ParamLayout, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` -> the port's flat parameter and
    statistics buffers. Raises when a tree's names or shapes are not the
    layout's."""
    for tree, lay in ((params, layout), (batch_stats, stats_layout)):
        got = {n: tuple(getattr(a, "shape", ())) for n, a in
               named_flatten(tree).items()}
        if got != lay.shapes:
            raise ValueError("the flax tree does not match the model: "
                             f"{sorted(set(got) ^ set(lay.shapes))[:4]} "
                             "differ by name, or a shape differs")
    return (layout.flatten(params, device=device),
            stats_layout.flatten(batch_stats, device=device))


def export_variables(flat_params: torch.Tensor, flat_stats: torch.Tensor,
                     layout: ParamLayout, stats_layout: ParamLayout
                     ) -> Tuple[Dict, Dict]:
    """The port's flat buffers -> flax-shaped nested dicts of numpy
    arrays."""
    def tree(flat, lay):
        return nest({n: v.detach().cpu().numpy().copy() for n, v in
                     lay.unflatten_named(flat).items()})
    return tree(flat_params, layout), tree(flat_stats, stats_layout)



def carry_memory(state, device=None) -> Dict:
    """The JAX package's per-name memory state (numpy arrays, e.g. from
    ``jax.device_get``) -> the port's: 1-D tensors on ``device`` in each
    array's dtype."""
    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.reshape(-1).to(device)
    return {k: {n: tensor(a) for n, a in state[k].items()}
            for k in _MEMORY_KEYS}


def export_memory(state) -> Dict:
    """The port's per-name memory state -> numpy arrays (bf16 as float32,
    exactly)."""
    def array(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return {k: {n: array(t) for n, t in state[k].items()}
            for k in _MEMORY_KEYS}


def carry_opt_state(state, device=None) -> SGDState:
    """The JAX package's ``SGDState`` of ``sgd`` or ``dgc_sgd`` over the
    flat parameters (numpy arrays, e.g. from ``jax.device_get``) -> the
    port's: the count as an int, the momentum buffer, where it has one, as
    a tensor on ``device``."""
    buf = state.momentum_buffer
    if buf is not None:
        buf = torch.from_numpy(np.array(buf, np.float32)).to(device)
    return SGDState(int(state.count), buf)


def carry_guard_state(gstate, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's guard state (``resilience.guard.init_state``'s
    keys, numpy arrays) -> the port's: the same keys and dtypes."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in gstate.items()}


def carry_per_worker_opt_state(state, device=None) -> list:
    """The Adasum scheme's per-worker ``SGDState`` (each field with a
    leading ``[world]`` axis) -> one port ``SGDState`` a worker."""
    counts = np.asarray(state.count).reshape(-1)
    buf = state.momentum_buffer
    return [SGDState(int(c), None if buf is None else torch.from_numpy(
        np.array(np.asarray(buf)[w], np.float32)).to(device))
        for w, c in enumerate(counts)]


def carry_train_state(state, device=None,
                      per_worker_opt: bool = False) -> TrainState:
    """The JAX package's flat ``TrainState`` (numpy arrays, e.g. from
    ``jax.device_get``: ``params`` and ``batch_stats`` the flat buffers,
    the memory a dict of ``[world, ...]`` arrays, the guards' state where
    it has one; ``per_worker_opt``: the optimizer state has a leading
    ``[world]`` axis, the Adasum scheme) -> the port's, one memory dict
    and statistics buffer (and optimizer state) per worker, bit for
    bit."""
    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)
    stats = np.asarray(state.batch_stats)
    mem = {k: np.asarray(v) for k, v in state.memory.items()}
    guards = getattr(state, "guards", None)
    return TrainState(
        step=int(state.step), params=tensor(state.params),
        opt_state=(carry_per_worker_opt_state(state.opt_state, device)
                   if per_worker_opt
                   else carry_opt_state(state.opt_state, device)),
        memory=[{k: tensor(v[w]) for k, v in mem.items()}
                for w in range(stats.shape[0])],
        batch_stats=[tensor(s) for s in stats],
        guards=None if guards is None else carry_guard_state(guards, device))
