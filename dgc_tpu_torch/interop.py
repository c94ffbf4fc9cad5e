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
"""

from typing import Dict, Tuple

import numpy as np
import torch

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.utils.pytree import named_flatten, nest

__all__ = ["carry_variables", "export_variables", "carry_memory",
           "export_memory"]

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
