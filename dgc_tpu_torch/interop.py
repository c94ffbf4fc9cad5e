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
"""

from typing import Dict, Tuple

import torch

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.utils.pytree import named_flatten, nest

__all__ = ["carry_variables", "export_variables"]


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

