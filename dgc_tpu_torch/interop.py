"""Weights carry between the JAX package and the port.

The port keeps the reference's flat layouts, so carrying a flax model's
``params`` / ``batch_stats`` (nested dicts of numpy arrays, e.g. from
``jax.device_get``) over is a flatten into the port's buffers, and the
reverse an unflatten. Parity tests use this to make both packages compute
the same thing from the same weights.
"""

from typing import Dict, Tuple

import torch

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.utils.pytree import nest

__all__ = ["carry_variables", "export_variables"]


def carry_variables(params, batch_stats, layout: ParamLayout,
                    stats_layout: ParamLayout, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` -> the port's flat parameter and
    statistics buffers."""
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

