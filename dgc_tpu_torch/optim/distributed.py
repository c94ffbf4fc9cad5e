"""Distributed optimizer — compressed exchange, then the base optimizer.

Counterpart of ``dgc_tpu/optim/distributed.py``'s flat path
(``make_flat`` / ``update_flat``): the compressor's flat engine exchanges
the flat gradients of this process's workers over a :class:`Comm`, and
the wrapped optimizer steps the (replicated) flat parameters with the
exchanged gradient.
"""

from typing import List, Sequence

import torch

from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.parallel.comm import Comm

__all__ = ["DistributedOptimizer"]


class DistributedOptimizer:
    def __init__(self, optimizer, compressor, comm: Comm):
        self.optimizer = optimizer
        self.compressor = compressor
        self.comm = comm

    def init(self, flat_params: torch.Tensor):
        return self.optimizer.init(flat_params)

    def make_flat(self, params_tree):
        """The ``(ParamLayout, engine)`` pair; call again after the warm-up
        schedule changes the ratio (the layout does not change)."""
        layout = ParamLayout.for_compressor(params_tree, self.compressor)
        return layout, self.compressor.make_flat_exchange(layout)

    def update_flat(self, flat_grads: Sequence[torch.Tensor], opt_state,
                    flat_params: torch.Tensor, mems: List, phases,
                    engine):
        """Exchange every local worker's gradient (memories update in
        place), then one optimizer step on the replicated parameters.
        Every local worker's exchanged gradient is the same, so the first
        one drives the step. Returns ``(new params, opt state,
        exchanged gradients)``."""
        exchanged = engine.exchange(flat_grads, mems, phases, self.comm)
        upd, opt_state = self.optimizer.update(exchanged[0], opt_state,
                                               flat_params)
        return flat_params + upd, opt_state, exchanged
