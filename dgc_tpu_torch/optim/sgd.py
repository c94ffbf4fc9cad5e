"""DGC-split SGD over the flat parameter buffer.

Counterpart of ``dgc_tpu/optim/sgd.py``'s ``dgc_sgd`` (reference
``DGCSGD``): gradient momentum was already applied inside the DGC memory
before compression, so the optimizer runs momentum (and nesterov) over the
weight-decay term only, then adds the exchanged gradient raw:
``d_p = wd·p``; ``buf = m·buf + (1-dampening)·d_p`` (first step ``buf =
d_p``); ``d_p = d_p + m·buf`` (nesterov) or ``buf``; ``p <- p - lr·(d_p +
g)``. ``weight_decay_mask`` (a flat 0/1 tensor) gives masked coordinates
no weight decay and leaves their buffer untouched.

``lr`` is a float or a ``step -> float`` schedule evaluated on the host, so
an update launches no host sync.
"""

from typing import Callable, NamedTuple, Optional, Union

import torch

__all__ = ["DGCSGD", "SGDState", "dgc_sgd"]


class SGDState(NamedTuple):
    count: int
    momentum_buffer: Optional[torch.Tensor]


class DGCSGD:
    def __init__(self, lr: Union[float, Callable[[int], float]],
                 momentum: float = 0.9, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 weight_decay_mask: Optional[torch.Tensor] = None):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.weight_decay_mask = weight_decay_mask
        self.use_buf = weight_decay != 0 and momentum != 0

    def init(self, params: torch.Tensor) -> SGDState:
        return SGDState(0, torch.zeros_like(params) if self.use_buf else None)

    def update(self, grad: torch.Tensor, state: SGDState,
               params: torch.Tensor):
        """``(updates, new state)``; the caller adds ``updates`` to the
        parameters."""
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        first = state.count == 0
        m, wd, buf = self.momentum, self.weight_decay, state.momentum_buffer
        mv = self.weight_decay_mask
        if mv is not None:
            d_p = wd * mv * params
            if self.use_buf:
                new_buf = d_p if first else (
                    m * buf + (1 - self.dampening) * d_p)
                new_buf = mv * new_buf + (1 - mv) * buf
                d_p = d_p + m * new_buf if self.nesterov else new_buf
            else:
                new_buf = buf
            upd = -lr * (mv * d_p + grad)
        elif wd != 0:
            d_p = wd * params
            if m != 0:
                new_buf = d_p if first else (
                    m * buf + (1 - self.dampening) * d_p)
                d_p = d_p + m * new_buf if self.nesterov else new_buf
            else:
                new_buf = buf
            upd = -lr * (d_p + grad)
        else:
            new_buf = buf
            upd = -lr * grad
        return upd, SGDState(state.count + 1, new_buf)


def dgc_sgd(lr, momentum: float = 0.9, dampening: float = 0.0,
            weight_decay: float = 0.0, nesterov: bool = False,
            weight_decay_mask: Optional[torch.Tensor] = None) -> DGCSGD:
    """The reference's constructor name for :class:`DGCSGD`."""
    return DGCSGD(lr, momentum, dampening, weight_decay, nesterov,
                  weight_decay_mask)
