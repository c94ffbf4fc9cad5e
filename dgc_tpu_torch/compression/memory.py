"""Momentum-correction memory settings.

Counterpart of ``dgc_tpu/compression/memory.py``'s ``DGCSGDMemory``. The
flat engine owns the buffers and the arithmetic (the compensate kernel and
the dense-tail correction); this object carries only the configuration.
"""

from typing import Callable, Optional

__all__ = ["DGCSGDMemory"]


class DGCSGDMemory:
    """``momentum``/``nesterov`` of the momentum correction,
    ``momentum_masking`` (zero the momentum as well as the velocity at
    transmitted coordinates), and an optional per-tensor
    ``gradient_clipping`` callable, which this slice does not run."""

    def __init__(self, momentum: float = 0.9, nesterov: bool = False,
                 gradient_clipping: Optional[Callable] = None,
                 momentum_masking: bool = True):
        if gradient_clipping is not None:
            raise ValueError("gradient clipping is not ported yet")
        self.momentum = momentum
        self.nesterov = nesterov
        self.gradient_clipping = gradient_clipping
        self.momentum_masking = momentum_masking
