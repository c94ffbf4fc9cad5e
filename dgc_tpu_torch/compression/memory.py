"""Error-feedback memory for DGC momentum correction.

Counterpart of ``dgc_tpu/compression/memory.py``. A memory object holds
configuration; its state is a dict ``{"momentums": {name: 1-D tensor},
"velocities": {name: 1-D tensor}}`` that the caller keeps, one per worker.
The per-tensor path (``DGCCompressor.compress`` / ``decompress``) runs the
methods below over that state; they update its tensors IN PLACE (the
reference returns new arrays) and return the state. The per-tensor
exchange compensates every compressed tensor of every local worker first,
in one batched call (:meth:`DGCSGDMemory.compensate_all`).

The flat engine (:mod:`dgc_tpu_torch.compression.flat`) keeps its own flat
buffers and reads only ``momentum``, ``nesterov``, ``momentum_masking``
and ``gradient_clipping`` from here (and ``dtype``: f32 or bf16 state).

``gradient_clipping`` (:mod:`dgc_tpu_torch.utils.clip_grad`) is called
with one tensor per local worker (:meth:`DGCSGDMemory.clip`), so its
global variants can reduce across workers; it must be padding-invariant
(appended zeros change no norm and clip back to zero), because the flat
engine clips whole buckets as [R, cols] row views.
"""

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.ops.sparsify import transmitted_mask

__all__ = ["Memory", "DGCSGDMemory", "ELASTIC_ADDITIVE_PREFIXES"]

#: how an elastic restart (``resilience.elastic``) reshards a memory key
#: across a world-size change: a key whose name starts with one of these
#: is additive error-feedback mass (the gradient a worker has not yet
#: sent), so merging workers sums it; any other key but the flat engine's
#: transmit record ``sent_bits`` and the gossip round state is refused.
#: ``gossip_inbox`` is neighbor mass the gossip exchange has received and
#: not yet folded into the velocity (compression.gossip): additive for the
#: same reason. The gossip clock, ages and forced count are not additive:
#: resilience/elastic.py reshards them by their own rules.
ELASTIC_ADDITIVE_PREFIXES = ("momentums", "velocities", "gossip_inbox")


class Memory:
    """No-op memory: the identity plugin (no state, nothing to correct)."""

    dtype = None
    gradient_clipping: Optional[Callable] = None

    def init(self, named_params, device=None) -> Dict:
        return {}

    def compensate(self, state: Dict, name: str, grad,
                   accumulate: bool = True, clipped: bool = False):
        return grad, state

    def update(self, state: Dict, name: str, indices, valid) -> Dict:
        return state

    def feed_back(self, state: Dict, name: str, indices, residual) -> Dict:
        return state

    def state_dict(self, state: Dict):
        return None

    def load_state_dict(self, state: Dict, saved) -> Dict:
        return state


def _dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class DGCSGDMemory(Memory):
    """Momentum-correction memory for DGC with an SGD-momentum base
    optimizer: ``momentum``/``nesterov`` of the correction,
    ``momentum_masking`` (zero the momentum as well as the velocity at
    transmitted coordinates) and ``dtype``, the state's dtype (``None``:
    the parameter's; ``"bfloat16"``: the bf16 error-feedback state, math
    in the gradient's dtype with one rounding per stored value), and
    ``gradient_clipping``, a callable applied to the gradient before each
    correction (see the module docstring)."""

    def __init__(self, momentum: float = 0.9, nesterov: bool = False,
                 gradient_clipping: Optional[Callable] = None,
                 momentum_masking: bool = True, dtype=None):
        self.momentum = momentum
        self.nesterov = nesterov
        self.gradient_clipping = gradient_clipping
        self.momentum_masking = momentum_masking
        self.dtype = _dtype(dtype)

    def init(self, named_params, device=None) -> Dict:
        """Zero 1-D (momentum, velocity) buffers for every ``(name,
        tensor or array)``, on ``device`` (the tensor's by default)."""
        momentums, velocities = {}, {}
        for name, p in named_params:
            if not torch.is_tensor(p):      # its size and dtype only
                p = torch.from_numpy(np.empty(np.shape(p),
                                              np.asarray(p).dtype))
            dt = self.dtype or p.dtype
            dev = p.device if device is None else device
            momentums[name] = torch.zeros(p.numel(), dtype=dt, device=dev)
            velocities[name] = torch.zeros(p.numel(), dtype=dt, device=dev)
        return {"momentums": momentums, "velocities": velocities}

    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``gradient_clipping`` over one gradient per local worker (the
        same tensor's), or the gradients themselves without one."""
        if self.gradient_clipping is None:
            return list(grads)
        return list(self.gradient_clipping(list(grads)))

    def compensate(self, state: Dict, name: str, grad,
                   accumulate: bool = True, clipped: bool = False):
        """``accumulate``: momentum correction and local accumulation
        (:func:`kernels.fused_compensate`, in place); returns the velocity
        itself (the compensated gradient IS the stored velocity). Else the
        dense fallback's correction: updates the momentum only and returns
        the corrected gradient in the gradient's dtype. The gradient is
        clipped first (one worker's alone), unless ``clipped`` says the
        caller did that across its workers."""
        grad = grad.reshape(-1)
        if not clipped:
            grad = self.clip([grad])[0]
        mmt = state["momentums"][name]
        if accumulate:
            vec = state["velocities"][name]
            kernels.fused_compensate(grad, mmt, vec, self.momentum,
                                     self.nesterov)
            return vec, state
        m = mmt.to(grad.dtype)
        if self.nesterov:
            m = (m + grad) * self.momentum
            out = m + grad
        else:
            m = self.momentum * m + grad
            out = m
        mmt.copy_(m)
        return out, state

    def compensate_all(self, items) -> List[torch.Tensor]:
        """The accumulating :meth:`compensate` of many tensors in one
        :func:`kernels.fused_compensate_multi` call (one kernel launch for
        up to ``kernels.COMPENSATE_MAX_ENTRIES`` tensors): ``items`` is
        ``[(state, name, grad)]``, any workers' states and names, each name
        of a state at most once. Returns the velocities, in order (each the
        stored velocity itself, updated in place). Under clipping, each
        name's gradients are clipped together, in item order (one a
        worker)."""
        grads = [grad.reshape(-1) for _, _, grad in items]
        if self.gradient_clipping is not None:
            by_name: Dict[str, List[int]] = {}
            for i, (_, name, _) in enumerate(items):
                by_name.setdefault(name, []).append(i)
            for idx in by_name.values():
                for i, g in zip(idx, self.clip([grads[i] for i in idx])):
                    grads[i] = g
        mmts = [state["momentums"][name] for state, name, _ in items]
        vecs = [state["velocities"][name] for state, name, _ in items]
        kernels.fused_compensate_multi(grads, mmts, vecs, self.momentum,
                                       self.nesterov)
        return vecs

    def update(self, state: Dict, name: str, indices, valid) -> Dict:
        """Zero the transmitted coordinates: the velocity always, the
        momentum under ``momentum_masking``. A select (``+0.0`` replaces
        whatever was there, NaN included), not a multiply; a padded slot
        (index 0, invalid) marks nothing."""
        vel = state["velocities"][name]
        sent = transmitted_mask(vel.shape[0], indices, valid)
        vel.masked_fill_(sent, 0.0)
        if self.momentum_masking:
            state["momentums"][name].masked_fill_(sent, 0.0)
        return state

    def feed_back(self, state: Dict, name: str, indices, residual) -> Dict:
        """Add wire-rounding residuals back into the velocity at the
        transmitted coordinates :meth:`update` just zeroed (the int8
        wire's error feedback; a padded slot's residual must be 0)."""
        vel = state["velocities"][name]
        vel.index_add_(0, indices.reshape(-1).long(),
                       residual.reshape(-1).to(vel.dtype))
        return state

    def state_dict(self, state: Dict):
        return state

    def load_state_dict(self, state: Dict, saved) -> Dict:
        """Merge saved buffers (tensors or arrays) by name, cast to the
        live state's dtype; names not saved keep their buffers."""
        if saved is None:
            return state
        for key in ("momentums", "velocities"):
            for name, buf in state[key].items():
                if name in saved["momentums"]:
                    piece = saved[key][name]
                    if not torch.is_tensor(piece):
                        # numpy has no bf16: arrays go through f32, which
                        # holds a bf16 value exactly
                        piece = torch.from_numpy(
                            np.asarray(piece, np.float32))
                    buf.copy_(piece.reshape(-1))
        return state
