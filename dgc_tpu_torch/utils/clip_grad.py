"""Gradient clipping (counterpart of ``dgc_tpu/utils/clip_grad.py``).

Every function clips over the LAST axis: a 1-D tensor as a whole, a
[R, n] batch of tensors row by row (the reference's ``jax.vmap`` over a
bucket's row view). All are padding-invariant: zeros appended to a row
change no norm and clip back to zero, which the flat engine relies on
(its bucket rows have structural-zero tails).

``grad`` is a tensor, or a list with one tensor per local worker of a
:class:`~dgc_tpu_torch.parallel.comm.Comm` (``comm.ranks``); the result
has the same form. The memory (``DGCSGDMemory(gradient_clipping=...)``)
and the flat engine always call with that list, so the *global*
variants can reduce the squared sums across workers with
``comm.all_reduce`` where the reference takes a mesh ``axis_name`` for
``pmean``. Bind the extra arguments with ``functools.partial`` first, as
:func:`global_norm_clipper` does. The cross-worker sum is the one place
whose order may differ from the reference's ``psum``.
"""

import functools

import torch

from dgc_tpu_torch.ops import kernels

__all__ = ["clip_grad_norm", "clip_grad_value",
           "clip_grad_value_by_global_norm", "clip_grad_norm_2_by_global",
           "global_norm_clipper"]


def _each(grad, fn):
    """``fn`` over a tensor or over each tensor of a list."""
    if torch.is_tensor(grad):
        return fn(grad)
    return [fn(g) for g in grad]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-dim tensor of ``like``'s dtype and device:
    the rounding of the reference's weak-typed scalar."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _scale(grad, total_norm, max_norm: float):
    clip_coef = _f32(max_norm, total_norm) / (total_norm + _f32(1e-6,
                                                                total_norm))
    return torch.where(clip_coef < 1, grad * clip_coef, grad)


def clip_grad_norm(grad, max_norm, norm_type=2):
    """Scale each row so its norm is at most ``max_norm``."""
    max_norm = float(max_norm)

    def one(g):
        if norm_type == float("inf"):
            total = g.abs().amax(dim=-1, keepdim=True)
        else:
            total = g.abs().pow(norm_type).sum(dim=-1, keepdim=True).pow(
                1.0 / norm_type)
        return _scale(g, total, max_norm)
    return _each(grad, one)


def clip_grad_value(grad, clip_value):
    """Clamp elementwise to [-clip_value, clip_value]."""
    clip_value = float(clip_value)
    return _each(grad, lambda g: torch.clamp(g, -clip_value, clip_value))


def _global_sq(grads, comm):
    """Per worker, each row's sum of squares, averaged over the workers
    of ``comm`` when one is given (the reference's ``pmean``)."""
    sq = [g.square().sum(dim=-1, keepdim=True) for g in grads]
    if comm is None:
        return sq
    return [kernels.divide_exact(s, comm.world) for s in comm.all_reduce(sq)]


def _as_list(grad):
    return [grad] if torch.is_tensor(grad) else list(grad)


def _like(grad, out):
    return out[0] if torch.is_tensor(grad) else out


def clip_grad_value_by_global_norm(grad, comm=None):
    """Clamp elementwise to +-sqrt(mean over workers of sum(grad**2))."""
    grads = _as_list(grad)
    out = [torch.clamp(g, -v, v) for g, v in
           zip(grads, (s.sqrt() for s in _global_sq(grads, comm)))]
    return _like(grad, out)


def clip_grad_norm_2_by_global(grad, max_norm, comm=None):
    """Scale by ``max_norm`` / the workers' mean 2-norm where it is
    above ``max_norm``."""
    grads = _as_list(grad)
    out = [_scale(g, s.sqrt(), float(max_norm))
           for g, s in zip(grads, _global_sq(grads, comm))]
    return _like(grad, out)


def global_norm_clipper(max_norm, comm=None):
    """The partial form to plug into
    ``DGCSGDMemory(gradient_clipping=...)``."""
    return functools.partial(clip_grad_norm_2_by_global, max_norm=max_norm,
                             comm=comm)
