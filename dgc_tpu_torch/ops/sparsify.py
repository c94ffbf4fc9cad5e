"""The per-tensor DGC sparsification ops, in plain PyTorch.

Counterpart of ``dgc_tpu/ops/sparsify.py``: every op has a static shape,
so a tensor's selection is always exactly ``num_selects`` slots with a
validity mask; invalid slots are padded to (0.0, index 0), a no-op under
the scatter-add. No op here is a kernel in either package (the reference
runs them as XLA ops).

Two choices of the port, each giving the reference's numbers:

* The strided sample's random phase, and the uniform sample's positions,
  are arguments, drawn on the host (:func:`draw_phase`,
  :func:`draw_positions`, from a ``torch.Generator``) where the reference
  draws them with ``jax.random.randint``; the tests pass in the JAX-drawn
  ones.
* :func:`adapt_threshold` runs a fixed ``max_iters`` masked steps instead
  of the reference's ``while_loop``: once the loop's condition is false
  the threshold and its count stop changing, so the result is the same,
  and no step waits for the device on the host.

Scalars meet tensors in the tensor's dtype, as JAX's weak-typed Python
scalars do: ``thr * lower_bound`` multiplies by ``lower_bound`` rounded to
the threshold's dtype (bf16 for the bf16 error-feedback memory), and the
counts compare with ``float32(lower_bound * num_selects)``.
"""

import torch

from dgc_tpu_torch.compression.flat import lax_top_k

__all__ = ["draw_phase", "draw_positions", "strided_sample",
           "uniform_sample", "topk_threshold",
           "adapt_threshold", "select_by_threshold", "scatter_add_dense",
           "transmitted_mask"]


def draw_phase(gen: torch.Generator, stride: int) -> int:
    """A strided sample's start, uniform in ``[0, stride)``."""
    return int(torch.randint(0, stride, (), generator=gen))


def draw_positions(gen: torch.Generator, num_samples: int,
                   numel: int) -> torch.Tensor:
    """A uniform sample's ``num_samples`` positions, each uniform in
    ``[0, numel)`` (with replacement), int64 on the host."""
    return torch.randint(0, numel, (num_samples,), generator=gen)


def strided_sample(importance: torch.Tensor, num_samples: int, stride: int,
                   phase: int) -> torch.Tensor:
    """Every ``stride``-th element from ``phase`` on, ``num_samples`` of
    them (reference compression.py:117-119)."""
    offsets = torch.arange(num_samples, device=importance.device) * stride
    return importance[phase + offsets]


def uniform_sample(importance: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """The elements at ``positions`` (:func:`draw_positions`; reference
    compression.py:121)."""
    return importance[positions.to(importance.device, torch.int64)]


def topk_threshold(samples: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest sample (0-dim, the samples' dtype)."""
    return lax_top_k(samples[None], k)[0][0, k - 1]


def adapt_threshold(importance: torch.Tensor, threshold: torch.Tensor,
                    num_selects: int, lower_bound: float,
                    upper_bound: float, max_iters: int,
                    resample: bool) -> torch.Tensor:
    """Bounded threshold adaptation (reference compression.py:128-149):
    lower the threshold (x ``lower_bound``) while fewer than ``lower_bound
    * num_selects`` elements pass; without ``resample`` also raise it (x
    ``upper_bound``) while more than ``upper_bound * num_selects`` pass.
    At most ``max_iters`` steps; returns the 0-dim threshold."""
    dt, dev = threshold.dtype, threshold.device
    lower = torch.tensor(lower_bound, dtype=dt, device=dev)
    upper = torch.tensor(upper_bound, dtype=dt, device=dev)
    lo = torch.tensor(lower_bound * num_selects, dtype=torch.float32,
                      device=dev)
    hi = torch.tensor(upper_bound * num_selects, dtype=torch.float32,
                      device=dev)
    thr = threshold
    count = (importance >= thr).sum().to(torch.float32)
    for _ in range(max_iters):
        nxt = thr
        if not resample:
            nxt = torch.where(count > hi, thr * upper, thr)
        thr = torch.where(count < lo, thr * lower, nxt)
        count = (importance >= thr).sum().to(torch.float32)
    return thr


def select_by_threshold(flat: torch.Tensor, importance: torch.Tensor,
                        threshold: torch.Tensor, num_selects: int):
    """The at most ``num_selects`` most important elements passing
    ``threshold``: ``(values, int32 indices, valid)`` of length
    ``num_selects``, in ``lax.top_k`` order (importance descending, ties
    to the lower index); invalid slots are (0.0, 0, False). The values are
    gathered into a tensor of their own."""
    scores = torch.where(importance >= threshold, importance,
                         torch.full_like(importance, -1.0))
    top_scores, indices = lax_top_k(scores[None], num_selects)
    top_scores, indices = top_scores[0], indices[0]
    valid = top_scores >= 0
    indices = torch.where(valid, indices, 0)
    values = torch.where(valid, flat[indices.long()], 0.0)
    return values, indices, valid


def scatter_add_dense(numel: int, indices: torch.Tensor,
                      values: torch.Tensor, dtype=None) -> torch.Tensor:
    """Dense accumulation of sparse ``(indices, values)`` (any matching
    shapes) into a fresh [numel] tensor of ``dtype`` (the values' by
    default): ``index_add_``, which sums duplicates in payload order on the
    CPU and in atomic order on the card."""
    dtype = dtype or values.dtype
    out = torch.zeros(numel, dtype=dtype, device=values.device)
    return out.index_add_(0, indices.reshape(-1).long(),
                          values.reshape(-1).to(dtype))


def transmitted_mask(numel: int, indices: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """[numel] bool mask of the coordinates actually transmitted: a
    scatter of ``max(valid)``, so a padded slot (index 0, invalid) never
    marks coordinate 0."""
    hits = torch.zeros(numel, dtype=torch.int32, device=indices.device)
    hits.scatter_reduce_(0, indices.long(), valid.to(torch.int32), "amax")
    return hits > 0
