"""Step stat taps: plain torch reductions the engine and the train step
call when telemetry is on.

Counterpart of ``dgc_tpu/telemetry/taps.py``. Everything here returns
device scalars (or small ``[num_buckets]`` vectors) that the async sink
drains on its own thread: nothing reads them on the host in the step. With
``telemetry=False`` none of these functions runs. The taps reuse what the
exchange already holds (the emitted payload, the post-compensate velocity);
the new work is a handful of reductions (``grad_norm``, ``momentum_norm``
and the residual's L2 and L1 over [T] a worker, the per-bucket counts over
the payload). They run outside the hand-written kernels, as the reference
computes them in ``jnp`` outside its Pallas kernels.
"""

from typing import Dict, List, Optional, Sequence

import torch

from dgc_tpu_torch.ops.kernels import divide_exact
from dgc_tpu_torch.telemetry import registry

__all__ = ["l2", "l1", "sumsq", "bucket_payload_stats",
           "assemble_step_stats", "empty_bucket_stats", "pack_stats",
           "unpack_stats", "pmean_stats"]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of squares (the reference's ``jnp.sum(x ** 2)``)."""
    xf = _f32(x)
    return torch.sum(xf * xf)


def l2(x: Optional[torch.Tensor], device=None) -> torch.Tensor:
    """f32 L2 norm; 0 for None/empty (the dense-baseline engines), on
    ``device`` when ``x`` is None."""
    if x is None or x.numel() == 0:
        return torch.zeros((), dtype=torch.float32,
                           device=device if x is None else x.device)
    return torch.sqrt(sumsq(x))


def l1(x: Optional[torch.Tensor], device=None) -> torch.Tensor:
    """f32 L1 mass (sum of |x|); 0 for None/empty. The additive quantity
    the elastic reshard conserves per worker — see resilience/elastic.py."""
    if x is None or x.numel() == 0:
        return torch.zeros((), dtype=torch.float32,
                           device=device if x is None else x.device)
    return torch.sum(torch.abs(_f32(x)))


def bucket_payload_stats(vals: torch.Tensor, gidx: torch.Tensor,
                         sentinel: int):
    """(real_count, effective_threshold) for one bucket's emitted payload.

    The effective threshold is the min |value| over real (non-sentinel)
    slots — exactly the quantity the sampled-top-k threshold estimates; 0
    when the bucket transmitted nothing this step.
    """
    valid = gidx != sentinel
    count = torch.sum(valid).to(torch.float32)
    absv = torch.abs(_f32(vals))
    thr = torch.min(torch.where(valid, absv, torch.inf))
    return count, torch.where(count > 0, thr, 0.0)


def empty_bucket_stats(num_buckets: int = 0,
                       device=None) -> Dict[str, torch.Tensor]:
    """Per-bucket stat arrays for engines with no sparse payload."""
    z = torch.zeros((num_buckets,), dtype=torch.float32, device=device)
    return {"selected_frac": z, "threshold": z.clone(),
            "payload_elems": torch.zeros((), dtype=torch.float32,
                                         device=device)}


def assemble_step_stats(*, grad_norm, momentum_norm, residual_norm,
                        residual_mass, clip_delta, payload_elems,
                        wire_bytes, selected_frac,
                        threshold) -> Dict[str, torch.Tensor]:
    """Assemble + schema-check the per-step stat dict (registry names)."""
    stats = {
        "grad_norm": grad_norm,
        "momentum_norm": momentum_norm,
        "residual_norm": residual_norm,
        "residual_mass": residual_mass,
        "clip_delta": clip_delta,
        "payload_elems": payload_elems,
        "wire_bytes": wire_bytes,
        "selected_frac": selected_frac,
        "threshold": threshold,
    }
    registry.validate_step_stats(stats)
    return {k: _f32(v) for k, v in stats.items()}


def pack_stats(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every stat of one worker as ONE flat f32 vector, in the dict's
    order."""
    return torch.cat([_f32(v).reshape(-1) for v in stats.values()])


def unpack_stats(flat: torch.Tensor,
                 like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`pack_stats` over ``like``'s keys and
    shapes."""
    out, off = {}, 0
    for k, v in like.items():
        n = v.numel()
        out[k] = flat[off:off + n].reshape(v.shape)
        off += n
    return out


def pmean_stats(stats: Sequence[Dict[str, torch.Tensor]],
                comm) -> Dict[str, torch.Tensor]:
    """The mean of every local worker's stats over ``comm``'s workers (the
    train step's whole group: both tiers' workers, worker-major), returned
    once — every local worker would hold the same copy, like the loss.

    Packs every stat into ONE flat vector first, so the whole dict costs a
    single all-reduce, not one collective a stat: the sum over the workers
    in rank order, then an IEEE divide by the world."""
    total = comm.all_reduce([pack_stats(s) for s in stats])[0]
    return unpack_stats(divide_exact(total, comm.world), stats[0])
