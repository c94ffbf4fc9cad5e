"""Straggler-adaptive exchange policy.

Counterpart of ``dgc_tpu/resilience/adaptive.py``. Fleet observability
already *detects* the straggler in the step (the argmax over the gathered
``w_clock`` lane, :mod:`dgc_tpu_torch.telemetry.fleet`), and DGC's error
feedback makes under-sending safe — any gradient mass a worker withholds
stays in its local velocity accumulator and re-enters a later exchange.
This module is the policy between the two: a pure function from the
gathered ``[W]`` prep-time column to a per-worker **effective send
fraction** in ``[min_frac, 1]``.

Design constraints (the reference's):

* **zero extra collectives** — the policy reads the ``w_clock`` column
  the packed fleet all_gather already carries; the verdict is a pure
  function of gathered values, so every worker computes the same ``[W]``
  fraction vector with no new exchange;
* **static shapes** — the fraction only *masks* slots of the fixed
  max-k payload to the structural ``(0.0, sentinel)`` pad the engine
  already tolerates (flat.py ``send_frac=``); wire shapes never change;
* **mass conservation** — masked slots are dropped from the transmit
  record (``sent_bits``), so the next compensate keeps their mass in
  the velocity buffer: residual + transmitted mass is conserved per
  bucket;
* **memoryless** — the fraction is recomputed from scratch every step,
  so a transient straggler releases as soon as its clock recovers and
  the policy state is deliberately NOT checkpointed (``TrainState.
  adaptive`` is not among the checkpoint's tensors — an elastic W-change
  resume can never hit a shape mismatch).

Two degradation tiers:

1. **ramp** — once the cohort gap exceeds ``engage_gap_ms``, a worker
   lagging the cohort median by ``lag`` ms sends
   ``clip(1 - (1 - min_frac) * lag / ramp_ms, min_frac, 1)`` of its
   per-bucket quota (the slowest worker degrades first and most);
2. **partial exchange** — a worker whose prep interval exceeds
   ``deadline_factor x median`` contributes a near-empty payload
   (``partial_frac``) for that step; error feedback absorbs the skipped
   contribution, the same algebra the elastic merge/split pins.

The median is ``jnp.median``'s: the mean of the two middle values of an
even-length column (``torch.median`` would take the lower one), computed
as ``(low + high) * 0.5`` from a sort, so the verdict is bitwise the
reference's in f32.

Under a gossip plan (:mod:`~dgc_tpu_torch.compression.gossip`) the
policy masks a worker's payload before the exchange, as it does for the
all-gather: a degraded straggler's withheld mass stays in its residual,
the rotating neighborhoods see its shrunken payload round by round, and
the staleness bound still forces full syncs on schedule. The two settle
through the same error-feedback residual and need no coupling.
"""

from typing import NamedTuple

import torch

from dgc_tpu_torch.ops.kernels import divide_exact

__all__ = ["AdaptiveConfig", "init_state", "update_policy"]


class AdaptiveConfig(NamedTuple):
    """Static policy knobs (host-side)."""

    #: cohort max-min prep gap (ms) below which the policy stays fully
    #: disengaged (every worker sends its whole quota)
    engage_gap_ms: float = 100.0
    #: floor of the ramp tier: even the worst straggler keeps sending
    #: this fraction of its quota (the partial tier may go lower)
    min_frac: float = 0.25
    #: lag (ms past the cohort median) over which the fraction ramps
    #: from 1.0 down to min_frac
    ramp_ms: float = 500.0
    #: partial-exchange deadline: a worker slower than this multiple of
    #: the cohort median contributes a near-empty payload this step
    deadline_factor: float = 4.0
    #: the near-empty payload's fraction (>0 keeps at least the very
    #: top of each bucket flowing so the cohort never fully decouples)
    partial_frac: float = 0.02
    #: median floor (ms) for the deadline test — avoids a divide-style
    #: blowup on the warmup steps where every stamp is ~0
    floor_ms: float = 1.0


def init_state(world: int, device=None):
    """Fresh policy state: every worker at full send fraction.

    Lives in ``TrainState.adaptive`` (replicated) purely to carry the
    step-N verdict to step N+1 — it is NOT checkpointed (see module
    docstring)."""
    return {"w_frac": torch.ones((int(world),), dtype=torch.float32,
                                 device=device)}


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D f32 tensor: ``(low + high) * 0.5`` of the
    sorted column at ``floor`` / ``ceil`` of ``0.5 * (n - 1)``."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def update_policy(cfg: AdaptiveConfig, w_clock: torch.Tensor):
    """Next step's per-worker send fractions from this step's gathered
    ``[W]`` prep-time column, on its device. Replicated, memoryless."""
    w_clock = w_clock.to(torch.float32)
    med = _median(w_clock)
    gap = torch.max(w_clock) - torch.min(w_clock)
    lag = w_clock - med
    frac = torch.clamp(1.0 - (1.0 - cfg.min_frac)
                       * divide_exact(lag, cfg.ramp_ms),
                       cfg.min_frac, 1.0)
    # partial-exchange tier: past the deadline the worker contributes a
    # near-empty payload; error feedback keeps the withheld mass local
    partial = w_clock > cfg.deadline_factor * torch.clamp(
        med, min=cfg.floor_ms)
    frac = torch.where(partial, torch.full_like(frac, cfg.partial_frac),
                       frac)
    engaged = gap > cfg.engage_gap_ms
    return torch.where(engaged, frac, torch.ones_like(frac))
