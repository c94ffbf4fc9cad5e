"""Step guards: the non-finite skip and the loss-spike breaker.

Counterpart of ``dgc_tpu/resilience/guard.py``. A NaN gradient on one
worker poisons the replicated update and, with DGC, every worker's
error-feedback residual. A guarded step that trips skips the whole update
atomically: the parameters, the optimizer state, the whole DGC memory
(the transmit record included) and the BatchNorm statistics go back to
their pre-step values; the step counter and the guard counters advance.

As in the reference, the decision never leaves the device: the flag rides
the step's one loss all-reduce (a stacked ``[2]`` vector instead of a
scalar) and the skip is a :func:`tree_select` of ``torch.where``, so a
guarded step makes no host sync and no extra collective. The guard state
is a dict of device tensors, replicated (every worker computes the same
verdict from the same reduced values).

The breaker keeps a rolling window of the last ``spike_window`` finite
mean losses and skips a step whose loss exceeds ``spike_factor`` times
the window mean; skipped spike losses still enter the window (a lasting
level shift disarms it after about ``spike_window`` steps), non-finite
losses never do.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["GuardConfig", "GUARD_METRIC_NAMES", "init_state", "apply",
           "nonfinite_flag", "tree_select", "snapshot"]

#: guard metric keys, in emission order
GUARD_METRIC_NAMES = ("skipped_steps", "nonfinite_rate",
                      "checksum_failures")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``nonfinite`` — skip steps where any worker saw a non-finite
    gradient or loss. ``spike_window`` — the breaker's window (0: off).
    ``spike_factor`` — its threshold as a multiple of the window mean."""
    nonfinite: bool = True
    spike_window: int = 0
    spike_factor: float = 10.0

    def __post_init__(self):
        if self.spike_window < 0:
            raise ValueError(f"spike_window must be >= 0, got "
                             f"{self.spike_window}")
        if self.spike_window and self.spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got "
                             f"{self.spike_factor}")


def init_state(cfg: GuardConfig, device=None) -> Dict[str, torch.Tensor]:
    """The initial guard state on ``device`` (the reference's dtypes; one
    never-read window slot when the breaker is off)."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"loss_window": z((max(cfg.spike_window, 1),), torch.float32),
            "wpos": z((), torch.int32), "wcount": z((), torch.int32),
            "steps": z((), torch.int32), "skipped": z((), torch.int32),
            "nonfinite": z((), torch.int32),
            "checksum_failures": z((), torch.float32)}


def nonfinite_flag(grad: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """One worker's badness flag as f32: 1.0 where its loss or any element
    of its (flat) gradient is not finite."""
    ok = torch.isfinite(loss) & torch.isfinite(grad).all()
    return 1.0 - ok.to(torch.float32)


def apply(cfg: GuardConfig, gstate: Dict[str, torch.Tensor], *,
          bad_count: torch.Tensor, mean_loss: torch.Tensor,
          checksum_failures: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor]]:
    """One guarded transition: ``(skip, new state, metrics)``, all device
    tensors. ``bad_count`` — the reduced count of poisoned workers;
    ``mean_loss`` — the step's mean loss; ``checksum_failures`` — this
    step's mismatch count, or None when the checksum is off (the counter
    then stays flat)."""
    dev = mean_loss.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    nonfinite = (bad_count > 0) if cfg.nonfinite else false
    window = gstate["loss_window"]
    wpos, wcount = gstate["wpos"], gstate["wcount"]
    if cfg.spike_window > 0:
        w = cfg.spike_window
        wmean = window.sum() / torch.clamp(wcount, min=1).to(torch.float32)
        armed = wcount >= w
        finite = torch.isfinite(mean_loss)
        spike = armed & finite & (mean_loss > cfg.spike_factor * wmean)
        pushed = window.clone()
        pushed[wpos.long()] = mean_loss.to(torch.float32)
        window = torch.where(finite, pushed, window)
        wpos = torch.where(finite, (wpos + 1) % w, wpos)
        wcount = torch.where(finite, torch.clamp(wcount + 1, max=w), wcount)
    else:
        spike = false
    skip = nonfinite | spike
    steps = gstate["steps"] + 1
    skipped = gstate["skipped"] + skip.to(torch.int32)
    nf_ct = gstate["nonfinite"] + nonfinite.to(torch.int32)
    chk = gstate["checksum_failures"]
    if checksum_failures is not None:
        chk = chk + checksum_failures
    new = {"loss_window": window, "wpos": wpos, "wcount": wcount,
           "steps": steps, "skipped": skipped, "nonfinite": nf_ct,
           "checksum_failures": chk}
    metrics = {"skipped_steps": skipped.to(torch.float32),
               "nonfinite_rate": nf_ct.to(torch.float32)
               / steps.to(torch.float32),
               "checksum_failures": chk}
    return skip, new, metrics


def tree_select(skip: torch.Tensor, old, new):
    """The atomic revert: every tensor of ``new`` (a tensor, a dict, a
    list / tuple / NamedTuple of them) takes its ``old`` value where
    ``skip`` is true; anything else passes through from ``new``."""
    if torch.is_tensor(new):
        return torch.where(skip, old, new)
    if isinstance(new, dict):
        return {k: tree_select(skip, old[k], v) for k, v in new.items()}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(tree_select(skip, o, n)
                           for o, n in zip(old, new)))
    if isinstance(new, (list, tuple)):
        return type(new)(tree_select(skip, o, n) for o, n in zip(old, new))
    return new


def snapshot(tree):
    """A copy of every tensor of ``tree`` (the pre-step values a skip
    restores): the memory and the BatchNorm statistics are written in
    place by the step."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(snapshot(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree

