"""Learning-rate schedule: linear warm-up of the scaled LR, then a per-epoch
decay (cosine for CIFAR, multistep for ImageNet).

Counterpart of ``dgc_tpu/training/lr.py``. The schedule is a host function
``step -> lr`` evaluated in float32 arithmetic exactly as the reference's
traced one, so both packages take the same learning rate at every step.
"""

from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["warmup_factor", "cosine_schedule", "multistep_schedule",
           "make_lr_schedule"]

_f = np.float32


def warmup_factor(epoch_f, world_size: int, warmup_epochs: float):
    """Linear 1/size -> 1 ramp of the scaled LR."""
    return (epoch_f * _f(world_size - 1) / _f(warmup_epochs) + _f(1)) \
        / _f(world_size)


def cosine_schedule(t_max: float) -> Callable:
    """Cosine annealing factor over epochs after the warm-up (to 0)."""
    def fn(t):
        return _f(0.5) * (_f(1) + np.cos(_f(np.pi) * t / _f(t_max)))
    return fn


def multistep_schedule(milestones: Sequence[float],
                       gamma: float = 0.1) -> Callable:
    """``gamma ** (milestones passed)`` over epochs after the warm-up
    (``torch.optim.lr_scheduler.MultiStepLR``), in f32."""
    ms = np.asarray(sorted(milestones), np.float32)

    def fn(t):
        return _f(gamma) ** _f(np.sum(_f(t) >= ms))
    return fn


def make_lr_schedule(scaled_lr: float, world_size: int,
                     num_steps_per_epoch: int,
                     warmup_lr_epochs: float = 0,
                     decay: Optional[Callable] = None,
                     schedule_lr_per_epoch: bool = True
                     ) -> Callable[[int], float]:
    """Warm-up + decay as one ``step count -> lr`` function."""

    def schedule(count: int) -> float:
        epoch_f = _f(count) / _f(num_steps_per_epoch)
        t = epoch_f - _f(warmup_lr_epochs)
        if schedule_lr_per_epoch:
            t = np.floor(t)
        t = max(t, _f(0))
        df = decay(t) if decay is not None else _f(1)
        if warmup_lr_epochs > 0 and epoch_f < warmup_lr_epochs:
            factor = warmup_factor(epoch_f, world_size, warmup_lr_epochs)
        else:
            factor = df
        return float(_f(scaled_lr) * _f(factor))

    return schedule
