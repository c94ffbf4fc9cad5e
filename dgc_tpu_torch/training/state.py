"""Train state over flat buffers (counterpart of
``dgc_tpu/training/state.py``): parameters and optimizer state are
replicated, so the process keeps one copy; DGC memory and BatchNorm
statistics are per worker, one entry per local worker (``comm.ranks``).
Under the Adasum scheme (``per_worker_opt_state``) the optimizer state is
per worker too: a list, one a local worker. ``guards`` is the step
guards' state (``resilience.guard``; None without guards), and
``pending_skip`` the last guarded step's skip verdict, a host copy in
flight and the event that ends it: the step count of the optimizer state is a host int, taken back
by :func:`~dgc_tpu_torch.training.step.resolve_pending_skip` when the
verdict is read (the next step's update, or a save)."""

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

__all__ = ["TrainState"]


@dataclass
class TrainState:
    step: int
    params: torch.Tensor              # flat [P], replicated
    opt_state: object                 # optimizer state, replicated (a
                                      # list a local worker under Adasum)
    memory: List[Dict[str, torch.Tensor]]   # per local worker
    batch_stats: List[torch.Tensor]   # per local worker, flat
    guards: Optional[Dict[str, torch.Tensor]] = None   # replicated
    pending_skip: Optional[tuple] = None
