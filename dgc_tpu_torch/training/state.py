"""Train state over flat buffers (counterpart of
``dgc_tpu/training/state.py``): parameters and optimizer state are
replicated, so the process keeps one copy; DGC memory and BatchNorm
statistics are per worker, one entry per local worker (``comm.ranks``)."""

from dataclasses import dataclass
from typing import Dict, List

import torch

__all__ = ["TrainState"]


@dataclass
class TrainState:
    step: int
    params: torch.Tensor              # flat [P], replicated
    opt_state: object                 # optimizer state, replicated
    memory: List[Dict[str, torch.Tensor]]   # per local worker
    batch_stats: List[torch.Tensor]   # per local worker, flat
