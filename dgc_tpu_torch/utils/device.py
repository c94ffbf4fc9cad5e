"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back from one to the other."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    return dev
