"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back from one to the other."""

import torch

__all__ = ["resolve_device", "set_reproducible_numerics"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    return dev


def set_reproducible_numerics() -> None:
    """Full f32 and the same numbers from run to run on the card: no TF32
    in cuDNN or matmuls, and cuDNN restricted to its deterministic
    algorithms, chosen by its heuristics rather than by timing
    (``benchmark`` off). Without ``cudnn.deterministic`` a convolution's
    backward-data pass sums in an order that changes from run to run
    (``repro_bench.py`` bisects it). Does not call
    ``torch.use_deterministic_algorithms``, which would also make every
    op without a deterministic CUDA version raise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
