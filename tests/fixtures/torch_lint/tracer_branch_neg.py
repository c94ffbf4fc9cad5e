"""Clean twin: branches on static config, shapes, dtypes and devices."""
import torch


def select(x, use_abs: bool = False, mode: str = "mean"):  # dgclint: hot
    if use_abs:
        x = torch.abs(x)
    if mode == "mean":
        r = x.mean()
    else:
        r = x.sum()
    if x.shape[0] > 4 and x.numel() > 4:
        r = r / 2.0
    if x is not None and x.dtype == torch.float32:
        r = r + 1.0
    if x.device.type == "cuda":
        r = r * 1.0
    return torch.where(r > 0, r, -r)


def host_only(x):
    # not in the hot path
    if x.sum() > 0:
        return x
    return -x
