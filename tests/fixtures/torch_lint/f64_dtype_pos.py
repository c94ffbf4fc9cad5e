"""Seeded violations: float64 dtypes."""
import numpy as np
import torch


def make_table(n):
    scale = np.float64(1.5)  # LINT: f64-dtype
    base = torch.zeros((n,), dtype=torch.float64)  # LINT: f64-dtype
    wide = base.double()  # LINT: f64-dtype
    host = np.zeros(n).astype(float)  # LINT: f64-dtype
    twice = torch.ones(n, dtype=torch.double)  # LINT: f64-dtype
    return scale, wide, host, twice
