"""Seeded violations: Python control flow on tensor values."""
import torch


def select(x, threshold):  # dgclint: hot
    if torch.any(x > threshold):  # LINT: tracer-branch
        x = x * 2.0
    while x.sum() > 1.0:  # LINT: tracer-branch
        x = x * 0.5
    assert x[0] > 0  # LINT: tracer-branch
    y = x if x.mean() > 0 else -x  # LINT: tracer-branch
    return helper(y)


def helper(y):
    # reached from the hot root through the call graph
    if y.max() > 10:  # LINT: tracer-branch
        y = y / 10
    return y
