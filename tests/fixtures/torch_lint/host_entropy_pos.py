"""Seeded violations: global RNG state and host clocks in the hot path."""
import random
import time

import numpy as np
import torch


def noisy(x):  # dgclint: hot
    t = time.time()  # LINT: host-entropy
    r = np.random.rand()  # LINT: host-entropy
    s = random.random()  # LINT: host-entropy
    n = torch.randn(x.shape)  # LINT: host-entropy
    p = torch.randperm(4)  # LINT: host-entropy
    x.uniform_()  # LINT: host-entropy
    return x * t * r * s + n + p[0]
