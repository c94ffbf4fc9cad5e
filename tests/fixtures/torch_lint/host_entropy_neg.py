"""Clean twin: draws from a generator the step is given; host timing
stays host."""
import time

import torch


def seeded(x, gen: torch.Generator):  # dgclint: hot
    noise = torch.randn(x.shape, generator=gen)
    x.normal_(0.0, 1.0, generator=gen)
    return x + noise


def host_timer():
    return time.time()
