"""Clean twin: f32/bf16 stay f32/bf16."""
import numpy as np
import torch


def make_table(n):
    base = torch.zeros((n,), dtype=torch.float32)
    narrow = base.to(torch.bfloat16)
    host = np.zeros(n, np.float32)
    return base, narrow.float(), host
