"""Seeded violations: host syncs in the step's hot path.

`# LINT: <rule-id>` marks the lines tests expect the linter to flag;
`# dgclint: hot` marks a function as a root of the hot path."""
import numpy as np
import torch


def bad_loss(params, batch):  # dgclint: hot
    loss = torch.mean(params * batch)
    print("loss is", loss)  # LINT: host-sync
    scale = float(loss)  # LINT: host-sync
    host = np.asarray(loss)  # LINT: host-sync
    item = loss.item()  # LINT: host-sync
    rows = loss.tolist()  # LINT: host-sync
    back = loss.cpu()  # LINT: host-sync
    arr = back.numpy()  # LINT: host-sync
    torch.cuda.synchronize()  # LINT: host-sync
    return loss * scale + host + item + rows[0] + arr
