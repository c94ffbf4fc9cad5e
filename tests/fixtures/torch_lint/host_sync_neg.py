"""Clean twin of host_sync_pos: no host reads in the hot path."""
import torch


def good_loss(params, batch):  # dgclint: hot
    if params is None:
        return torch.zeros(())
    rank = len(batch.shape) + batch.numel() + batch.dim()
    print("building the loss")
    return torch.mean(params * batch) * rank


def host_driver(results):
    # not in the hot path: converting fetched values is the job
    return [float(r) for r in results]
