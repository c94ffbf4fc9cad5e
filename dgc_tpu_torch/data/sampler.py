"""Per-epoch batch order (counterpart of ``dgc_tpu/data/sampler.py``): a
deterministic shuffle seeded by ``seed + epoch`` (or the natural order,
without ``shuffle``, as the evaluation reads a split), the last partial batch
wrap-padded unless ``drop_last``; worker w takes the w-th contiguous block
of each global batch."""

from typing import Iterator

import numpy as np

__all__ = ["epoch_batches", "num_steps_per_epoch"]


def epoch_batches(n: int, global_batch: int, epoch: int, seed: int = 0,
                  shuffle: bool = True, drop_last: bool = False
                  ) -> Iterator[np.ndarray]:
    """Yield index arrays of exactly ``global_batch`` per step."""
    rng = np.random.RandomState(seed + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    n_full = n // global_batch
    for b in range(n_full):
        yield order[b * global_batch:(b + 1) * global_batch]
    rem = n - n_full * global_batch
    if rem and not drop_last:
        tail = order[n_full * global_batch:]
        reps = -(-(global_batch - rem) // n)
        pad = np.tile(order, reps)[:global_batch - rem]
        yield np.concatenate([tail, pad])


def num_steps_per_epoch(n: int, global_batch: int,
                        drop_last: bool = False) -> int:
    full = n // global_batch
    if not drop_last and n % global_batch:
        full += 1
    return full
