"""Metric logging: a rank-0 console print and a JSONL scalar stream.

Counterpart of ``dgc_tpu/utils/logging.py``. The reference logs the
per-step training loss and the per-epoch meters with the x axis at the
samples seen so far, and prints through a rank-0-only ``printr``. The
stream is JSONL, one ``{"tag", "value", "step"}`` object a line, in
``<logdir>/metrics.jsonl``; when ``tensorboardX`` imports, the same
scalars also go to its event files.
"""

import json
import os

from dgc_tpu_torch.parallel.multihost import is_coordinator

__all__ = ["MetricWriter", "printr"]


def printr(*args, **kwargs):
    """Print on process 0 of the process group only (every process
    prints when there is no group)."""
    if is_coordinator():
        print(*args, **kwargs)


class MetricWriter:
    """Coordinator-only writer: on the other processes every method does
    nothing (several processes appending to one file on a shared
    filesystem would interleave their lines)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._f = None
        self._tb = None
        if not is_coordinator():
            return
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value: float, step: int):
        if self._f is None:
            return
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
