"""Metric meters (counterpart of ``dgc_tpu/utils/meters.py``).

:class:`TopKClassMeter` keeps the update/data/set/compute protocol of the
reference harness: per-batch ``update(outputs, targets)``, ``data()``
returning reducible counts, ``set`` with the reduced counts, ``compute``
-> accuracy in percent. The eval step
(:func:`dgc_tpu_torch.training.step.eval_step`) counts hits on the device
and sums them over workers; the harness hands the sums to
``update_counts``.
"""

import numpy as np

__all__ = ["TopKClassMeter"]


class TopKClassMeter:
    def __init__(self, k: int = 1):
        self.k = k
        self.reset()

    def reset(self):
        self.num_correct = 0
        self.num_examples = 0

    def update(self, outputs, targets):
        """outputs: [N, C] scores; targets: [N] integer labels."""
        outputs = np.asarray(outputs)
        targets = np.asarray(targets)
        k = min(self.k, outputs.shape[-1])
        topk = np.argpartition(-outputs, k - 1, axis=-1)[:, :k]
        correct = (topk == targets[:, None]).any(axis=-1)
        self.num_correct += int(correct.sum())
        self.num_examples += int(targets.shape[0])

    def update_counts(self, num_correct: int, num_examples: int):
        self.num_correct += int(num_correct)
        self.num_examples += int(num_examples)

    def data(self):
        return {"num_correct": self.num_correct,
                "num_examples": self.num_examples}

    def set(self, data):
        self.num_correct = int(data["num_correct"])
        self.num_examples = int(data["num_examples"])

    def compute(self) -> float:
        if self.num_examples == 0:
            return 0.0
        return 100.0 * self.num_correct / self.num_examples
