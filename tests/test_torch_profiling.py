"""``dgc_tpu_torch/utils/profiling.py``: ``exchange_report``'s formulas
against the JAX function's (the same float64 arithmetic: equal), and the
CPU forms of ``step_timer``, ``trace`` and ``annotate``."""

import json
import os

import pytest
import torch

from dgc_tpu.utils.profiling import exchange_report as jax_exchange_report
from dgc_tpu_torch.utils import profiling


@pytest.mark.parametrize("args", [
    (12.5, 10.0, 25_583, 25_557_032, 4, 25.0),
    (3.0, 5.0, 1_801, 1_730_714, 8, 100.0),      # no overhead
    (0.0, 0.0, 0, 270_000, 2, 12.5),             # an empty payload
    (80.0, 62.3, 342_704, 272_474, 3, 400.0),
])
def test_exchange_report_matches_jax(args):
    assert profiling.exchange_report(*args) == jax_exchange_report(*args)


def test_step_timer_on_the_cpu():
    calls = []
    out = profiling.step_timer(lambda x: calls.append(x), 1, warmup=2,
                               iters=5, device="cpu")
    assert len(calls) == 7
    assert set(out) == {"median_ms", "p10_ms", "p90_ms"}
    assert 0 <= out["p10_ms"] <= out["median_ms"] <= out["p90_ms"]


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("dgc.exchange"):
            torch.ones(64).sum()
    assert prof is not None
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "dgc.exchange" for e in events)
