"""Tracing and timing helpers.

Counterpart of ``dgc_tpu/utils/profiling.py``:

* :func:`trace` — a ``torch.profiler`` trace of a code region (host
  activity, and the card's when one is present), written as a Chrome
  trace (``trace.json``, loadable at ui.perfetto.dev); the harness's
  ``--profile`` writes one under ``<save_path>/profile``;
* :func:`annotate` — a named range inside a trace (a ``record_function``
  event, and an NVTX range on the card);
* :func:`step_timer` — median / p10 / p90 step time in ms: CUDA events
  around each call and a device synchronise on the card, the host clock
  on the CPU;
* :func:`exchange_report` — the gradient exchange's cost from a measured
  overhead and a stated wire model, the JAX package's formulas.
"""

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["trace", "annotate", "step_timer", "exchange_report"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region and write ``<logdir>/trace.json``; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region inside an active trace."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_timer(step_fn: Callable, *args, warmup: int = 3, iters: int = 20,
               device="cuda") -> Dict[str, float]:
    """median / p10 / p90 ms of ``step_fn(*args)``, each call timed alone:
    on a CUDA ``device`` between two CUDA events with the device
    synchronised after each call, on the CPU by the host clock."""
    dev = torch.device(device)
    for _ in range(warmup):
        step_fn(*args)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            step_fn(*args)
            t1.record()
            torch.cuda.synchronize(dev)
            times.append(t0.elapsed_time(t1))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            step_fn(*args)
            times.append((time.perf_counter() - t0) * 1000)
    t = np.asarray(times)
    return {"median_ms": float(np.median(t)),
            "p10_ms": float(np.percentile(t, 10)),
            "p90_ms": float(np.percentile(t, 90))}


def exchange_report(dgc_ms: float, dense_ms: float, payload_elems: int,
                    num_params: int, workers: int,
                    fabric_gbps: float) -> Dict[str, float]:
    """The gradient exchange's accounting: the measured on-device
    overhead plus a stated wire model (a ring all-reduce of f32 against a
    sparse all-gather of f32 values and int32 indices)."""
    dense_wire_ms = (2 * 4 * num_params * (workers - 1) / workers) / (
        fabric_gbps * 1e9) * 1e3
    dgc_wire_ms = ((workers - 1) * payload_elems * 8) / (
        fabric_gbps * 1e9) * 1e3
    overhead = max(dgc_ms - dense_ms, 0.0)
    return {
        "dense_exchange_ms": dense_wire_ms,
        "dgc_exchange_ms": overhead + dgc_wire_ms,
        "dgc_wire_ms": dgc_wire_ms,
        "dgc_compute_overhead_ms": overhead,
        "speedup": dense_wire_ms / max(overhead + dgc_wire_ms, 1e-12),
        "wire_reduction": (2 * 4 * num_params * (workers - 1) / workers) /
                          max((workers - 1) * payload_elems * 8, 1),
    }
