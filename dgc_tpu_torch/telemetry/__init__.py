"""Compression-health telemetry for the DGC stack (counterpart of
``dgc_tpu/telemetry``; the exports are the reference's, without its
``step_out_specs`` sharding helper).

One schema (:mod:`registry`), three layers:

* :mod:`taps` — step stats: a small dict of per-step device scalars the
  engine (``exchange(..., telemetry=True)``) and the train step compute,
  meaned over the workers in one packed all-reduce (or gathered with the
  fleet lanes, :mod:`fleet`); nothing in the step reads them on the host,
  and with telemetry off none of it runs.
* :mod:`sink` — the host-side async drain: one packed non-blocking copy a
  step into a ring of pinned buffers, a background thread that waits on
  the copy's event and appends schema-versioned JSONL (with rotation),
  plus CSV/summary readers.
* :mod:`regress` — the CLI regression gate of a telemetry run against a
  recorded one.

Plus the tracing / postmortem layer (same sink, own schemas):

* :mod:`trace` — the host span tracer (Chrome-trace / Perfetto export
  through the sink) and the ``dgcph.*`` phase markers (``record_function``
  ranges), nothing while off.
* :mod:`attrib` — profile attribution: the kernels of a ``torch.profiler``
  trace -> DGC phases and buckets, through their launches' correlation
  ids; the per-bucket ``profile.json`` cost table the autotuner reads.
* :mod:`fleet` — the cross-worker lanes (one packed all-gather) and the
  host-side merge of a run's per-host shards.
* :mod:`flight` — the crash flight recorder.
* :mod:`monitor` — the live monitor over a run or a fleet of runs
  (OpenMetrics ``/metrics`` and a status view), the control plane's
  eyes; loaded on its own, not by this package.
"""

from dgc_tpu_torch.telemetry.registry import (
    RUN_METRICS,
    SCHEMA,
    SCHEMA_VERSION,
    STEP_METRICS,
    MetricSpec,
    make_header,
    step_stat_names,
)
from dgc_tpu_torch.telemetry.flight import FlightRecorder, NonfiniteStreak
from dgc_tpu_torch.telemetry.sink import (SchemaMismatchError, TelemetrySink,
                                          read_run, summarize)
from dgc_tpu_torch.telemetry.trace import NULL_TRACER, SpanTracer

__all__ = [
    "MetricSpec", "SCHEMA", "SCHEMA_VERSION", "STEP_METRICS", "RUN_METRICS",
    "make_header", "step_stat_names",
    "TelemetrySink", "SchemaMismatchError", "read_run", "summarize",
    "SpanTracer", "NULL_TRACER", "FlightRecorder", "NonfiniteStreak",
]
