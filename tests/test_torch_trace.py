"""Tracing and profile attribution against the JAX package.

* The phase markers: off, ``phase`` is a ``nullcontext`` and the step
  calls nothing more; on, a ``record_function`` range named
  ``dgcph.<phase>[.b<bucket>]``; ``phased`` wraps a kernel wrapper.
* The host span tracer: nesting, exceptions, ``wrap_iter``, the step
  summary, the Chrome export (validated), the sink export and
  ``chrome_trace_from_records`` equal to the JAX package's on the same
  records, the CLI.
* Attribution on a Kineto-format trace written here: device events
  (``kernel`` / ``gpu_memcpy`` / ``gpu_memset``) find their phase through
  ``args.correlation`` -> the launch (``cudaLaunchKernel``,
  ``cuLaunchKernelEx``, ``cudaMemcpyAsync``) -> the innermost enclosing
  ``dgcph.`` range on the launching thread; a launch on a thread without
  ranges (the autograd engine's) takes the other threads' ranges; an
  event without a launch stays unattributed. The table equals the JAX
  ``phase_table`` of the same events written in XLA's form (``tf_op``
  scope paths), and ``profile_json`` equals the JAX one on that table.
* A CPU profiler trace of a port train step with the markers on: its ops
  land in the step's phases.
"""

import json
import os

import pytest
import torch

from dgc_tpu.telemetry import attrib as jattrib
from dgc_tpu.telemetry import trace as jtrace
from dgc_tpu_torch import configs
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.telemetry import attrib, trace
from dgc_tpu_torch.telemetry.sink import TelemetrySink, read_run
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def markers_on():
    prev = trace.enable(True)
    yield
    trace.enable(prev)


# --------------------------------------------------------------------- #
# the markers and the host spans                                         #
# --------------------------------------------------------------------- #

def test_phase_vocabulary_and_switch(monkeypatch):
    assert trace.PHASES == jtrace.PHASES
    assert trace.SCOPE_PREFIX == jtrace.SCOPE_PREFIX
    for args in (("select", 3), ("pack",), ("apply", -1)):
        assert trace.scope_name(*args) == jtrace.scope_name(*args)
    assert not trace.enabled()
    ctx = trace.phase("select", 1)
    assert type(ctx).__name__ == "nullcontext"
    prev = trace.enable(True)
    try:
        assert prev is False and trace.enabled()
        assert type(trace.phase("select", 1)).__name__ != "nullcontext"
    finally:
        trace.enable(False)

    @trace.phased("apply")
    def kernel(x):
        """doc"""
        return x + 1
    assert kernel(1) == 2 and kernel.__name__ == "kernel"
    from dgc_tpu_torch.ops import kernels
    assert kernels.apply_rows.__wrapped__.__name__ == "apply_rows"
    assert kernels.topk_rows.__wrapped__.__name__ == "topk_rows"


def test_markers_record_ranges_only_when_on(markers_on):
    x = torch.randn(64)
    with torch.profiler.profile() as prof:
        with trace.phase("compensate"):
            with trace.phase("select", 2):
                torch.topk(x, 4)
    names = [e.name for e in prof.events()]
    assert "dgcph.compensate" in names and "dgcph.select.b2" in names
    trace.enable(False)
    with torch.profiler.profile() as prof:
        with trace.phase("compensate"):
            torch.topk(x, 4)
    assert not any(e.name.startswith("dgcph.") for e in prof.events())


def test_span_tracer_nesting_summary_and_export(tmp_path):
    tr = trace.SpanTracer(max_events=16)
    with tr.span("step", step=1):
        with tr.span("data_load"):
            pass
    with pytest.raises(RuntimeError):
        with tr.span("eval"):
            raise RuntimeError("boom")
    assert list(tr.wrap_iter(range(3), "data_load")) == [0, 1, 2]
    evs = tr.events()
    assert [e["name"] for e in evs][:3] == ["data_load", "step", "eval"]
    assert evs[0]["args"]["parent"] == "step" and evs[1]["args"] == {
        "step": 1}
    summ = tr.step_summary()
    assert set(summ) == {"step", "data_load", "eval"}
    assert tr.step_summary() == {}
    obj = tr.chrome_trace()
    assert trace.validate_chrome_trace(obj) == []
    assert jtrace.validate_chrome_trace(obj) == []
    for name in ("t.json", "t.json.gz"):
        p = tr.save(str(tmp_path / name))
        assert os.path.exists(p)
    assert trace.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]})
    assert trace.validate_chrome_trace({}) == [
        "traceEvents: missing or not a list"]
    assert trace.NULL_TRACER.save("x") is None
    assert list(trace.NULL_TRACER.wrap_iter([1], "d")) == [1]
    with trace.NULL_TRACER.span("x"):
        pass
    assert trace.NULL_TRACER.step_summary() == {}


def test_spans_through_the_sink_rebuild_as_the_reference(tmp_path, capsys):
    s = TelemetrySink(str(tmp_path))
    tr = trace.SpanTracer(sink=s)
    with tr.span("step", epoch=0):
        with tr.span("data_load"):
            pass
    s.close()
    _, recs = read_run(s.path)
    spans = [r for r in recs if r.get("event") == "span"]
    assert len(spans) == 2
    assert (trace.chrome_trace_from_records(recs)
            == jtrace.chrome_trace_from_records(recs))
    out = tmp_path / "trace.json"
    assert trace._main([s.path, "-o", str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    assert trace.validate_chrome_trace(json.loads(out.read_text())) == []


# --------------------------------------------------------------------- #
# attribution on a Kineto-format trace                                   #
# --------------------------------------------------------------------- #

MAIN, AUTOGRAD, STREAM = 118, 146, 7

#: (name, ts, dur) of the step thread's ranges: nested as a step nests
_RANGES = [("dgcph.fwd_bwd", 0, 1000), ("dgcph.update", 1000, 900),
           ("dgcph.compensate", 1010, 100), ("dgcph.select.b0", 1120, 200),
           ("dgcph.threshold.b0", 1140, 60), ("dgcph.select", 1150, 20),
           ("dgcph.pack.b0", 1330, 20), ("dgcph.allgather", 1400, 100),
           ("dgcph.decode", 1510, 50), ("dgcph.apply", 1570, 100),
           ("dgcph.apply", 1575, 50), ("dgcph.pack", 1580, 10),
           ("dgcph.dense", 1700, 150), ("dgcph.loss", 1900, 40)]

#: (device event name, cat, launch tid, launch name, launch ts, dur us,
#: the scope path the launch sits in)
_KERNELS = [
    ("void cutlass::Kernel2<sgemm>", "kernel", MAIN, "cuLaunchKernel", 100,
     300.0, "dgcph.fwd_bwd"),
    # the backward, launched by the autograd engine's thread
    ("void wgrad_kernel", "kernel", AUTOGRAD, "cudaLaunchKernel", 600,
     500.0, "dgcph.fwd_bwd"),
    ("compensate_bits_kernel", "kernel", MAIN, "cuLaunchKernelEx", 1020,
     180.0, "dgcph.update/dgcph.compensate"),
    ("topk_rows_kernel<true>", "kernel", MAIN, "cudaLaunchKernel", 1125,
     90.0, "dgcph.update/dgcph.select.b0"),
    ("topk_rows_kernel<false>", "kernel", MAIN, "cudaLaunchKernel", 1155,
     40.0, "dgcph.update/dgcph.select.b0/dgcph.threshold.b0/dgcph.select"),
    ("reduce_kernel", "kernel", MAIN, "cudaLaunchKernel", 1190, 10.0,
     "dgcph.update/dgcph.select.b0/dgcph.threshold.b0"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", MAIN,
     "cudaMemcpyAsync", 1335, 20.0, "dgcph.update/dgcph.pack.b0"),
    ("ncclDevKernel_AllGather", "kernel", MAIN, "cudaLaunchKernelExC", 1410,
     300.0, "dgcph.update/dgcph.allgather"),
    ("Memset (Device)", "gpu_memset", MAIN, "cudaMemsetAsync", 1520, 5.0,
     "dgcph.update/dgcph.decode"),
    ("apply_scan_kernel", "kernel", MAIN, "cudaLaunchKernel", 1577, 120.0,
     "dgcph.update/dgcph.apply/dgcph.apply"),
    ("pack_kernel", "kernel", MAIN, "cudaLaunchKernel", 1582, 8.0,
     "dgcph.update/dgcph.apply/dgcph.apply/dgcph.pack"),
    ("ncclDevKernel_AllReduce", "kernel", MAIN, "cudaLaunchKernel", 1710,
     70.0, "dgcph.update/dgcph.dense"),
    ("sgd_kernel", "kernel", MAIN, "cudaLaunchKernel", 1860, 30.0,
     "dgcph.update"),
    ("loss_allreduce", "kernel", MAIN, "cudaLaunchKernel", 1910, 12.0,
     "dgcph.loss"),
    # a launch outside every range, and a device event with no launch
    ("eval_kernel", "kernel", MAIN, "cudaLaunchKernel", 2500, 50.0, ""),
    ("orphan_kernel", "kernel", None, None, None, 25.0, ""),
]


def _kineto_events():
    evs = [{"ph": "M", "name": "process_name", "pid": MAIN, "tid": 0,
            "args": {"name": "python"}}]
    for name, ts, dur in _RANGES:
        evs.append({"ph": "X", "cat": "user_annotation", "name": name,
                    "pid": MAIN, "tid": MAIN, "ts": 1e9 + ts, "dur": dur,
                    "args": {"External id": 1}})
        # the device copy of the range, which attribution does not read
        evs.append({"ph": "X", "cat": "gpu_user_annotation", "name": name,
                    "pid": 0, "tid": STREAM, "ts": 1e9 + ts + 5000,
                    "dur": 3 * dur, "args": {}})
    evs.append({"ph": "X", "cat": "user_annotation", "name": "host.step",
                "pid": MAIN, "tid": MAIN, "ts": 1e9 - 10, "dur": 3000,
                "args": {}})
    for corr, (name, cat, tid, launch, ts, dur, _) in enumerate(_KERNELS):
        if launch is not None:
            evs.append({"ph": "X", "cat": ("cuda_driver" if launch.startswith(
                "cu") and not launch.startswith("cuda") else "cuda_runtime"),
                "name": launch, "pid": MAIN, "tid": tid, "ts": 1e9 + ts,
                "dur": 3.0, "args": {"correlation": corr + 100}})
        evs.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                    "tid": STREAM, "ts": 1e9 + 10000 + 10 * corr,
                    "dur": dur, "args": {"correlation": corr + 100,
                                         "stream": STREAM}})
        evs.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr,
                    "pid": MAIN, "tid": tid or MAIN, "ts": 1e9 + (ts or 0)})
    evs.append({"ph": "X", "cat": "cpu_op", "name": "aten::topk",
                "pid": MAIN, "tid": MAIN, "ts": 1e9 + 1124, "dur": 20,
                "args": {}})
    return evs


def _xla_events():
    """The same device events as the JAX profiler writes them: a device
    pid, op metadata with the scope path in ``tf_op``."""
    evs = [{"ph": "M", "name": "process_name", "pid": 1,
            "args": {"name": "/device:GPU:0"}}]
    for name, _, _, _, _, dur, scope in _KERNELS:
        evs.append({"ph": "X", "pid": 1, "tid": 1, "name": name, "ts": 0,
                    "dur": dur, "args": {"hlo_category": "fusion",
                                         "tf_op": "jit(step)/" + scope}})
    return evs


def test_kineto_attribution_matches_the_reference_table(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _kineto_events()}))
    for p in (str(path), str(tmp_path)):
        dev = attrib.device_events(attrib.load_trace_events(p))
        assert len(dev) == len(_KERNELS)
    scopes = {e["name"]: e["args"].get("dgc_scope", "") for e in dev}
    for name, *_, scope in _KERNELS:
        assert scopes[name] == scope, name
    assert attrib.op_phase({"args": {"dgc_scope": scopes[
        "pack_kernel"]}}) == ("pack", None)
    assert attrib.op_phase(dev[0]) in (("fwd_bwd", None),)
    table = attrib.phase_table(dev, steps=2)
    want = jattrib.phase_table(jattrib.device_events(_xla_events()),
                               steps=2)
    assert table == want
    assert table["phases"]["compensate"] == pytest.approx(0.09)
    assert table["buckets"]["b0"]["threshold"] == pytest.approx(0.005)
    assert table["unattributed_ms"] == pytest.approx(0.0375)
    assert list(table["phases"]) == [p for p in trace.PHASES
                                     if p in table["phases"]]
    prof = attrib.profile_json(table, attrib.phase_table([], 2),
                               static={"world": 4},
                               measured_overhead_ms=1.5)
    assert prof == jattrib.profile_json(want, jattrib.phase_table([], 2),
                                        static={"world": 4},
                                        measured_overhead_ms=1.5)
    p = attrib.write_profile(prof, str(tmp_path / "profile.json"))
    assert attrib.load_profile(p) == jattrib.load_profile(p) == prof
    with pytest.raises(ValueError, match="not a dgc-profile"):
        attrib.load_profile(str(path))
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps(dict(prof, version=2)))
    with pytest.raises(ValueError, match="version"):
        attrib.load_profile(str(bad))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no"):
        attrib.load_trace_events(str(tmp_path / "empty"))


def test_cpu_trace_of_a_port_step(tmp_path, markers_on):
    """On the CPU the outermost ops of each thread are the events, each in
    its own thread's ranges: a step's exchange lands in its phases."""
    cfg = configs.resnet20_wm5()
    cfg.dataset.synthetic_size = 32
    cfg.train.batch_size = 4
    t = Trainer(cfg, LocalComm(2), "cpu")
    t.run_epoch(5, 1)
    with profiling.trace(str(tmp_path)):
        t.run_epoch(5, 2, start=1)
    events = attrib.load_trace_events(str(tmp_path))
    dev = attrib.device_events(events)
    assert dev and all(e["cat"] == "cpu_op" for e in dev)
    table = attrib.phase_table(dev, steps=1)
    for ph in ("fwd_bwd", "compensate", "threshold", "select", "pack",
               "allgather", "decode", "apply", "dense", "update", "loss"):
        assert table["phases"].get(ph, 0) > 0, ph
    assert table["buckets"] and 0 < table["attributed_ms"] <= table[
        "total_ms"]
    # the step's own ops, phase by phase: nothing of a step outside them
    # but the host's bookkeeping between the ranges
    assert table["attributed_ms"] > 0.5 * table["total_ms"]
