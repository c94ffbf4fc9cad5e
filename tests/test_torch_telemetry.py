"""The port's telemetry against the JAX package: the registry, the taps, the
engine's step stats, the async sink and the CLI.

* The registry's tables and header are the JAX registry's.
* The taps (``l2``, ``l1``, ``bucket_payload_stats``, ``empty_bucket_
  stats``, ``assemble_step_stats``) on seeded inputs equal the JAX taps;
  ``pmean_stats`` is ONE all-reduce of a packed vector.
* The engine: ``exchange(..., telemetry=True)`` at W=8 on ResNet-20's
  layout at the warm-up's first ratio (0.316) and at 0.001, with the bf16
  state and int8 error feedback, with clipping, and on the dense baseline
  engine, against the JAX engine's ``exchange(..., telemetry=True)`` run
  op by op under ``jax.vmap`` with the same sampling phases: counts,
  fractions, thresholds and wire bytes bitwise; the norms and masses
  within rtol 1e-6, because the two sum [T] elements in other orders.
  Telemetry off changes no output, memory or kernel call.
* The sink: one packed copy a record into the ring, no host read of a
  stats tensor on the caller's thread, drops counted when the ring is
  full; its files read by the JAX package's readers as by the port's.
* The CLI: ``--config resnet20_wm5_telemetry --device cpu --steps 2``
  writes one sink record a step under a valid header and a valid
  ``trace.json``; the refusals of the reference.
"""

import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.base import Compression as JCompression
from dgc_tpu.compression.flat import FlatDenseExchange as JDense
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.telemetry import registry as jreg
from dgc_tpu.telemetry import sink as jsink
from dgc_tpu.telemetry import taps as jtaps
from dgc_tpu.utils import clip_grad as jclip
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.base import Compression as TCompression
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.telemetry import registry, sink, taps
from dgc_tpu_torch.telemetry.trace import validate_chrome_trace
from dgc_tpu_torch.train import main
from dgc_tpu_torch.utils import clip_grad as tclip

W = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# registry and taps                                                      #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("table", ["STEP_METRICS", "GUARD_METRICS",
                                   "FLEET_METRICS", "RUN_METRICS",
                                   "CONTROL_ACTIONS", "SERVING_METRICS"])
def test_registry_tables_are_the_references(table):
    assert ([tuple(s) for s in getattr(registry, table)]
            == [tuple(s) for s in getattr(jreg, table)])


def test_registry_header_and_validators():
    static = {"engine": "FlatDGCEngine", "world": 4}
    for kw in ({}, {"guards": True}, {"fleet": True},
               {"guards": True, "fleet": True}):
        assert (registry.make_header(static, **kw)
                == jreg.make_header(static, **kw))
    assert registry.SCHEMA == jreg.SCHEMA
    assert registry.SCHEMA_VERSION == jreg.SCHEMA_VERSION
    assert not hasattr(registry, "step_out_specs")
    good = {n: 0.0 for n in registry.step_stat_names()}
    registry.validate_step_stats(good)
    with pytest.raises(ValueError, match="missing"):
        registry.validate_step_stats({k: v for k, v in good.items()
                                      if k != "grad_norm"})
    with pytest.raises(ValueError, match="extra"):
        registry.validate_fleet_stats(
            dict({n: 0.0 for n in registry.fleet_stat_names()}, bogus=1))
    with pytest.raises(ValueError, match="missing"):
        registry.validate_guard_stats({})
    rec = {"event": "control_action", "run": "r", "run_id": "1",
           "rule": "x", "action": "restart", "evidence": {"a": 1}, "t": 0}
    registry.validate_control_action(rec)
    jreg.validate_control_action(rec)
    with pytest.raises(ValueError, match="unknown control action"):
        registry.validate_control_action(dict(rec, action="reboot"))


def test_taps_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(1000).astype(np.float32)
    for f in ("l2", "l1"):
        t = getattr(taps, f)(torch.from_numpy(x))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t),
                                   float(getattr(jtaps, f)(jnp.asarray(x))),
                                   rtol=1e-6)
        assert float(getattr(taps, f)(None)) == 0.0
        assert float(getattr(taps, f)(torch.zeros(0))) == 0.0
    assert taps.l2(torch.from_numpy(x).bfloat16()).dtype == torch.float32
    S = 999
    vals = rng.randn(64).astype(np.float32)
    gidx = rng.randint(0, 50, 64).astype(np.int32)
    gidx[::3] = S
    for v, i in ((vals, gidx), (vals, np.full(64, S, np.int32))):
        tc, tt = taps.bucket_payload_stats(torch.from_numpy(v),
                                           torch.from_numpy(i), S)
        jc, jt = jtaps.bucket_payload_stats(jnp.asarray(v), jnp.asarray(i),
                                            S)
        assert float(tc) == float(jc) and float(tt) == float(jt)
    for n in (0, 3):
        te, je = taps.empty_bucket_stats(n), jtaps.empty_bucket_stats(n)
        assert set(te) == set(je)
        for k in te:
            assert tuple(te[k].shape) == tuple(je[k].shape)
    kw = {k: torch.tensor(float(i))
          for i, k in enumerate(registry.step_stat_names())}
    st = taps.assemble_step_stats(**kw)
    assert list(st) == list(registry.step_stat_names())
    with pytest.raises(TypeError):
        taps.assemble_step_stats(grad_norm=torch.tensor(1.0))


class _Recording(LocalComm):
    def __init__(self, world):
        super().__init__(world)
        self.calls = {"all_gather": 0, "all_reduce": 0}

    def all_gather(self, xs):
        self.calls["all_gather"] += 1
        return super().all_gather(xs)

    def all_reduce(self, xs):
        self.calls["all_reduce"] += 1
        return super().all_reduce(xs)


def test_pmean_stats_is_one_packed_all_reduce():
    rng = np.random.RandomState(5)
    stats = []
    for w in range(3):
        kw = {k: torch.tensor(float(rng.randn()))
              for k in registry.step_stat_names()}
        kw["selected_frac"] = torch.from_numpy(rng.rand(4).astype(np.float32))
        kw["threshold"] = torch.from_numpy(rng.rand(4).astype(np.float32))
        stats.append(taps.assemble_step_stats(**kw))
    comm = _Recording(3)
    mean = taps.pmean_stats(stats, comm)
    assert comm.calls == {"all_gather": 0, "all_reduce": 1}
    for k in stats[0]:
        want = (stats[0][k] + stats[1][k] + stats[2][k]) / torch.tensor(3.0)
        assert torch.equal(mean[k], want), k
        assert mean[k].shape == stats[0][k].shape


# --------------------------------------------------------------------- #
# the engine's step stats against the JAX engine                         #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def r20_params():
    """ResNet-20's parameter tree, zeros of its shapes (the engines read
    shapes only)."""
    v = jax.eval_shape(lambda: resnet20().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), v["params"])


def _engines(tree, epoch, bf16=False, clip=False, **kw):
    dtype = "bfloat16" if bf16 else None
    # a value clip: no factor from a sum, so both clip bitwise alike
    jm = DGCSGDMemory(momentum=0.9, dtype=dtype, gradient_clipping=(
        functools.partial(jclip.clip_grad_value, clip_value=0.7)
        if clip else None))
    tm = TMemory(momentum=0.9, dtype=dtype, gradient_clipping=(
        functools.partial(tclip.clip_grad_value, clip_value=0.7)
        if clip else None))
    common = dict(sample_ratio=0.01, warmup_epochs=5, **kw)
    # the JAX engine's exact top-k (its CPU approx_max_k orders equal bf16
    # magnitudes its own way, test_torch_bf16mem.py)
    jc = DGCCompressor(0.001, memory=jm, approx_recall=None, **common)
    tc = tdgc.DGCCompressor(0.001, memory=tm, **common)
    named = jax_named_flatten(tree)[0]
    jc.initialize((n, p) for n, p in named.items() if np.ndim(p) > 1)
    tc.initialize((n, np.shape(p)) for n, p in named.items()
                  if np.ndim(p) > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(tree, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(tree,
                                                                    tc)))


def _phases(engine, key, world=W):
    out = []
    for w in range(world):
        kw = jax.random.fold_in(key, w)
        out.append([[] if b.exact else [
            float(jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(kw, bi), gi), ()))
            for gi in range(len(b.stride_groups))]
            for bi, b in enumerate(engine.buckets)])
    return out


#: stats the two engines give bitwise; the rest sum [T] elements
_EXACT = ("payload_elems", "selected_frac", "threshold", "wire_bytes")


def _check_stats(jst, tst, label, exact_too=()):
    assert set(jst) == set(tst[0]) == set(registry.step_stat_names())
    for k in jst:
        j = np.asarray(jst[k])
        t = np.stack([s[k].numpy() for s in tst])
        assert t.dtype == np.float32 and t.shape == j.shape, (label, k)
        if k in _EXACT or k in exact_too:
            np.testing.assert_array_equal(t, j, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0,
                                       err_msg=f"{label} {k}")


def _run_dgc(je, te, steps, seed, clip=False):
    step = jax.vmap(lambda fg, mem, key: je.exchange(
        fg, mem, jax.random.fold_in(key, jax.lax.axis_index("data")),
        "data", W, telemetry=True), in_axes=(0, 0, None), axis_name="data")
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(seed)
    for s in range(steps):
        g = rng.randn(W, te.layout.total).astype(np.float32)
        key = jax.random.PRNGKey(10 * seed + s)
        _, jmem, jst = step(jnp.asarray(g), jmem, key)
        _, tst = te.exchange([torch.from_numpy(x) for x in g], tmems,
                             _phases(je, key), LocalComm(W), telemetry=True)
        _check_stats(jst, tst, f"step {s}", exact_too=("clip_delta",)
                     if not clip else ())
    return tst


@pytest.mark.parametrize("epoch", [0, 5])
def test_engine_stats_match_jax(r20_params, epoch):
    je, te = _engines(r20_params, epoch)
    assert len(te.buckets) > 1 and te.payload_size
    tst = _run_dgc(je, te, steps=2, seed=epoch)
    # the stats describe the engine's geometry
    assert float(tst[0]["wire_bytes"]) == te.wire_bytes_per_worker()
    assert 0 < float(tst[0]["payload_elems"]) <= te.payload_size


def test_engine_stats_match_jax_bf16_int8_feedback(r20_params):
    je, te = _engines(r20_params, 5, bf16=True, int8_values=True,
                      int8_error_feedback=True)
    assert te.regimes[0] == "int8" and te.state_dtype == torch.bfloat16
    _run_dgc(je, te, steps=2, seed=3)


def test_engine_stats_match_jax_with_clipping(r20_params):
    je, te = _engines(r20_params, 0, clip=True)
    tst = _run_dgc(je, te, steps=1, seed=4, clip=True)
    assert all(float(s["clip_delta"]) > 0 for s in tst)


def test_all_dense_branch_and_dense_engine_stats_match_jax(r20_params):
    # the DGC engine at a dense ratio (the warm-up's coefficient 1)
    je, te = _engines(r20_params, 0, warmup_coeff=[1] * 5)
    assert te.dense and not te.buckets
    step = jax.vmap(lambda fg, mem, key: je.exchange(
        fg, mem, key, "data", W, telemetry=True),
        in_axes=(0, 0, None), axis_name="data")
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    g = np.random.RandomState(8).randn(W, te.layout.total).astype(
        np.float32)
    _, _, jst = step(jnp.asarray(g), jmem, jax.random.PRNGKey(0))
    _, tst = te.exchange([torch.from_numpy(x) for x in g], tmems,
                         [None] * W, LocalComm(W), telemetry=True)
    _check_stats(jst, tst, "all-dense", exact_too=("clip_delta",))
    # the dense baseline's engine: the gradient's norm, zeros elsewhere
    jd = JDense(JCompression.none(), ParamLayout(r20_params))
    td = tflat.FlatDenseExchange(TCompression.none(),
                                 tflat.ParamLayout(r20_params))
    _, _, jst = jax.vmap(lambda fg: jd.exchange(
        fg, {}, None, "data", W, telemetry=True), axis_name="data")(
        jnp.asarray(g))
    _, tst = td.exchange([torch.from_numpy(x) for x in g], None, None,
                         LocalComm(W), telemetry=True)
    _check_stats(jst, tst, "dense engine", exact_too=("clip_delta",))


def test_telemetry_off_changes_nothing(r20_params, monkeypatch):
    """The same exchange with and without telemetry: outputs and memory
    bitwise, the same kernel calls."""
    _, te = _engines(r20_params, 5)
    names = ("compensate_bits", "compensate_bits_cands", "topk_rows",
             "apply_rows")
    runs = []
    for tel in (False, True):
        calls = {n: 0 for n in names}
        for n in names:
            f = getattr(kernels, n)

            def wrap(*a, _f=f, _n=n, **k):
                calls[_n] += 1
                return _f(*a, **k)
            monkeypatch.setattr(kernels, n, wrap)
        mems = [te.init_memory("cpu") for _ in range(4)]
        rng = np.random.RandomState(1)
        for s in range(2):
            g = [torch.from_numpy(rng.randn(te.layout.total).astype(
                np.float32)) for _ in range(4)]
            ph = [te.draw_phases(torch.Generator().manual_seed(s + w))
                  for w in range(4)]
            out = te.exchange(g, mems, ph, LocalComm(4), telemetry=tel)
        runs.append((out[0] if tel else out, mems, calls))
        monkeypatch.undo()
    (o0, m0, c0), (o1, m1, c1) = runs
    assert c0 == c1 and c0["apply_rows"] == 8
    for a, b in zip(o0, o1):
        assert torch.equal(a, b)
    for a, b in zip(m0, m1):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_engine_geometry_for_the_header(r20_params):
    je, te = _engines(r20_params, 5, packed_indices=True)
    assert te.bucket_descriptors() == je.bucket_descriptors()
    assert te.telemetry_static() == je.telemetry_static()
    je, te = _engines(r20_params, 0)
    assert te.telemetry_static() == je.telemetry_static()


# --------------------------------------------------------------------- #
# the sink                                                               #
# --------------------------------------------------------------------- #

def _stats(rng, nb=3):
    out = {k: torch.tensor(float(rng.randn()))
           for k in registry.step_stat_names()}
    out["selected_frac"] = torch.from_numpy(rng.rand(nb).astype(np.float32))
    out["threshold"] = torch.from_numpy(rng.rand(nb).astype(np.float32))
    out["payload_elems"] = torch.tensor(12.0)
    return out


def test_sink_round_trip_read_by_both_packages(tmp_path):
    rng = np.random.RandomState(0)
    written = []
    with sink.TelemetrySink(str(tmp_path / "t"), static={"engine": "x"},
                            guards=True) as s:
        for step in range(5):
            st = dict(_stats(rng), skipped_steps=torch.tensor(0.0),
                      loss=2.5)
            written.append(st)
            s.write(step * 16, st)
        s.write_record({"event": "engine_rebuild", "epoch": 1})
        path = s.path
    assert path == str(tmp_path / "t" / "telemetry.jsonl")
    for reader in (sink.read_run, jsink.read_run):
        header, recs = reader(path)
        assert header["static"] == {"engine": "x"}
        assert header["guard_metrics"]
        steps = [r for r in recs if "event" not in r]
        assert [r["step"] for r in steps] == [0, 16, 32, 48, 64]
        for r, st in zip(steps, written):
            assert r["loss"] == 2.5 and r["payload_elems"] == 12
            assert isinstance(r["payload_elems"], int)
            assert r["selected_frac"] == [float(x) for x in
                                          st["selected_frac"]]
            assert r["grad_norm"] == float(st["grad_norm"])
    assert (sink.summarize(sink.read_run(path)[1])
            == jsink.summarize(jsink.read_run(path)[1]))
    sink.to_csv(path, str(tmp_path / "a.csv"))
    jsink.to_csv(path, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


def test_sink_caller_never_reads_a_stats_tensor(tmp_path, monkeypatch):
    """``write`` packs the stats and copies them once, without a host read
    of a stats tensor on the caller's thread (the drain thread reads the
    host buffer)."""
    main_thread = threading.get_ident()
    reads = []
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _n=name, **k):
            if threading.get_ident() == main_thread:
                reads.append(_n)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    cats = []
    orig_cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **k: cats.append(1) or orig_cat(*a, **k))
    s = sink.TelemetrySink(str(tmp_path))
    rng = np.random.RandomState(1)
    for step in range(3):
        s.write(step, _stats(rng))
    assert reads == [] and len(cats) == 3       # one packed copy a record
    monkeypatch.undo()
    s.close()
    assert len(sink.read_run(s.path)[1]) == 3


def test_sink_ring_drops_when_every_buffer_is_in_flight(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(sink, "RING", 2)
    s = sink.TelemetrySink(str(tmp_path))
    gate = threading.Event()
    orig = sink._Packed.unpack

    def held(self):
        gate.wait(10)
        return orig(self)
    sink._Packed.unpack = held
    try:
        rng = np.random.RandomState(2)
        for step in range(6):
            s.write(step, _stats(rng))
        # the drain holds one buffer, one waits queued: the rest drop
        assert s.dropped >= 3
    finally:
        gate.set()
        sink._Packed.unpack = orig
    s.close()
    header, recs = sink.read_run(s.path)
    steps = [r for r in recs if "event" not in r]
    assert 1 <= len(steps) <= 3
    assert recs[-1] == {"event": "sink_dropped", "count": 6 - len(steps)}


def test_sink_rotation_disabled_and_tolerant_reads(tmp_path):
    s = sink.TelemetrySink(str(tmp_path / "r.jsonl"), rotate_bytes=3000)
    rng = np.random.RandomState(3)
    for step in range(16):
        s.write(step, _stats(rng))
    s.close()
    files = sorted(os.listdir(tmp_path))
    assert len(files) > 1
    for f in files:
        assert sink.read_run(str(tmp_path / f))[0]["schema"] == \
            registry.SCHEMA
    off = sink.TelemetrySink(str(tmp_path / "off"), enabled=False)
    off.write(0, _stats(rng))
    off.close()
    assert off.path is None and not (tmp_path / "off").exists()
    torn = tmp_path / "torn.jsonl"
    torn.write_text((tmp_path / "r.jsonl").read_text() + '{"step": 9, "gr')
    for reader in (sink.read_run_tolerant, jsink.read_run_tolerant):
        h, recs, skipped = reader(str(torn))
        assert skipped == 1 and recs
    bad = tmp_path / "v2.jsonl"
    bad.write_text(json.dumps({"schema": registry.SCHEMA,
                               "version": 2}) + "\n")
    with pytest.raises(sink.SchemaMismatchError):
        sink.read_run(str(bad))
    appender = sink.JsonlAppender(str(tmp_path / "ev" / "e.jsonl"))
    appender.write({"event": "a"})
    appender.close()
    assert (tmp_path / "ev" / "e.jsonl").read_text() == '{"event": "a"}\n'


def test_sink_cli(tmp_path, capsys):
    s = sink.TelemetrySink(str(tmp_path))
    s.write(0, _stats(np.random.RandomState(4)))
    s.close()
    assert sink._main([s.path, "--csv", str(tmp_path / "o.csv")]) == 0
    out = capsys.readouterr().out
    assert "schema dgc-telemetry/v1, 1 records" in out and "grad_norm" in out
    assert (tmp_path / "o.csv").exists()


# --------------------------------------------------------------------- #
# the CLI and the refusals                                               #
# --------------------------------------------------------------------- #

def test_cli_writes_the_sink_and_the_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    main(["--config", "resnet20_wm5_telemetry", "--device", "cpu",
          "--world", "2", "--epochs", "1", "--steps", "2", "--batch-size",
          "4", "--synthetic-size", "32"])
    out = capsys.readouterr().out
    run = tmp_path / "runs" / ("cifar.resnet20+dgc.wm5+telemetry+fleet"
                               "+trace.np2")
    assert "[telemetry] ->" in out and "[fleet]" in out
    header, recs = sink.read_run(str(run / "telemetry" / "host0" /
                                     "telemetry.jsonl"))
    assert header["static"]["engine"] == "FlatDGCEngine"
    assert header["static"]["world"] == 2 and header["fleet_metrics"]
    steps = [r for r in recs if "event" not in r]
    assert [r["step"] for r in steps] == [8, 16]       # samples seen
    for r in steps:
        assert set(registry.step_stat_names()) <= set(r)
        assert set(registry.fleet_stat_names()) <= set(r)
        assert len(r["w_clock"]) == 2 and "loss" in r
    events = [r["event"] for r in recs if "event" in r]
    assert "engine_rebuild" in events and "span" in events
    trace = json.loads((run / "trace.json").read_text())
    assert validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"data_load", "step", "exchange_wait", "eval",
            "checkpoint"} <= names
    from dgc_tpu_torch.telemetry import trace as ttrace
    assert not ttrace.enabled()          # the CLI restores the switch


def test_cli_and_trainer_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="fleet w_clock"):
        main(["--config", "resnet20_wm5", "--adaptive", "--device", "cpu",
              "--steps", "1"])
    with pytest.raises(SystemExit, match="sparse DGC wire"):
        main(["--config", "resnet20", "--adaptive", "--device", "cpu",
              "--steps", "1"])
    monkeypatch.setenv("DGC_ADAPTIVE", "1")
    with pytest.raises(SystemExit, match="fleet w_clock"):
        main(["--config", "resnet20_wm5", "--device", "cpu", "--steps", "1"])
    from dgc_tpu_torch.train import Trainer
    cfg = tconfigs.with_adaptive(tconfigs.resnet20_wm5_telemetry())
    cfg.train.telemetry.fleet = False
    with pytest.raises(ValueError, match="fleet w_clock"):
        Trainer(cfg, LocalComm(2), "cpu")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("recipe", ["resnet20_wm5_telemetry",
                                    "resnet50_wm5_telemetry",
                                    "resnet50_wm5_adaptive"])
def test_recipes_match_the_config_files(recipe, monkeypatch):
    from dgc_tpu.utils.config import Config, configs
    from dgc_tpu_torch.train import get_save_path
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(*tconfigs.CONFIG_FILES[recipe])
        t = tconfigs.RECIPES[recipe]()
        c = configs.train
        assert dict(t.train.telemetry) == dict(c.telemetry)
        assert t.train.telemetry.fleet is True
        assert dict(t.train.trace) == dict(c.trace)
        if recipe.endswith("adaptive"):
            assert dict(t.train.adaptive) == dict(c.adaptive)
            base = tconfigs.resnet50_wm5_telemetry()
        else:
            assert "adaptive" not in t.train and "adaptive" not in c
            base = tconfigs.RECIPES[recipe.rsplit("_", 1)[0]]()
        assert t.train.compression == base.train.compression
        assert t.train.batch_size == c.batch_size
    finally:
        Config.reset()
    assert get_save_path(*tconfigs.CONFIG_FILES[recipe]).endswith(
        "+telemetry+fleet+trace" + ("+adaptive" if "adaptive" in recipe
                                    else ""))
    # the CLI's switches stack the same blocks
    cfg = tconfigs.with_adaptive(tconfigs.resnet20_wm5())
    assert cfg.train.telemetry.fleet and cfg.train.adaptive.enabled
    assert tconfigs.with_trace(tconfigs.resnet20_wm5()).train.trace.enabled
