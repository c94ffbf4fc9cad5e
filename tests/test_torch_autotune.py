"""The port's autotuner against the JAX package's: the same recorded
points give the same refit (alpha, bandwidth), the same replan decision
and plan at every epoch boundary, the same ``fabric.json`` fields (the
timestamp aside), over the buckets both packages build from ResNet-20
across the wm5 warm-up; the point pool's cap and filter; the telemetry
inputs (a ``dgc-profile`` table's per-bucket all-gather costs through
``add_profile`` and ``epoch_end(profile=)``, a run's fleet lanes through
``add_fleet_view``) giving the JAX autotuner's points, refit and sink
records; and the gossip candidates and schedule options planned as the
JAX autotuner plans them."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression import autotune as ja
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils.pytree import named_flatten
from dgc_tpu_torch.compression import autotune as ta
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.telemetry.sink import TelemetrySink


@pytest.fixture(scope="module")
def engines():
    tree = jax.eval_shape(lambda: resnet20().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=True))["params"]
    shapes = {n: tuple(x.shape) for n, x in named_flatten(tree)[0].items()}
    jtree = {n: jax.ShapeDtypeStruct(s, jnp.float32)
             for n, s in shapes.items()}
    kw = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, **kw)
    comp = [(n, s) for n, s in shapes.items() if len(s) > 1]
    jc.initialize((n, jtree[n]) for n, _ in comp)
    tc.initialize(comp)
    out = []
    for epoch in range(6):
        jc.warmup_compress_ratio(epoch)
        tc.warmup_compress_ratio(epoch)
        out.append((FlatDGCEngine(jc, ParamLayout.for_compressor(jtree, jc)),
                    tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                        shapes, tc))))
    return out


class _Sink:
    def __init__(self):
        self.records = []

    def write_record(self, r):
        self.records.append(r)


@pytest.mark.parametrize("world,fabric", [(4, "32x25GbE"), (8, "ici_v5e8"),
                                          (2, None)])
def test_refits_and_replans_match_jax(engines, tmp_path, monkeypatch, world,
                                      fabric):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DGC_FABRIC", raising=False)
    sinks = _Sink(), _Sink()
    jat = ja.Autotuner(fabric, world=world, sink=sinks[0],
                       fabric_out=str(tmp_path / "j" / "fabric.json"))
    tat = ta.Autotuner(fabric, world=world, sink=sinks[1],
                       fabric_out=str(tmp_path / "t" / "fabric.json"))
    assert tat.fabric == ta.Fabric(*jat.fabric)
    rng = np.random.RandomState(world)
    for epoch, (je, te) in enumerate(engines):
        jp, tp = jat.plan_for(je), tat.plan_for(te)
        assert tp.key() == jp.key()
        wire = te.wire_bytes_per_worker() or 4 * te.layout.total
        assert wire == (je.wire_bytes_per_worker() or 4 * je.layout.total)
        # step intervals: a slow link (ms grow with the bytes) plus noise
        for _ in range(3):
            ms = float(1.0 + wire / 2e5 * (1 + 0.1 * rng.rand()))
            jat.record_step(ms, wire)
            tat.record_step(ms, wire)
        jn, tn = jat.epoch_end(je, epoch=epoch), tat.epoch_end(te,
                                                              epoch=epoch)
        assert (jn is None) == (tn is None)
        if tn is not None:
            assert tn.key() == jn.key()
        assert tat.fabric == ta.Fabric(*jat.fabric)
        np.testing.assert_allclose(tat.fabric.gbps, jat.fabric.gbps,
                                   rtol=1e-12)
        assert (tat.refit_count, tat.replan_count) == (jat.refit_count,
                                                       jat.replan_count)
        assert tat.plan.key() == jat.plan.key()
    assert sinks[1].records == sinks[0].records
    assert tat._fit_residual_ms() == pytest.approx(jat._fit_residual_ms(),
                                                   rel=1e-12)
    got, want = (json.loads((tmp_path / d / "fabric.json").read_text())
                 for d in ("t", "j"))
    for obj in (got, want):
        obj["provenance"].pop("written_at")
    assert got == want
    assert ta.regime_histogram(tat.plan.regimes) == ja.regime_histogram(
        jat.plan.regimes)


class _Sink:
    def __init__(self):
        self.records = []

    def write_record(self, rec):
        self.records.append(rec)


def test_point_pool_and_refusals(engines, tmp_path):
    je, te = engines[5]
    tat = ta.Autotuner("32x25GbE", world=4, max_points=3, min_points=2)
    jat = ja.Autotuner("32x25GbE", world=4, max_points=3, min_points=2)
    for a in (tat, jat):
        for ms, b in ((1.0, 10), (0.0, 10), (2.0, 0), (3.0, 20), (4.0, 30),
                      (5.0, 40)):
            a.record_step(ms, b)
    assert tat.points == jat.points == [(20.0, 3.0), (30.0, 4.0),
                                        (40.0, 5.0)]
    fresh = ta.Autotuner("32x25GbE", world=4)
    assert fresh.epoch_end(te) is None and fresh.refit_count == 0
    # the telemetry inputs: a profile table's per-bucket all-gather ms
    # against each bucket's wire bytes, and a run's fleet lanes
    assert te.bucket_wire_bytes() == je.bucket_wire_bytes()
    prof = {"dgc": {"buckets": {
        f"b{i}": {"allgather": 0.05 * (i + 1), "select": 1.0}
        for i in range(len(te.buckets))}}}
    prof["dgc"]["buckets"]["b0"]["allgather"] = 0.0       # not a point
    for a in (tat, jat):
        a.max_points = 4096
        assert a.add_profile(None, None) == 0
        assert a.add_profile({"dgc": {}}, te) == 0
    assert tat.add_profile(prof, te) == jat.add_profile(prof, je) == len(
        te.buckets) - 1
    assert tat.points == jat.points
    run = tmp_path / "run"
    sinks = []
    with TelemetrySink(str(run / "telemetry" / "host0"), fleet=True) as s:
        for step in range(5):
            s.write(step, {"w_clock": np.asarray([10.0 + step, 30.0,
                                                  0.0, 20.0], np.float32)})
    assert tat.add_fleet_view(str(run), 700) == jat.add_fleet_view(
        str(run), 700) == 5
    assert tat.add_fleet_view(str(tmp_path / "none"), 700) == 0
    assert tat.points == jat.points and tat.points[-1] == (700.0, 30.0)
    for a, sink in ((tat, _Sink()), (jat, _Sink())):
        a.sink = sink
        sinks.append(sink)
    tplan = tat.epoch_end(te, epoch=5, profile=prof)
    jplan = jat.epoch_end(je, epoch=5, profile=prof)
    assert tat.points == jat.points
    assert (tat.fabric.gbps, tat.fabric.alpha_ms) == pytest.approx(
        (jat.fabric.gbps, jat.fabric.alpha_ms), rel=1e-12)
    assert (tplan is None) == (jplan is None)
    assert sinks[0].records == sinks[1].records
    assert sinks[0].records[0]["event"] == "autotune_replan"
    # the gossip opt-in: the family among the candidates, the schedule
    # knobs carried into every plan, as the JAX autotuner carries them
    for kw in (dict(candidates=("gossip_ring",)),
               dict(candidates=ta.REGIMES + ("gossip_hcube",),
                    gossip_sync_every=2, gossip_max_staleness=3),
               dict(gossip_max_staleness=3)):
        tg = ta.Autotuner("32x25GbE", world=4, **kw)
        jg = ja.Autotuner("32x25GbE", world=4, **kw)
        tpl, jpl = tg.plan_for(te), jg.plan_for(je)
        assert tpl.regimes == jpl.regimes and tpl.key() == jpl.key()
        assert tpl.gossip == jpl.gossip
        for a in (tg, jg):
            for ms, b in ((3.0, 20), (4.0, 30), (5.0, 40)):
                a.record_step(ms, b)
        tn, jn = tg.epoch_end(te, epoch=5), jg.epoch_end(je, epoch=5)
        assert (tn is None) == (jn is None)
        assert tg.plan.key() == jg.plan.key()
