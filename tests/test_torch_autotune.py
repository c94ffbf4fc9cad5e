"""The port's autotuner against the JAX package's: the same recorded
points give the same refit (alpha, bandwidth), the same replan decision
and plan at every epoch boundary, the same ``fabric.json`` fields (the
timestamp aside), over the buckets both packages build from ResNet-20
across the wm5 warm-up; the point pool's cap and filter; and the inputs
the port has no source for (a telemetry profile, the fleet lanes) and the
gossip candidates refused."""

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


def test_point_pool_and_refusals(engines):
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
    with pytest.raises(NotImplementedError, match="item 9"):
        tat.add_profile({"dgc": {}}, te)
    with pytest.raises(NotImplementedError, match="item 9"):
        tat.add_fleet_view("runs", 100)
    with pytest.raises(NotImplementedError, match="item 9"):
        tat.epoch_end(te, profile={"dgc": {"buckets": {}}})
    with pytest.raises(ValueError, match="item 8"):
        ta.Autotuner("32x25GbE", world=4, candidates=("gossip_ring",))
    with pytest.raises(ValueError, match="item 8"):
        ta.Autotuner("32x25GbE", world=4, gossip_max_staleness=3)
