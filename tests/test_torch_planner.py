"""The port's regime planner against the JAX package's (a copy of that
JAX-free module): the same regimes from
``plan_buckets`` / ``plan_engine`` for every built-in fabric at W = 2, 4
and 8 over the buckets both packages build from ResNet-20 across the wm5
warm-up (with and without the megakernel's coefficients, with a measured
fabric and with a per-bucket profile), the same cost tables and
``predicted_ms`` (rtol 1e-12), the same lanes and collectives;
``fit_link_model`` on the same points; ``fabric.json`` round trips with
equal ``Plan.key()``; the fabric resolution chain; and the gossip
families built or refused exactly where the JAX package builds or refuses
them, under its message."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression import planner as jp
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils.pytree import named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression import planner as tp


@pytest.fixture(scope="module")
def engines():
    """{epoch: (JAX engine, port engine)} over ResNet-20's layout."""
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
    out = {}
    for epoch in range(6):
        jc.warmup_compress_ratio(epoch)
        tc.warmup_compress_ratio(epoch)
        out[epoch] = (
            FlatDGCEngine(jc, ParamLayout.for_compressor(jtree, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                shapes, tc)))
    return out


def _same_plan(t, j):
    assert t.regimes == j.regimes and t.key() == j.key()
    assert t.world == j.world and t.fabric == tp.Fabric(*j.fabric)
    assert len(t.bucket_costs) == len(j.bucket_costs)
    for tc, jc in zip(t.bucket_costs, j.bucket_costs):
        assert set(tc) == set(jc)
        for r, v in tc.items():
            np.testing.assert_allclose(v, jc[r], rtol=1e-12, atol=0)
    tpm, jpm = t.predicted_ms(), j.predicted_ms()
    for k in ("planned_ms", "dense_ms", "ratio"):
        np.testing.assert_allclose(tpm[k], jpm[k], rtol=1e-12, atol=0)
    assert t.num_gathers == j.num_gathers
    assert t.collectives(2) == j.collectives(2)
    assert t.all_dense == j.all_dense
    assert t.sparse_regimes == j.sparse_regimes
    assert t.verify_descriptor() == j.verify_descriptor()


@pytest.mark.parametrize("fabric", sorted(jp.BUILTIN_FABRICS))
@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("megakernel", [False, True])
def test_plan_engine_matches_jax(engines, fabric, world, megakernel):
    for epoch, (je, te) in engines.items():
        j = jp.plan_engine(je, fabric=fabric, world=world,
                           megakernel=megakernel)
        t = tp.plan_engine(te, fabric=fabric, world=world,
                           megakernel=megakernel)
        _same_plan(t, j)
        # replanned against another epoch's geometry: still the same
        other = engines[(epoch + 3) % 6]
        _same_plan(t.replan(other[1]), j.replan(other[0]))


@pytest.mark.parametrize("world", [2, 4, 8])
def test_plan_buckets_matches_jax_on_measured_fabrics(engines, world):
    """A measured fabric with an intercept, a per-bucket profile, a cost
    model of its own and a narrower candidate set."""
    je, te = engines[3]
    fab = dict(name="lab", workers=world, gbps=12.5, alpha_ms=0.03,
               measured=True)
    cost = dict(fixed_ms_per_bucket=0.05, quant_ms_per_elem=1e-7)
    profile = {"dgc": {"buckets": {f"b{i}": {"select": 0.1 * (i + 1),
                                             "allgather": 0.02}
                                   for i in range(len(je.buckets))}}}
    for cands in (jp.REGIMES, ("dense", "fp32", "int8_packed")):
        j = jp.plan_engine(je, fabric=jp.Fabric(**fab), world=world,
                           profile=profile, cost=jp.CostModel(**cost),
                           candidates=cands)
        t = tp.plan_engine(te, fabric=tp.Fabric(**fab), world=world,
                           profile=profile, cost=tp.CostModel(**cost),
                           candidates=cands)
        _same_plan(t, j)
        assert tp.bucket_ms_from_profile(profile, len(te.buckets)) == \
            jp.bucket_ms_from_profile(profile, len(je.buckets))
    geoms_j = [jp.bucket_geometry(b) for b in je.buckets]
    geoms_t = [tp.bucket_geometry(b) for b in te.buckets]
    assert [tuple(g) for g in geoms_t] == [tuple(g) for g in geoms_j]
    for fab_name in jp.BUILTIN_FABRICS:
        _same_plan(tp.plan_buckets(geoms_t, fabric=fab_name, world=world),
                   jp.plan_buckets(geoms_j, fabric=fab_name, world=world))


@pytest.mark.parametrize("points", [
    [(1e6, 2.0), (4e6, 5.0), (2e6, 3.1)],
    [(1e6, 2.0), (1e6, 2.5)],
    [(5e5, 0.4)],
    [(1e6, 2.0), (0.0, 1.0), (3e6, -1.0), (8e6, 9.5)]])
@pytest.mark.parametrize("prior", [None, ("p", 4, 3.125, 0.5, True)])
def test_fit_link_model_matches_jax(points, prior):
    got = tp.fit_link_model(points, prior=prior and tp.Fabric(*prior))
    want = jp.fit_link_model(points, prior=prior and jp.Fabric(*prior))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="no usable"):
        tp.fit_link_model([(0.0, 1.0)])


def test_fabric_json_round_trip_and_resolution(engines, tmp_path,
                                               monkeypatch, capsys):
    obj = {"schema": tp.FABRIC_SCHEMA, "version": tp.FABRIC_VERSION,
           "name": "measured-eth", "workers": 4,
           "fit": {"alpha_ms": 0.07, "gbps": 9.5}}
    path = tmp_path / "fabric.json"
    path.write_text(json.dumps(obj))
    t, j = tp.load_fabric(str(path)), jp.load_fabric(str(path))
    assert t == tp.Fabric(*j) and t.measured
    je, te = engines[5]
    assert (tp.plan_engine(te, fabric=str(path)).key()
            == jp.plan_engine(je, fabric=str(path)).key())
    # the resolution chain: DGC_FABRIC, then runs/fabric.json, then the
    # built-in
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DGC_FABRIC", raising=False)
    assert tp.resolve_fabric() == tp.BUILTIN_FABRICS["32x25GbE"]
    (tmp_path / "runs").mkdir()
    (tmp_path / "runs" / "fabric.json").write_text(json.dumps(obj))
    assert tp.resolve_fabric() == t
    monkeypatch.setenv("DGC_FABRIC", "ici_v5e8")
    assert tp.resolve_fabric() == tp.Fabric(*jp.resolve_fabric())
    assert "[fabric] env DGC_FABRIC='ici_v5e8'" in capsys.readouterr().out
    for bad in ({**obj, "schema": "x"}, {**obj, "version": 9}):
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError):
            tp.load_fabric(str(path))
    with pytest.raises(ValueError, match="unknown fabric"):
        tp.resolve_fabric("nowhere")


def _outcome(fn):
    """``("ok", value)`` or ``("raise", type, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:                  # noqa: BLE001 — compared below
        return ("raise", type(e), str(e))


def _same_outcome(tfn, jfn):
    """The port builds where the JAX package builds (the same plan) and
    raises where it raises, with its exception and message."""
    t, j = _outcome(tfn), _outcome(jfn)
    assert t[0] == j[0], (t, j)
    if t[0] == "raise":
        assert t[1:] == j[1:]
        return None
    _same_plan(t[1], j[1])
    assert t[1].gossip == j[1].gossip
    return t[1]


def test_gossip_is_refused(engines):
    """The gossip families and options where the JAX package plans them
    (gossip plans, the family post-pass, the schedule in the key) and
    where it refuses them (mixed families, gossip next to a plain sparse
    regime, hcube off a power-of-two world, a bound below the cadence, an
    unknown regime)."""
    je, te = engines[5]
    geoms = [tp.bucket_geometry(b) for b in te.buckets]
    fab = tp.BUILTIN_FABRICS["32x25GbE"]
    jfab = jp.BUILTIN_FABRICS["32x25GbE"]
    plan = _same_outcome(
        lambda: tp.plan_buckets(geoms, fabric="32x25GbE",
                                candidates=tp.REGIMES + tp.GOSSIP_REGIMES),
        lambda: jp.plan_buckets(geoms, fabric="32x25GbE",
                                candidates=jp.REGIMES + jp.GOSSIP_REGIMES))
    assert plan.candidates == tp.REGIMES + tp.GOSSIP_REGIMES
    for fam in tp.GOSSIP_REGIMES:
        plan = _same_outcome(
            lambda: tp.plan_engine(te, candidates=(fam,), world=4),
            lambda: jp.plan_engine(je, candidates=(fam,), world=4))
        assert plan.regimes == (fam,) * len(te.buckets)
        assert plan.verify_descriptor()["gossip"] == fam[len("gossip_"):]
        assert plan.key()[-1] == plan.gossip
        assert tuple(plan.replan(te).key()) == tuple(
            jp.Plan.replan(jp.plan_engine(je, candidates=(fam,), world=4),
                           je).key())
    plan = _same_outcome(
        lambda: tp.plan_engine(te, candidates=("gossip_ring",), world=8,
                               gossip_sync_every=2, gossip_max_staleness=5),
        lambda: jp.plan_engine(je, candidates=("gossip_ring",), world=8,
                               gossip_sync_every=2, gossip_max_staleness=5))
    assert plan.gossip == (("ring", 8, 2, 5))
    assert plan.replan(te).gossip == plan.gossip
    assert _same_outcome(lambda: tp.plan_engine(te, gossip_sync_every=4),
                         lambda: jp.plan_engine(je, gossip_sync_every=4)
                         ).gossip is None
    for regimes, world, kw in (
            (("gossip_hcube", "dense"), 4, {}),
            (("gossip_hcube",), 6, {}),
            (("gossip_ring", "fp32"), 4, {}),
            (("gossip_ring", "gossip_hcube"), 4, {}),
            (("gossip_ring",), 4, dict(gossip_sync_every=4,
                                       gossip_max_staleness=3)),
            (("gossip_ring",), 1, {}),
            (("int2",), 4, {})):
        _same_outcome(lambda: tp.Plan(regimes, fab, world, **kw),
                      lambda: jp.Plan(regimes, jfab, world, **kw))
    _same_outcome(
        lambda: tp.plan_buckets(geoms, fabric="32x25GbE", world=6,
                                candidates=("gossip_hcube",)),
        lambda: jp.plan_buckets(geoms, fabric="32x25GbE", world=6,
                                candidates=("gossip_hcube",)))
    assert tp.Plan(("fp16_packed",), tp.BUILTIN_FABRICS["32x25GbE"],
                   4).num_gathers == 2
