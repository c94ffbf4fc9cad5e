"""The port's serving stream (``dgc_tpu_torch.serving``) against the JAX
package's (``dgc_tpu.serving``) on the CPU, on the same numpy inputs made
from seeds, at the toy mixed shapes of ``tests/serving_worker.py``
(matrix, vector, scalar) and at ResNet-20's flax parameters; every
comparison is bitwise.

* The spec: ``meta()``, ``key()``, the layout, the buckets and
  ``describe()`` are the reference's (ResNet-20: 925 B an update against
  1,089,896; ResNet-50's shapes: 52,085 against 102,228,128), and
  ``from_meta`` refuses what the reference refuses.
* The wire: flatten / unflatten; encode's ``scales``, ``values`` and
  ``words`` on deltas of distinct magnitudes and at exact .5 quotients
  (``torch.round`` and ``np.rint`` both round half to even); decode;
  apply; the digests.
* The apply at repeated coordinates (a corrupt index word clamped into its
  row onto a non-zero value, random bit flips of the words, -0.0 in the
  state): ``np.add.at``'s result, through :func:`serving.delta.add_at`.
* The deliberate divergence at ties: the port keeps the lower columns of
  equal magnitudes at a row's cut (a stable argsort's choice); the
  reference's ``np.argpartition`` picks some of them, whose values, as a
  set, are the port's.
* Error feedback on a static target, as ``tests/test_serving.py`` checks.
* Cross-package streams: the JAX ``Replica`` follows a port ``Exporter``'s
  directory to the exporter's digests, and the port's ``Replica`` a JAX
  ``Exporter``'s, through a dropped delta, the gap, the resync request and
  the rebase; the replicas' status files read alike by both packages'
  ``telemetry.fleet.serving_summary``.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.serving import DeltaSpec as JSpec
from dgc_tpu.serving import Exporter as JExporter
from dgc_tpu.serving import Replica as JReplica
from dgc_tpu.serving import protocol as jprotocol
from dgc_tpu.telemetry import fleet as jfleet
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.serving import DeltaSpec, Exporter, Replica, protocol
from dgc_tpu_torch.serving.delta import add_at
from dgc_tpu_torch.telemetry import fleet, registry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from serving_worker import make_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _resnet20_params():
    from dgc_tpu.models import resnet20
    v = resnet20(num_classes=10).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(v["params"]))


def _params(model, step=0):
    """``(numpy params for the reference, the same as {flax name: tensor}
    for the port)``."""
    if model == "toy":
        p = make_params(step)
    else:
        base = _resnet20_params()
        rng = np.random.RandomState(100 + step)
        p = jax.tree_util.tree_map(
            lambda a: (a + 0.01 * rng.randn(*a.shape)).astype(np.float32)
            if step else a, base)
    named = jax_named_flatten(p)[0]
    return p, {n: torch.from_numpy(np.array(a, np.float32))
               for n, a in named.items()}


def _specs(model, ratio):
    p, t = _params(model)
    return JSpec.from_params(p, ratio), DeltaSpec.from_params(
        t, ratio, device="cpu")


def _distinct_delta(total, seed):
    """A flat delta whose magnitudes are all distinct (a permutation of a
    grid), random signs: the top-k has no tie to break."""
    rng = np.random.RandomState(seed)
    mag = (rng.permutation(total).astype(np.float32) + 1.0) / total
    return (mag * rng.choice([-1.0, 1.0], total)).astype(np.float32)


def _wire(spec, delta):
    return spec.to_arrays(spec.encode(torch.from_numpy(delta)))


# --------------------------------------------------------------------- #
# the spec                                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("model,ratio", [("toy", 0.05), ("toy", 1.0),
                                         ("resnet20", 0.001)])
def test_spec_matches_reference(model, ratio):
    js, ts = _specs(model, ratio)
    assert ts.meta() == js.meta() and ts.key() == js.key()
    assert ts.describe() == js.describe()
    assert ts.layout.offsets == js.layout.offsets
    assert ts.layout.total == js.layout.total
    assert (ts.payload, ts.num_rows) == (js.payload, js.num_rows)
    assert ts.codec.nwords == js.codec.nwords
    for a, b in zip(ts.buckets, js.buckets):
        assert (a.base, a.rows, a.cols, a.max_sel) == (b.base, b.rows, b.cols,
                                                       b.max_sel)
        np.testing.assert_array_equal(a.num_selects, b.num_selects)
        np.testing.assert_array_equal(a.tight, b.tight)
    again = DeltaSpec.from_meta(js.meta(), device="cpu")
    assert again.key() == js.key() and again.describe() == js.describe()
    if model == "resnet20":
        assert ts.wire_bytes_per_update() == 925
        assert ts.full_checkpoint_bytes() == 1_089_896


def test_spec_at_resnet50_shapes_matches_reference():
    from dgc_tpu.models import resnet50
    shapes = jax.eval_shape(lambda: resnet50(num_classes=1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    named = {n: tuple(a.shape)
             for n, a in jax_named_flatten(shapes["params"])[0].items()}
    ts = DeltaSpec(named, 0.001, device="cpu")
    js = JSpec(named, 0.001)
    assert ts.describe() == js.describe() and ts.key() == js.key()
    assert ts.wire_bytes_per_update() == 52_085
    assert ts.full_checkpoint_bytes() == 102_228_128
    assert ts.layout.total == 27_287_552 and len(ts.buckets) == 8


def _bad_metas():
    good = JSpec.from_params(make_params(0), 0.05).meta()
    yield "format", dict(good, format="other")
    yield "version", dict(good, format_version=2)
    yield "key", dict(good, key="0" * 16)
    yield "ratio0", dict(good, ratio=0.0, key=None)
    yield "ratio2", dict(good, ratio=1.5, key=None)
    yield "empty", dict(good, shapes={}, key=None)
    yield "huge", dict(good, shapes={"w": [1 << 16, 1 << 15]}, key=None)


@pytest.mark.parametrize("case", [c for c, _ in _bad_metas()])
def test_from_meta_refuses_what_the_reference_refuses(case):
    meta = dict(_bad_metas())[case]
    with pytest.raises(ValueError):
        JSpec.from_meta(meta)
    with pytest.raises(ValueError):
        DeltaSpec.from_meta(meta, device="cpu")


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t = _params("toy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeltaSpec.from_params(t, 0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Exporter(str(tmp_path / "s"), t, ratio=0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Replica(str(tmp_path / "s"))


# --------------------------------------------------------------------- #
# the wire                                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("model", ["toy", "resnet20"])
def test_flatten_unflatten_match_reference(model):
    js, ts = _specs(model, 0.05)
    p, t = _params(model, 1)
    flat = ts.flatten(t)
    np.testing.assert_array_equal(flat.numpy(), js.flatten(p))
    # nested (flax-shaped) and flat {name: tensor} maps flatten alike
    from dgc_tpu_torch.utils.pytree import nest
    assert torch.equal(ts.flatten(nest(t)), flat)
    back = ts.unflatten(flat)
    assert list(back) == list(js.unflatten(js.flatten(p)))
    for n, a in back.items():
        assert torch.equal(a, t[n].reshape(a.shape))
    with pytest.raises(ValueError, match="do not match"):
        ts.flatten(dict(t, extra=torch.zeros(3)))


@pytest.mark.parametrize("model,ratio,seed", [
    ("toy", 0.05, 0), ("toy", 0.3, 1), ("resnet20", 0.001, 2),
    ("resnet20", 0.01, 3)])
def test_encode_decode_apply_digest_match_reference(model, ratio, seed):
    js, ts = _specs(model, ratio)
    p, t = _params(model, 1)
    base = js.flatten(p)
    delta = _distinct_delta(js.layout.total, seed)
    want = js.encode(delta)
    got = _wire(ts, delta)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jv, ji = js.decode(want)
    tv, ti = ts.decode(got)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    out_j = js.apply(base, want)
    out_t = ts.apply(ts.flatten(t), got)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    assert DeltaSpec.digest(out_t) == JSpec.digest(out_j)
    # the port's apply also takes the artifact's tensors
    assert torch.equal(ts.apply(ts.flatten(t), ts.encode(
        torch.from_numpy(delta))), out_t)


def test_quantization_rounds_half_to_even_as_the_reference():
    """Every slot selected (ratio 1): each row's largest |v| is 7, so its
    scale is 1 and ``v / scale`` lands on exact .5 quotients."""
    js, ts = _specs("toy", 1.0)
    rng = np.random.RandomState(9)
    halves = np.array([0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, -0.5, -1.5, -2.5,
                       -3.5, -4.5, -5.5, -6.5, 0.0, -0.0], np.float32)
    delta = np.zeros(js.layout.total, np.float32)
    for n in js.shapes:
        off, size = js.layout.offsets[n], js.layout.sizes[n]
        row = rng.choice(halves, size).astype(np.float32)
        row[rng.randint(size)] = 7.0
        delta[off:off + size] = row
    want, got = js.encode(delta), _wire(ts, delta)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    q = ts.decode(got)[0].numpy()
    assert set(np.unique(np.abs(q))) <= {0.0, 2.0, 4.0, 6.0, 7.0}


def _duplicate_artifact(js, seed):
    """An artifact of the reference whose decoded stream repeats a
    coordinate that carries non-zero values: the pad-free slot s of a row
    re-encoded onto slot s - 1's coordinate (the words of a corrupt index
    the receiver clamps in-row)."""
    art = js.encode(_distinct_delta(js.layout.total, seed))
    values, idx = js.decode(art)
    q_nonzero = values != 0
    s = next(i for i in range(1, js.payload)
             if q_nonzero[i] and q_nonzero[i - 1]
             and js._slot_off[i] == js._slot_off[i - 1])
    idx = idx.copy()
    idx[s] = idx[s - 1]
    words = np.asarray(js.codec.encode(idx.astype(np.int32)))
    return dict(art, words=words)


@pytest.mark.parametrize("model", ["toy", "resnet20"])
def test_apply_at_repeated_coordinates_is_np_add_at(model):
    js, ts = _specs(model, 0.05)
    p, t = _params(model, 1)
    base = js.flatten(p)
    # -0.0 in the state: only a +0.0 add may turn it into +0.0
    base[:: 7] = -0.0
    art = _duplicate_artifact(js, 5)
    _, ji = js.decode(art)
    assert len(np.unique(ji)) < len(ji)
    np.testing.assert_array_equal(
        ts.apply(torch.from_numpy(base), art).numpy(), js.apply(base, art))
    # corrupt words: random bit flips, clamped into their rows by both
    rng = np.random.RandomState(6)
    for _ in range(4):
        bad = dict(art, words=art["words"].copy())
        for w in rng.randint(0, len(bad["words"]), 3):
            bad["words"][w] ^= np.uint32(1 << rng.randint(32))
        jv, ji = js.decode(bad)
        tv, ti = ts.decode(bad)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(
            ts.apply(torch.from_numpy(base), bad).numpy(),
            js.apply(base, bad))


def test_add_at_is_np_add_at_with_repeats_and_signed_zeros():
    rng = np.random.RandomState(11)
    n = 64
    for trial in range(20):
        out = rng.randn(n).astype(np.float32)
        out[rng.rand(n) < 0.3] = -0.0
        out[rng.rand(n) < 0.1] = 0.0
        m = 300
        idx = rng.randint(0, n // (1 + trial % 4), m)
        vals = (rng.randn(m) * 10.0 ** rng.randint(-8, 8, m)).astype(
            np.float32)
        vals[rng.rand(m) < 0.3] = 0.0
        vals[rng.rand(m) < 0.2] = -0.0
        want = out.copy()
        np.add.at(want, idx, vals)
        got = add_at(torch.from_numpy(out.copy()), torch.from_numpy(idx),
                     torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_ties_keep_the_lower_columns():
    """Planted equal magnitudes straddling each row's cut: the port keeps
    a stable argsort's choice (the lower columns); the reference keeps
    some of them, the same values as a set."""
    js, ts = _specs("toy", 0.05)
    rng = np.random.RandomState(12)
    delta = np.zeros(js.layout.total, np.float32)
    want_idx = []
    for b in js.buckets:
        for r in range(b.rows):
            off, numel = int(b.row_offsets[r]), int(b.numels[r])
            k = int(b.num_selects[r])
            row = (rng.rand(numel) * 0.5).astype(np.float32)
            if numel >= k + 3:
                # k - 1 clear winners, then 4 equal magnitudes for the
                # last slot
                top = rng.choice(numel, k - 1 + 4, replace=False)
                row[top[:k - 1]] = 2.0 + np.arange(k - 1, dtype=np.float32)
                row[top[k - 1:]] = 1.0
            delta[off:off + numel] = row
            order = np.argsort(-np.abs(row), kind="stable")[:k]
            want_idx.append(off + np.sort(order))
    tv, ti = ts.decode(_wire(ts, delta))
    jv, ji = js.decode(js.encode(delta))
    assert ts.payload == sum(len(i) for i in want_idx)
    np.testing.assert_array_equal(ti.numpy(), np.concatenate(want_idx))
    np.testing.assert_array_equal(np.sort(tv.numpy()), np.sort(jv))


def test_error_feedback_converges_on_static_target():
    _, ts = _specs("toy", 0.05)
    _, t0 = _params("toy")
    rng = np.random.RandomState(5)
    target = ts.flatten({n: v + torch.from_numpy(
        np.asarray(rng.randn(*v.shape) * 0.1, np.float32))
        for n, v in t0.items()})
    published = ts.flatten(t0)
    errs = []
    for _ in range(60):
        published = ts.apply(published, ts.encode(target - published))
        errs.append(float((target - published).abs().max()))
    assert errs[-1] < errs[0] * 0.05, errs[::8]


# --------------------------------------------------------------------- #
# cross-package streams                                                  #
# --------------------------------------------------------------------- #

def _walk(step, model):
    p, t = _params(model, step)
    return p, t


@pytest.mark.parametrize("model", ["toy", "resnet20"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_streams_cross_packages_through_a_gap(tmp_path, monkeypatch, model,
                                              writer):
    """One package's exporter, the other's replica (and one of its own),
    auto resync on: five deltas (the fourth dropped, so the replicas
    report the gap and request a resync), the rebase to base 2, one more
    delta; every replica's digest is the exporter's at every head."""
    monkeypatch.delenv("DGC_SERVE_DROP", raising=False)
    d = str(tmp_path / "serving")
    ratio = 0.05 if model == "toy" else 0.001
    p0, t0 = _walk(0, model)
    if writer == "port":
        exp = Exporter(d, t0, ratio=ratio, max_lag=8,
                       lineage={"epoch": 0, "step": 0}, device="cpu")
    else:
        exp = JExporter(d, p0, ratio=ratio, max_lag=8,
                        lineage={"epoch": 0, "step": 0})
    reps = [JReplica(d, name="jax0"), Replica(d, name="port0", device="cpu")]
    man = protocol.read_manifest(d)
    assert man == jprotocol.read_manifest(d)
    for r in reps:
        st = r.poll()
        registry.validate_replica_status(st)
        assert st["health"] == "ok" and r.digest() == exp.digests["1:0"]
    seen_gap = False
    for step in range(1, 8):
        p, t = _walk(step, model)
        if step == 4:
            monkeypatch.setenv("DGC_SERVE_DROP", "1:4")
        rec = exp.publish(t if writer == "port" else p, step=step)
        monkeypatch.delenv("DGC_SERVE_DROP", raising=False)
        sts = [r.poll() for r in reps]
        for r, st in zip(reps, sts):
            registry.validate_replica_status(st)
            if rec.get("dropped"):
                assert st["health"] == "gap" and r.gaps == 1
                seen_gap = True
            else:
                assert st["health"] == "ok", st
                key = f"{rec['base_version']}:{rec['delta_seq']}"
                assert r.digest() == exp.digests[key] == rec.get(
                    "digest", exp.digests[key])
        if step == 5:
            assert rec["kind"] == "base" and rec["base_version"] == 2
            assert rec["request"]["reason"] == "gap at 1:4"
    assert seen_gap
    assert exp.base_version == 2 and exp.delta_seq == 2
    for r in reps:
        assert r.resyncs == 1 and r.base_version == 2 and r.delta_seq == 2
    got = reps[1].params()
    want = reps[0].params()
    assert list(got) == list(want)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), want[n])
    # the status files both replicas publish, read by both fleet readers
    for r in reps:
        r.write_status(d, exp.delta_seq, 8)
    summ = fleet.serving_summary(fleet.discover_serving(str(tmp_path)))
    assert summ == jfleet.serving_summary(d)
    assert sorted(summ["replicas"]) == ["jax0", "port0"]
    assert summ["bad_status"] == 0
    assert (summ["head"]["base_version"], summ["head"]["latest_seq"]) == (2, 2)
