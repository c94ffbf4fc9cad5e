"""``dgc_tpu_torch.accuracy_parity`` against ``scripts/accuracy_parity.py``:
the task's formulas given the same draws (the JAX script's own
``jax.random`` draws, split as it splits its keys), and both arms for one
tiny epoch on the CPU, finite; the arms on the narrower wires and state
(``dgc_bf16mem``, ``dgc_int8``, ``dgc_int8nofb``, ``dgc_int8pack``) set as
the JAX script sets them, and one tiny epoch of each.

The prototypes agree within rtol 1e-5: the [C, d] x [d, 3072] product
sums in another order on each side (XLA's dot, ATen's), and ATen may
divide by the scalar sqrt(d) as a multiply by its reciprocal. The batch
is bitwise: one gather, one multiply and one add a pixel, and the same
label draws."""

import importlib.util
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from dgc_tpu_torch import accuracy_parity as ap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: these are many small CPU
    ops, no faster on several threads, and the files run beside other
    test workers, where several threads a worker oversubscribe the cores
    and slow every op by orders of magnitude. (A convolution's backward
    sums in another order at another thread count: each comparison here
    stays within one process, or sets one thread in its subprocesses.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_parity",
        os.path.join(REPO, "scripts", "accuracy_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("classes, d, scale", [(10, 24, 1.0), (100, 7, 0.5)])
def test_protos_match_jax(jax_script, classes, d, scale):
    key = jax.random.PRNGKey(1234)
    want = np.asarray(jax_script.make_protos(key, classes, d,
                                             proto_scale=scale))
    kz, km = jax.random.split(key)
    z = jax.random.normal(kz, (classes, d))
    m = jax.random.normal(km, (d, 32 * 32 * 3))
    got = ap.protos_from_draws(_t(z), _t(m), 32, scale).numpy()
    assert got.shape == want.shape == (classes, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * math.sqrt(d) * scale)


@pytest.mark.parametrize("label_noise", [0.0, 0.3])
def test_batch_matches_jax(jax_script, label_noise):
    protos = jax_script.make_protos(jax.random.PRNGKey(7), 10, 24)
    key = jax.random.PRNGKey(99)
    want_x, want_y = jax_script.sample_batch(protos, key, 64, 2.0, 10,
                                             label_noise)
    kl, kn, kf, kr = jax.random.split(key, 4)
    labels = jax.random.randint(kl, (64,), 0, 10)
    noise = jax.random.normal(kn, (64,) + protos.shape[1:])
    flip = relabels = None
    if label_noise > 0:
        flip = _t(jax.random.uniform(kf, (64,)) < label_noise)
        relabels = _t(jax.random.randint(kr, (64,), 0, 10))
    x, y = ap.batch_from_draws(_t(protos), _t(labels).long(), _t(noise), 2.0,
                               flip, relabels)
    np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                  np.asarray(want_x).view(np.uint32))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    if label_noise:
        assert (y.numpy() != np.asarray(labels)).any()


def test_sample_batch_draws_from_its_generator():
    protos = ap.make_protos(torch.Generator().manual_seed(0), 5, 4,
                            image_size=8)
    a = ap.sample_batch(protos, torch.Generator().manual_seed(3), 16, 1.0, 5,
                        0.5)
    b = ap.sample_batch(protos, torch.Generator().manual_seed(3), 16, 1.0, 5,
                        0.5)
    assert a[0].shape == (16, 8, 8, 3) and a[1].dtype == torch.int64
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_both_arms_run_a_tiny_epoch():
    res = ap.main(["--device", "cpu", "--arms", "dense,dgc", "--epochs", "1",
                   "--train-size", "32", "--batch", "16", "--workers", "2",
                   "--eval-size", "512", "--classes", "10"])
    for arm in ("dense", "dgc"):
        (epoch, loss, top1), = res[arm]["curve"]
        assert epoch == 0 and math.isfinite(loss) and 0 <= top1 <= 1
        assert res[arm]["final_top1"] == top1


@pytest.mark.parametrize("arm", ["sparse", "dgc_twotier", "dgc_fp8"])
def test_unported_arms_are_refused(arm):
    with pytest.raises(SystemExit, match="unknown arm"):
        ap.main(["--device", "cpu", "--arms", f"dense,{arm}"])


def test_wire_arms_run_a_tiny_epoch():
    """The JAX script's arms on the narrower wires and state (set as it
    sets them) train on the CPU at a small size."""
    arms = ["dgc", "dgc_bf16mem", "dgc_int8", "dgc_int8nofb", "dgc_int8pack"]
    res = ap.main(["--device", "cpu", "--arms", ",".join(arms), "--epochs",
                   "1", "--train-size", "32", "--batch", "16", "--workers",
                   "2", "--eval-size", "512", "--classes", "10"])
    for arm in arms:
        (epoch, loss, top1), = res[arm]["curve"]
        assert epoch == 0 and math.isfinite(loss) and 0 <= top1 <= 1


@pytest.mark.parametrize("arm,want", [
    ("dgc_bf16mem", dict(dtype=torch.bfloat16, int8_values=False)),
    ("dgc_int8", dict(int8_values=True, int8_error_feedback=True,
                      packed_indices=False)),
    ("dgc_int8nofb", dict(int8_values=True, int8_error_feedback=False)),
    ("dgc_int8pack", dict(int8_values=True, int8_error_feedback=True,
                          packed_indices=True))])
def test_wire_arms_are_set_as_the_jax_script_sets_them(arm, want):
    model = ap.create("resnet20", 10, torch.Generator().manual_seed(0))
    args = types.SimpleNamespace(ratio=0.001, warmup_epochs=5)
    comp, _ = ap._arm(arm, model, lambda s: 0.1, 2, args)
    for k, v in want.items():
        got = comp.memory.dtype if k == "dtype" else getattr(comp, k)
        assert got == v, k


def _reference_telemetry_fields():
    """The keys of the JAX script's ``--telemetry-out`` header (``static``)
    and of its ``parity_arm`` records, read from its source."""
    import ast
    with open(os.path.join(REPO, "scripts", "accuracy_parity.py")) as f:
        tree = ast.parse(f.read())
    static = record = None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "id", getattr(node.func, "attr", None))
        if name == "TelemetrySink":
            (kw,) = [k for k in node.keywords if k.arg == "static"]
            static = [k.value for k in kw.value.keys]
        elif name == "write_record":
            record = [k.value for k in node.args[0].keys]
    return static, record


def test_telemetry_out_writes_the_reference_records(tmp_path):
    from dgc_tpu.telemetry import sink as jsink
    out = str(tmp_path / "parity.jsonl")
    res = ap.main(["--device", "cpu", "--arms", "dense,dgc", "--epochs", "1",
                   "--train-size", "32", "--batch", "16", "--workers", "2",
                   "--eval-size", "512", "--classes", "10", "--seeds", "2",
                   "--telemetry-out", out])
    static, fields = _reference_telemetry_fields()
    header, recs = jsink.read_run(out)
    assert sorted(header["static"]) == sorted(static)
    assert header["static"] == {
        "experiment": "accuracy_parity", "ratio": 0.001, "workers": 2,
        "epochs": 1, "arms": ["dense", "dgc"], "seeds": [0, 1]}
    assert [(r["arm"], r["seed"]) for r in recs] == [
        ("dense", 0), ("dense", 1), ("dgc", 0), ("dgc", 1)]
    for r in recs:
        assert set(r) == set(fields) | {"t_host"}
        assert r["event"] == "parity_arm"
        run = res[r["arm"]]["seeds"][str(r["seed"])]
        for k in ("final_top1", "mean_last3_top1", "wall_s"):
            assert r[k] == run[k], k
