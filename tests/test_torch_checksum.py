"""The flat engine's payload checksum and fault hooks against the JAX engine
at W=8 (test_resilience.py's ``bitflip`` / ``badidx`` / clean-run
oracles).

The JAX exchange runs op by op under ``jax.vmap``, its all-gathers read as
test_torch_wires.py reads them, with a ``health_out`` dict; the port's
engine is built with the same ``DGC_FAULTS`` armed (it reads the plan
once, when built). The sender's checksum words on the index lane (plain
offsets, or after the codec words on the word lane) are bitwise the JAX
words; the mismatch count is the JAX count; the exchanged gradient, the
memory and the transmit record are bitwise the JAX engine's, corrupted
value and clamped index included (coordinates that several workers sent
within f32 rounding, rtol 1e-6, as in test_torch_engine.py)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.resilience import faults as jfaults
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.parallel.comm import LocalComm

W = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    rng = np.random.RandomState(0)
    return {"conv1": {"kernel": rng.randn(3, 3, 16, 32).astype(np.float32)},
            "conv2": {"kernel": rng.randn(3, 3, 32, 32).astype(np.float32)},
            "dense": {"kernel": rng.randn(64, 10).astype(np.float32),
                      "bias": rng.randn(10).astype(np.float32)}}


def _engines(monkeypatch, spec, regime="fp32", dtype=None, jkw=None, **kw):
    if spec:
        monkeypatch.setenv(jfaults.ENV, spec)
    else:
        monkeypatch.delenv(jfaults.ENV, raising=False)
    params = _params()
    named = {"conv1/kernel": params["conv1"]["kernel"],
             "conv2/kernel": params["conv2"]["kernel"],
             "dense/kernel": params["dense"]["kernel"]}
    jc = DGCCompressor(0.05, memory=DGCSGDMemory(momentum=0.9, dtype=dtype),
                       sample_ratio=1.0, checksum=True, **(jkw or {}), **kw)
    tc = tdgc.DGCCompressor(0.05, memory=TMemory(momentum=0.9, dtype=dtype),
                            sample_ratio=1.0, checksum=True, **kw)
    jc.initialize(named.items())
    tc.initialize((n, p.shape) for n, p in named.items())
    plan = None if regime is None else (regime,) * len(
        FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc)).buckets)
    je = FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc), plan=plan)
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(params, tc),
                             plan=plan)
    return je, te


def _jax_step(engine):
    orig = jax.lax.all_gather

    def worker(fg, mem, key):
        rec, health = [], {}

        def spy(x, axis_name, **kw):
            y = orig(x, axis_name, **kw)
            rec.append(y)
            return y
        with mock.patch.object(jax.lax, "all_gather", spy):
            out, mem = engine.exchange(fg, mem, key, "data", W,
                                       health_out=health)
        return out, mem, health["checksum_failures"], tuple(rec)
    return jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view({2: np.int16, 4: np.int32}[a.itemsize])
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _run(je, te, steps=2, seed=0):
    P = te.layout.total
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(seed)
    counts = []
    for step in range(steps):
        g = rng.randn(W, P).astype(np.float32)
        jout, jmem, jchk, jlanes = _jax_step(je)(
            jnp.asarray(g), jmem, jax.random.PRNGKey(step))
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        ph = te.draw_phases(torch.Generator())
        sent = [te.compress(torch.from_numpy(g[w]), pre[w], ph)
                for w in range(W)]
        lanes = [te.encode(v, i, pre[w], checksum=True)[0]
                 for w, (v, i) in enumerate(sent)]
        health = {}
        touts = te.exchange([torch.from_numpy(x) for x in g], tmems,
                            [te.draw_phases(torch.Generator())] * W,
                            LocalComm(W), health=health)
        jc = np.asarray(jchk)
        assert (jc == jc[0]).all()
        assert health["checksum_failures"].dtype == torch.float32
        assert float(health["checksum_failures"]) == float(jc[0])
        counts.append(float(jc[0]))
        # the lanes in the JAX gather order, checksum words included
        names = [n for n in ("f32", "f16", "words", "idx") if n in lanes[0]]
        assert len(jlanes) == len(names)
        for name, gl in zip(names, jlanes):
            mine = torch.stack([ln[name] for ln in lanes])
            if mine.dtype == torch.bfloat16:
                mine = mine.view(torch.int16)
            np.testing.assert_array_equal(_bits(mine.numpy()),
                                          _bits(gl[0]), err_msg=name)
        idx = np.stack([s[1].numpy() for s in sent]).reshape(-1)
        real = idx[idx != te.layout.sentinel]
        u, c = np.unique(real, return_counts=True)
        dup = np.zeros(P, bool)
        dup[u[c > 1]] = True
        jo = np.asarray(jout)
        for w in range(W):
            got = touts[w].numpy()
            np.testing.assert_array_equal(_bits(got[~dup]),
                                          _bits(jo[w][~dup]))
            np.testing.assert_allclose(got[dup], jo[w][dup], rtol=1e-6)
            for k, t in tmems[w].items():
                j = np.asarray(jmem[k][w])
                if t.is_floating_point():      # bf16 state: compare as f32
                    t, j = t.float(), j.astype(np.float32)
                np.testing.assert_array_equal(_bits(t.numpy()), _bits(j),
                                              err_msg=k)
    return counts


@pytest.mark.parametrize("regime", ["fp32", "fp16", "fp32_packed",
                                    "fp16_packed"])
def test_clean_exchange_counts_zero_with_the_jax_words(monkeypatch, regime):
    je, te = _engines(monkeypatch, "", regime)
    assert te.checksum and je.checksum
    assert _run(je, te) == [0.0, 0.0]


def test_bf16_state_checksum_matches_jax(monkeypatch):
    """The bf16 error-feedback state ships its native lane in bf16, whose
    words the reference converts by value: the same words here. (The JAX
    engine selects exactly, ``approx_recall=None``: its CPU approx_max_k
    orders equal bf16 magnitudes its own way, ROADMAP.md §3.)"""
    je, te = _engines(monkeypatch, "", "fp32", dtype="bfloat16",
                      jkw=dict(approx_recall=None))
    assert _run(je, te, steps=1) == [0.0]


@pytest.mark.parametrize("regime", ["fp32", "fp16_packed"])
def test_bitflip_is_counted_as_jax_counts_it(monkeypatch, regime):
    """``bitflip:elem=0:bit=18`` after the gather: one bucket row of worker
    0 disagrees with its words, on every receiver, every step; the flipped
    value reaches the apply, as in the reference."""
    je, te = _engines(monkeypatch, "bitflip:elem=0:bit=18", regime)
    assert _run(je, te) == [1.0, 1.0]


@pytest.mark.parametrize("spec", ["badidx:elem=0:set=-5",
                                  "badidx:elem=3:set=100000000",
                                  "badidx:elem=11"])
@pytest.mark.parametrize("regime", ["fp32", "fp32_packed"])
def test_bad_index_clamped_to_the_sentinel(monkeypatch, spec, regime):
    """A negative or out-of-range gathered index goes to the sentinel (the
    apply adds nothing to a live coordinate), the checksum counts it, and
    the results are the JAX engine's."""
    je, te = _engines(monkeypatch, spec, regime)
    counts = _run(je, te)
    assert counts[0] == 1.0 and counts == [1.0, 1.0]


def test_checksum_refusals_match_jax(monkeypatch):
    """As the reference: the int8 and int4 wires' scales would ride
    uncovered, and a plan must keep one sparse wire format."""
    for kw, regime in ((dict(int8_values=True), None),
                       ({}, "int4_packed")):
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError, match="checksum=True"):
                if pkg == "jax":
                    monkeypatch.delenv(jfaults.ENV, raising=False)
                    params = _params()
                    c = DGCCompressor(0.05, checksum=True, **kw)
                    c.initialize([("conv2/kernel",
                                   params["conv2"]["kernel"])])
                    lay = ParamLayout.for_compressor(params, c)
                    FlatDGCEngine(c, lay, plan=None if regime is None
                                  else (regime,))
                else:
                    _engines(monkeypatch, "", regime, **kw)
    # two buckets
    p = {"a": np.zeros((512, 1024), np.float32),
         "b": np.zeros((16, 16), np.float32)}
    c = tdgc.DGCCompressor(0.05, sample_ratio=1.0, checksum=True)
    c.initialize((k, v.shape) for k, v in p.items())
    lay = tflat.ParamLayout.for_compressor(p, c)
    with pytest.raises(ValueError, match="one wire format"):
        tflat.FlatDGCEngine(c, lay, plan=("fp32", "fp16"))
    # a dense-planned bucket beside one sparse regime is one format
    assert tflat.FlatDGCEngine(c, lay, plan=("dense", "fp16")).checksum


def test_checksum_needs_guards_and_stays_off_the_per_tensor_path():
    """The mismatch count travels in the guard metrics, so the flat step
    refuses the checksum without guards (the reference's refusal); the
    per-tensor exchange refuses it outright."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.optim.distributed import DistributedOptimizer
    from dgc_tpu_torch.optim.sgd import dgc_sgd
    from dgc_tpu_torch.train import Trainer
    cfg = configs.resnet20_wm5_resilience()
    cfg.dataset.synthetic_size = 32
    cfg.train.batch_size = 4
    t = Trainer(cfg, LocalComm(2), "cpu")
    t.guards = None
    with pytest.raises(ValueError, match="guards"):
        t.run_epoch(5, 1)
    d = DistributedOptimizer(dgc_sgd(0.1), t.compression, LocalComm(2))
    with pytest.raises(ValueError, match="per-tensor"):
        d.exchange([{}, {}], [{}, {}], [{}, {}])
