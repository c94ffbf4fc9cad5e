"""The non-resample adaptation and the uniform sampler against the JAX
package.

* ``_batched_adapt`` (the flat engine's batched threshold adaptation,
  each round's count on the ladder-counts kernel's plain version at one
  level) against the JAX ``_batched_adapt`` on planted rows that need
  raising, lowering and neither, with rows that run out of rounds and a
  row that does not adapt, at budgets of 10, 5, 3 and 1 rounds:
  thresholds bitwise against JAX's ``resample=False`` mode, the only one
  the port adapts through it.
* The uniform sampler given the JAX-drawn values: the per-tensor
  ``uniform_sample`` (positions from ``jax.random.randint``), the per-tensor
  compressor's selection with ``strided_sample=False, resample=False``,
  and the engine's ``_sample_rows`` (uniforms from
  ``jax.random.uniform``): bitwise.
* The flat engine's exchange with ``resample=False, strided_sample=False``
  at W=2 against the JAX engine run op by op (``jax.vmap``): payloads,
  memory and transmit records bitwise, and the exchanged gradients too
  (at W=2 a coordinate both workers sent is one IEEE add either way).
* The ladder kernel's plan at one level does not split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression import flat as jflat
from dgc_tpu.models import resnet20
from dgc_tpu.ops import sparsify as jops
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.models import create, param_tree
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.ops import sparsify as tops
from dgc_tpu_torch.parallel.comm import LocalComm

W = 2
FLAGS = dict(strided_sample=False, resample=False)


@pytest.fixture(scope="module")
def params():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v["params"])


def _bits(a):
    return np.asarray(a).view(np.int32)


def _planted_rows():
    """Eight rows of 4,096 importances (row tails -1) with thresholds and
    quotas that need: a lower (0-2), a raise (3-4), nothing (5), more
    rounds than the budget (6: lower, 7: raise)."""
    rng = np.random.RandomState(2)
    R, cols = 8, 4096
    imp = np.abs(rng.randn(R, cols)).astype(np.float32)
    imp[:, 4000:] = -1.0
    imp[2, :4000] *= 0.1
    imp[2, :100] = 0.5                       # ties near a ladder level
    qs = np.quantile(imp[:, :4000], [0.999, 0.95, 0.99, 0.3, 0.5, 0.98,
                                     1.0, 0.0], axis=1)
    thr = np.array([qs[i, i] for i in range(R)], np.float32)
    thr[2] = 0.5 / 0.8 ** 3
    thr[6] = 1e3                             # ten lowerings are too few
    thr[7] = 1e-6                            # ten raises are too few
    num_selects = np.array([40, 40, 40, 30, 30, 80, 40, 40], np.float32)
    adapt = np.array([1, 1, 1, 1, 1, 1, 1, 1], bool)
    return imp, thr, num_selects, adapt


@pytest.mark.parametrize("max_iters", [10, 5, 3, 1])
def test_batched_adapt_matches_jax(max_iters):
    imp, thr, ns, adapt = _planted_rows()
    adapt[5] = False
    lower, upper = 0.8, 1.3
    want = jflat._batched_adapt(jnp.asarray(imp), jnp.asarray(thr),
                                jnp.asarray(ns), jnp.asarray(adapt), lower,
                                upper, max_iters, False)
    lo = torch.from_numpy(np.float32(lower) * ns)
    hi = torch.from_numpy(np.float32(upper) * ns)
    got = tflat._batched_adapt(torch.from_numpy(imp), torch.from_numpy(thr),
                               lo, hi, torch.from_numpy(adapt), lower, upper,
                               max_iters)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    moved = got.numpy() != thr
    assert moved[[0, 2, 6]].all() and not moved[5]
    assert moved[[3, 4, 7]].all()


def test_uniform_sample_matches_jax():
    rng = np.random.RandomState(4)
    imp = np.abs(rng.randn(50_000)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jops.uniform_sample(jnp.asarray(imp), 600, key)
    pos = jax.random.randint(key, (600,), 0, imp.shape[0], dtype=jnp.int32)
    got = tops.uniform_sample(torch.from_numpy(imp),
                              torch.from_numpy(np.array(pos)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tops.draw_positions(torch.Generator().manual_seed(1), 600,
                                imp.shape[0])
    assert drawn.shape == (600,) and 0 <= int(drawn.min())
    assert int(drawn.max()) < imp.shape[0]


def _compressors(params, epoch, **flags):
    kw = dict(sample_ratio=0.01, warmup_epochs=5, **flags)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return jc, tc


@pytest.mark.parametrize("epoch", [0, 5])
def test_per_tensor_uniform_selection_matches_jax(params, epoch):
    jc, tc = _compressors(params, epoch, **FLAGS)
    rng = np.random.RandomState(epoch)
    sampled = 0
    # every third tensor: each shape of ResNet-20's, sampled or whole
    for i, (name, a) in enumerate(list(tc.attributes.items())[::3]):
        g = rng.randn(*a.shape).astype(np.float32)
        key = jax.random.PRNGKey(i)
        jv, ji, jvalid = jc.sparsify(jnp.asarray(g), name, key)
        pos = 0
        if a.numel > a.num_samples:
            sampled += 1
            pos = torch.from_numpy(np.array(jax.random.randint(
                key, (a.num_samples,), 0, a.numel, dtype=jnp.int32)))
        tv, ti, tvalid = tc.sparsify(torch.from_numpy(g), name, pos)
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert sampled >= 1
    drawn = tc.draw_phases(torch.Generator().manual_seed(0))
    assert all(drawn[n].shape == (a.num_samples,)
               for n, a in tc.attributes.items() if a.numel > a.num_samples)


def _engines(params, epoch):
    jc, tc = _compressors(params, epoch, **FLAGS)
    je = jflat.FlatDGCEngine(jc, jflat.ParamLayout.for_compressor(params, jc))
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(params,
                                                                  tc))
    assert not any(te._seg) and not te._seg_fused
    return je, te


def _uniforms(je, key):
    """The uniforms the JAX engine's ``_sample_rows`` draws from ``key``
    for each sampled bucket (``fold_in(key, bucket)``)."""
    return [[] if b.exact else torch.from_numpy(np.asarray(
        jax.random.uniform(jax.random.fold_in(key, bi), (b.rows, b.max_s))))
        for bi, b in enumerate(je.buckets)]


def test_sample_rows_uniform_matches_jax(params):
    je, te = _engines(params, 5)
    rng = np.random.RandomState(1)
    key = jax.random.PRNGKey(3)
    consts = te._bucket_consts(torch.device("cpu"))
    checked = 0
    for bi, b in enumerate(te.buckets):
        if b.exact:
            continue
        imp = np.abs(rng.randn(b.rows, b.cols)).astype(np.float32)
        imp[np.arange(b.cols)[None, :] >= b.numels[:, None]] = -1.0
        kb = jax.random.fold_in(key, bi)
        want = je._sample_rows(je.buckets[bi], jnp.asarray(imp), kb)
        u = torch.from_numpy(np.asarray(jax.random.uniform(
            kb, (b.rows, b.max_s))))
        got = te._sample_rows(b, consts[bi], torch.from_numpy(imp), u)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        checked += 1
    assert checked
    drawn = te.draw_phases(torch.Generator().manual_seed(0))
    assert [tuple(d.shape) if torch.is_tensor(d) else d for d in drawn] == [
        [] if b.exact else (b.rows, b.max_s) for b in te.buckets]


@pytest.mark.parametrize("epoch", [0, 5])
def test_exchange_nonresample_uniform_matches_jax(params, epoch):
    je, te = _engines(params, epoch)
    T, P_, S = te.T, te.layout.total, te.layout.sentinel

    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        _, mc, vc, _ = je._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg, mem["sent_bits"])
        vals, idx = je.sparsify(vc, key)
        out, mem = je.exchange(fg, mem, key, "data", W)
        return out, mem, vals, idx
    # op by op: no jax.jit (see test_torch_engine.py)
    step = jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(epoch)
    adapted = 0
    for s in range(2):
        grads = rng.randn(W, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.PRNGKey(10 * epoch + s)
        jout, jmem, jvals, jidx = step(jnp.asarray(grads), jmem, key)
        phases = [_uniforms(je, jax.random.fold_in(key, w))
                  for w in range(W)]
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        sent = [te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])
                for w in range(W)]
        tk.reset_launches()
        touts = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                            phases, LocalComm(W))
        adapted += tk.LAUNCHES["ladder_counts"]
        for w in range(W):
            np.testing.assert_array_equal(_bits(sent[w][0].numpy()),
                                          _bits(jvals[w]))
            np.testing.assert_array_equal(sent[w][1].numpy(),
                                          np.asarray(jidx[w]))
            for k in ("momentums_c", "velocities_c", "momentums_d",
                      "velocities_d", "sent_bits"):
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].numpy()), _bits(jmem[k][w]),
                    err_msg=k)
            np.testing.assert_array_equal(_bits(touts[w].numpy()),
                                          _bits(jout[w]))
        assert (np.asarray(jidx) != S).sum() > 0
    # the plain version runs on the CPU: the kernel's counter stays at 0
    assert adapted == 0


#: an H100's cudaOccupancyMaxActiveClusters for the ladder kernel (as in
#: test_torch_compensate_multi.py)
_H100_CLUSTERS = {
    512: (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
    1024: (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)}


@pytest.mark.parametrize("model", ["resnet20", "resnet110", "resnet50"])
def test_ladder_plan_at_one_level_does_not_split(model):
    """The adaptation's count: one level over each 2-D bucket of the
    model's layout; the plan keeps it in one split, one wave."""
    tree = param_tree(create(model, 10, torch.Generator()))
    names = [n for n, p in jax_named_flatten(tree)[0].items()
             if len(p.shape) > 1]
    layout = tflat.ParamLayout(tree, names)
    for g in layout.buckets:
        plan = tk.ladder_plan(g.rows, g.cols, 1,
                              lambda t, c: _H100_CLUSTERS[t][c - 1])
        assert plan.splits == 1
        assert g.rows <= _H100_CLUSTERS[plan.threads][plan.cluster - 1]
    if model == "resnet110":
        assert [(g.rows, g.cols) for g in layout.buckets] == [
            (36, 36864), (76, 9216)]


@pytest.mark.parametrize("flags", [dict(resample=False),
                                   dict(strided_sample=False), FLAGS])
def test_resnet50_builds_on_the_2d_path(flags):
    """With either flag off no bucket takes the segment path (its
    preconditions need both), so ResNet-50's wide buckets build on the
    2-D path at every warm-up ratio."""
    model = create("resnet50", 1000, torch.Generator())
    comp = tdgc.DGCCompressor(0.001, warmup_epochs=5, **flags)
    comp.initialize((n.replace(".", "/"), tuple(p.shape))
                    for n, p in model.named_parameters() if p.dim() > 1)
    layout = tflat.ParamLayout.for_compressor(param_tree(model), comp)
    for epoch in (0, 5):
        comp.warmup_compress_ratio(epoch)
        eng = tflat.FlatDGCEngine(comp, layout)
        assert not any(eng._seg) and not eng._seg_fused
        assert eng.payload_size > 0
