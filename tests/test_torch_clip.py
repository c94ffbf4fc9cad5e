"""Gradient clipping against the JAX package.

* Each function of ``utils/clip_grad.py`` against JAX's: on one tensor, on
  a [R, n] batch of rows (JAX's ``jax.vmap``), and for the global variants
  over W workers (``LocalComm`` against ``jax.vmap`` over a named axis
  with ``pmean``).
* The flat engine with a ``gradient_clipping`` callable: the dense branch
  (ratio 1, the clip on the averaged gradient) and the compressed branch
  (ratio 0.001, the clip on each worker's compressed block before the
  compensate, and on the averaged dense tail), W=3, against the JAX engine
  run op by op; the per-tensor memory's clip, one worker and W workers at
  once (``compensate_all``); and the per-tensor exchange with the global
  clip (its dense tensors clipped across the workers,
  ``decompress_all``) against the flat engine's, within the per-tensor ==
  flat tolerance of test_torch_per_tensor.py (rtol 1e-5, atol 1e-6).

Tolerance: a clip multiplies by a factor from a sum of squares, which
the port sums in another order than XLA (within a row, and across
workers for the global variants), so the factor may differ by an ulp or
two: clipped values within rtol 1e-6 (atol 1e-7 of the row's scale near
zero), and the transmitted indices and the transmit record equal. Where
no factor is taken (a value clip) the results are bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils import clip_grad as jclip
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.utils import clip_grad as tclip
from dgc_tpu_torch.utils.pytree import named_flatten

TOL = dict(rtol=1e-6, atol=1e-7)

LOCAL = [("clip_grad_norm", dict(max_norm=1.5)),
         ("clip_grad_norm", dict(max_norm=1.5, norm_type=float("inf"))),
         ("clip_grad_norm", dict(max_norm=30.0, norm_type=1)),
         ("clip_grad_norm", dict(max_norm=1e4)),          # no clip
         ("clip_grad_value", dict(clip_value=0.7))]
GLOBAL = [("clip_grad_value_by_global_norm", {}),
          ("clip_grad_norm_2_by_global", dict(max_norm=2.0)),
          ("clip_grad_norm_2_by_global", dict(max_norm=1e4))]


def _rows(seed, R=5, n=700):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, n) * rng.rand(R, 1) * 3).astype(np.float32)
    x[:, n - 50:] = 0.0                     # a padded tail changes nothing
    return x


@pytest.mark.parametrize("name,kw", LOCAL + GLOBAL)
def test_clip_functions_match_jax(name, kw):
    x = _rows(1)
    jf = functools.partial(getattr(jclip, name), **kw)
    tf = functools.partial(getattr(tclip, name), **kw)
    want_1d = jf(jnp.asarray(x[0]))
    want_rows = jax.vmap(jf)(jnp.asarray(x))
    got_1d = tf(torch.from_numpy(x[0]))
    got_rows = tf(torch.from_numpy(x))
    got_list = tf([torch.from_numpy(x[0]), torch.from_numpy(x[1])])
    np.testing.assert_allclose(got_1d.numpy(), want_1d, **TOL)
    np.testing.assert_allclose(got_rows.numpy(), want_rows, **TOL)
    np.testing.assert_allclose(got_list[1].numpy(), want_rows[1], **TOL)
    # padding invariance: the zero tail stays zero, the rest as unpadded
    np.testing.assert_array_equal(got_rows.numpy()[:, -50:], 0.0)
    np.testing.assert_allclose(tf(torch.from_numpy(x[:, :-50])).numpy(),
                               got_rows.numpy()[:, :-50], **TOL)
    if name == "clip_grad_value":
        np.testing.assert_array_equal(got_rows.numpy(),
                                      np.asarray(want_rows))


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name,kw", GLOBAL)
def test_global_clips_reduce_across_workers(world, name, kw):
    """Each worker's rows against the JAX function under ``pmean`` over a
    named axis; the port sums the workers' squares in rank order."""
    x = np.stack([_rows(10 + w) for w in range(world)])
    jf = functools.partial(getattr(jclip, name), axis_name="data", **kw)
    want = jax.vmap(jax.vmap(jf), axis_name="data")(jnp.asarray(x))
    got = getattr(tclip, name)([torch.from_numpy(a) for a in x],
                               comm=LocalComm(world), **kw)
    for w in range(world):
        np.testing.assert_allclose(got[w].numpy(), want[w], **TOL)
    if "max_norm" in kw:
        clipper = tclip.global_norm_clipper(kw["max_norm"],
                                            comm=LocalComm(world))
        for a, b in zip(clipper([torch.from_numpy(a) for a in x]), got):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def params():
    v = resnet20().init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v["params"])


def _engines(params, epoch, jclipper, tclipper):
    kw = dict(sample_ratio=0.01, warmup_epochs=5,
              warmup_coeff=[1, 1, 1, 1, 1])
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(
        momentum=0.9, gradient_clipping=jclipper), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(
        momentum=0.9, gradient_clipping=tclipper), **kw)
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                params, tc)))


def _phases(engine, key):
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


CLIPPERS = {
    "norm": (functools.partial(jclip.clip_grad_norm, max_norm=0.5),
             lambda comm: functools.partial(tclip.clip_grad_norm,
                                            max_norm=0.5)),
    "global": (functools.partial(jclip.clip_grad_norm_2_by_global,
                                 max_norm=0.5, axis_name="data"),
               lambda comm: tclip.global_norm_clipper(0.5, comm=comm))}


@pytest.mark.parametrize("clipper", ["norm", "global"])
@pytest.mark.parametrize("epoch", [4, 5])
def test_engine_clipping_matches_jax(params, epoch, clipper):
    W = 3
    comm = LocalComm(W)
    jcl, tcl = CLIPPERS[clipper]
    je, te = _engines(params, epoch, jcl, tcl(comm))
    assert te.dense == (epoch == 4)
    T, P_ = te.T, te.layout.total
    rng = np.random.RandomState(epoch)
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]

    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return je.exchange(fg, mem, key, "data", W)
    step = jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")
    for s in range(2):
        grads = rng.randn(W, P_).astype(np.float32)
        key = jax.random.PRNGKey(s)
        jout, jmem = step(jnp.asarray(grads), jmem, key)
        phases = [_phases(je, jax.random.fold_in(key, w)) for w in range(W)]
        touts = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                            phases, comm)
        if s == 0:
            # the clip engaged: the dense tensors' first output (no
            # momentum yet) is below their raw average
            lay = te.layout
            tail = np.concatenate([np.arange(lay.offsets[n], lay.offsets[n]
                                             + lay.sizes[n])
                                   for n in lay.dense_names])
            assert (np.abs(touts[0].numpy()[tail]).max()
                    < np.abs(grads[:, tail].mean(0)).max())
        for w in range(W):
            np.testing.assert_allclose(touts[w].numpy(), jout[w], **TOL)
            np.testing.assert_array_equal(tmems[w]["sent_bits"].numpy(),
                                          np.asarray(jmem["sent_bits"][w]))
            for k in ("momentums_c", "velocities_c", "momentums_d"):
                np.testing.assert_allclose(tmems[w][k].numpy(), jmem[k][w],
                                           err_msg=k, **TOL)


@pytest.mark.parametrize("clipper", ["norm", "global"])
def test_memory_clipping_matches_jax(clipper):
    """The per-tensor memory's compensate with clipping, accumulating (W
    workers through ``compensate_all``) and not (one worker)."""
    W, n = 3, 3000
    comm = LocalComm(W)
    jcl, tcl = CLIPPERS[clipper]
    jm = DGCSGDMemory(momentum=0.9, gradient_clipping=jcl)
    tm = TMemory(momentum=0.9, gradient_clipping=tcl(comm))
    rng = np.random.RandomState(3)
    g = rng.randn(W, n).astype(np.float32)
    m0 = rng.randn(W, n).astype(np.float32)
    v0 = rng.randn(W, n).astype(np.float32)

    def worker(gw, mw, vw, accumulate):
        st = {"momentums": {"w": mw}, "velocities": {"w": vw}}
        out, st = jm.compensate(st, "w", gw, accumulate=accumulate)
        return out, st["momentums"]["w"], st["velocities"]["w"]
    for accumulate in (True, False):
        want = jax.vmap(functools.partial(worker, accumulate=accumulate),
                        axis_name="data")(jnp.asarray(g), jnp.asarray(m0),
                                          jnp.asarray(v0))
        states = [{"momentums": {"w": torch.from_numpy(m0[w].copy())},
                   "velocities": {"w": torch.from_numpy(v0[w].copy())}}
                  for w in range(W)]
        if accumulate:
            outs = tm.compensate_all([(states[w], "w", torch.from_numpy(g[w]))
                                      for w in range(W)])
        elif clipper == "norm":
            outs = [tm.compensate(states[w], "w", torch.from_numpy(g[w]),
                                  accumulate=False)[0] for w in range(W)]
        else:
            clipped = tm.clip([torch.from_numpy(g[w]) for w in range(W)])
            outs = [tm.compensate(states[w], "w", clipped[w],
                                  accumulate=False, clipped=True)[0]
                    for w in range(W)]
        for w in range(W):
            np.testing.assert_allclose(outs[w].numpy(), want[0][w], **TOL)
            np.testing.assert_allclose(
                states[w]["momentums"]["w"].numpy(), want[1][w], **TOL)
            np.testing.assert_allclose(
                states[w]["velocities"]["w"].numpy(), want[2][w], **TOL)


_TREE = {"conv1": {"kernel": (3, 3, 8, 16)},
         "conv2": {"kernel": (3, 3, 16, 16)},
         "dense": {"kernel": (64, 10), "bias": (10,)},
         "bn": {"scale": (16,), "bias": (16,)}}


@pytest.mark.parametrize("ratio", [0.05, 1.0])
def test_per_tensor_clipping_equals_the_flat_engine(ratio):
    """At ``sample_ratio=1.0`` neither path samples, so the two exchanges
    agree (test_torch_per_tensor.py), also with the global clip: the flat
    engine clips bucket rows and the gathered dense tail, the per-tensor
    path each tensor (its dense ones across the workers)."""
    W = 3
    named = named_flatten(_TREE)

    def make():
        comp = tdgc.DGCCompressor(ratio, memory=TMemory(
            momentum=0.9, gradient_clipping=tclip.global_norm_clipper(
                0.5, LocalComm(W))), sample_ratio=1.0)
        comp.initialize((n, s) for n, s in named.items() if len(s) > 1)
        return TDist(t_dgc_sgd(0.1), comp, LocalComm(W))
    dist_f, dist_p = make(), make()
    layout, engine = dist_f.make_flat(_TREE)
    assert engine.dense == (ratio == 1.0)
    mems_f = [engine.init_memory("cpu") for _ in range(W)]
    mems_p = [dist_p.init_memory({n: torch.zeros(s) for n, s in
                                  named.items()}) for _ in range(W)]
    rng = np.random.RandomState(8)
    for step in range(2):
        grads = [{n: torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for n, s in named.items()} for _ in range(W)]
        out_f = engine.exchange([layout.flatten(g) for g in grads], mems_f,
                                [[[]] * len(engine.buckets)] * W,
                                LocalComm(W))
        out_p, mems_p = dist_p.exchange(grads, mems_p, [{}] * W)
        for w in range(W):
            got = layout.unflatten_named(out_f[w])
            for n in named:
                np.testing.assert_allclose(
                    got[n].numpy(), out_p[w][n].numpy(), rtol=1e-5,
                    atol=1e-6, err_msg=f"step {step} {n}")
    # the clip engaged: every output tensor's norm is at most 0.5 plus
    # the momentum's share
    assert max(float(t.norm()) for t in out_p[0].values()) < 1.0
