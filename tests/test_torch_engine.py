"""The port's flat engine exchange at W=8 (``LocalComm``) against the JAX
engine, for ResNet-20's layout at three warm-up ratios and two consecutive
steps (the second applies the first step's transmit record on read).

The JAX side runs op by op, not under ``jax.jit``: under jit XLA-CPU
contracts ``momentum * m + g`` into FMAs, which the port deliberately does
not (see test_torch_kernels.py). Its eight workers run as ``jax.vmap`` over
a named axis, whose collectives have the mesh's semantics at a fraction of
the cost of an op-by-op ``shard_map``; one case runs the ``shard_map`` on
the 8-device ``mesh8`` fixture itself. Both sides draw the same sampling
phases — the JAX engine's own ``fold_in`` uniforms, passed to the port.

Payload values and indices, transmit records, memory and the exchanged
gradient are bitwise, apart from coordinates that several workers sent:
their sums are compared within f32 rounding (rtol 1e-6), because the
reference's scatter leaves the order of duplicate updates to XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils.compat import shard_map
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.parallel.comm import LocalComm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 8


@pytest.fixture(scope="module")
def params():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v["params"])


def _engines(params, epoch):
    kw = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                params, tc)))


def _jax_phases(engine, key):
    """The uniforms the JAX engine's _sample_rows draws, per worker."""
    out = []
    for w in range(W):
        kw = jax.random.fold_in(key, w)
        per = []
        for bi, b in enumerate(engine.buckets):
            kb = jax.random.fold_in(kw, bi)
            per.append([] if b.exact else [
                float(jax.random.uniform(jax.random.fold_in(kb, gi), ()))
                for gi in range(len(b.stride_groups))])
        out.append(per)
    return out


def _worker(engine):
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        _, mc, vc, _ = engine._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg, mem["sent_bits"])
        vals, idx = engine.sparsify(vc, key)
        out, mem = engine.exchange(fg, mem, key, "data", W)
        return out, mem, vals, idx
    return worker


def _vmap_step(engine):
    # op by op: no jax.jit around it (see the module docstring)
    return jax.vmap(_worker(engine), in_axes=(0, 0, None), axis_name="data")


def _mesh_step(engine, mesh):
    worker = _worker(engine)

    def per_device(fg, mem, key):
        out = worker(fg[0], jax.tree.map(lambda x: x[0], mem), key)
        return jax.tree.map(lambda x: x[None], out)
    return shard_map(per_device, mesh=mesh,
                     in_specs=(P("data"), P("data"), P()),
                     out_specs=(P("data"), P("data"), P("data"), P("data")),
                     check_vma=False)


def _check_steps(je, te, step, epoch, steps, recorded=False):
    """``recorded``: also run each exchange on a second set of memories
    under the verifier's recorder (every ``dgcver.*`` anchor reporting to
    it): outputs and memories bitwise those of the unrecorded run, whose
    anchors, with no recorder, do nothing."""
    from dgc_tpu_torch.analysis.program import Recorder
    from dgc_tpu_torch.ops import kernels
    T, P_, S = te.T, te.layout.total, te.layout.sentinel
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(epoch)
    for s in range(steps):
        grads = rng.randn(W, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.PRNGKey(100 * epoch + s)
        jout, jmem, jvals, jidx = step(jnp.asarray(grads), jmem, key)
        phases = _jax_phases(je, key)
        # the port's memory is updated in place: recompute each worker's
        # payload from a snapshot of the pre-step memory
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        tvals, tidx = zip(*[te.compress(torch.from_numpy(grads[w]), pre[w],
                                        phases[w]) for w in range(W)])
        assert kernels.VTAG_RECORDER is None
        touts = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                            phases, LocalComm(W))
        if recorded:
            with Recorder() as rec:
                routs = te.exchange([torch.from_numpy(g) for g in grads],
                                    rmems, phases, LocalComm(W))
            assert rec.prog.eqns
            for a, b in zip(routs + [t for m in rmems for t in m.values()],
                            touts + [t for m in tmems for t in m.values()]):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, b.view(torch.int32)
                                   if b.is_floating_point() else b)
        for w in range(W):
            np.testing.assert_array_equal(
                tvals[w].numpy().view(np.int32),
                np.asarray(jvals[w]).view(np.int32))
            np.testing.assert_array_equal(tidx[w].numpy(),
                                          np.asarray(jidx[w]))
            for k in ("momentums_c", "velocities_c", "momentums_d",
                      "velocities_d", "sent_bits"):
                np.testing.assert_array_equal(
                    tmems[w][k].numpy(), np.asarray(jmem[k][w]), err_msg=k)
        # every worker's exchanged gradient is the same; coordinates sent
        # by more than one worker are sums in another order
        real = np.asarray(jidx).reshape(-1)
        real = real[real != S]
        uniq, counts = np.unique(real, return_counts=True)
        dup = np.zeros(P_, bool)
        dup[uniq[counts > 1]] = True
        ref = np.asarray(jout[0])
        for w in range(W):
            got = touts[w].numpy()
            np.testing.assert_array_equal(got[~dup].view(np.int32),
                                          ref[~dup].view(np.int32))
            np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6, atol=0)
    # the per-name checkpoint format, both ways, on the last worker
    jm = jax.tree.map(lambda x: x[W - 1], jmem)
    jsd, tsd = je.memory_state_dict(jm), te.memory_state_dict(tmems[W - 1])
    for key in ("momentums", "velocities"):
        assert list(tsd[key]) == list(jsd[key])
        for n, a in jsd[key].items():
            np.testing.assert_array_equal(tsd[key][n].numpy(), np.asarray(a))
    jsd = jax.tree.map(np.asarray, jsd)
    jl = je.load_memory_state_dict(je.init_memory(), jsd)
    tl = te.load_memory_state_dict(te.init_memory("cpu"), jsd)
    for k, a in jl.items():
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(a), err_msg=k)


@pytest.mark.parametrize("epoch", [0, 4, 5])
def test_exchange_matches_jax_engine(params, epoch):
    je, te = _engines(params, epoch)
    assert te.payload_size == je.payload_size
    _check_steps(je, te, _vmap_step(je), epoch, steps=2,
                 recorded=epoch == 5)


def test_exchange_matches_jax_engine_on_mesh8(mesh8, params):
    je, te = _engines(params, 5)
    _check_steps(je, te, _mesh_step(je, mesh8), 5, steps=1)
