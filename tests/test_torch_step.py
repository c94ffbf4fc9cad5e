"""The slice as a whole, against the JAX package.

(a) The update: the JAX model's real flat gradients go through the JAX
    ``DistributedOptimizer.update_flat`` (flat engine + ``dgc_sgd``) and
    through the port's, for two steps at W=2. The JAX side runs op by op
    (``jax.vmap`` over a named axis, no ``jax.jit``: under jit XLA-CPU
    contracts multiply-adds into FMAs, see test_torch_kernels.py), and the
    port gets the JAX engine's sampling phases. New parameters and the
    optimizer's momentum are bitwise, apart from coordinates both workers
    sent, whose gradient sums differ in order: rtol 1e-6 there.
(b) Training: three steps of ResNet-20 at W=2 through the port's harness
    (``Trainer``, ``LocalComm``) and through the JAX package's jitted
    ``build_train_step`` on a 2-device mesh, from the same weights on the
    same batches. The port draws the JAX step's sampling phases (its
    ``draw_phases`` is patched to hand them over). The mean losses agree
    within rtol 1e-3: the convolutions sum in other orders, and under jit
    XLA-CPU contracts the compensate's multiply-adds into FMAs, so
    selections may differ at the threshold's margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.data import CIFAR as JaxCIFAR
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.models import resnet20
from dgc_tpu.training import lr as jlr
from dgc_tpu.training import (build_train_step, cosine_schedule,
                              make_flat_setup, make_flat_state,
                              make_lr_schedule, shard_state)
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import lr as tlr


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 2


@pytest.fixture(scope="module")
def variables():
    v = resnet20().init(jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v)


def _lr(mod, steps_per_epoch):
    return mod.make_lr_schedule(
        scaled_lr=0.1 * W, world_size=W, num_steps_per_epoch=steps_per_epoch,
        warmup_lr_epochs=5, decay=mod.cosine_schedule(195))


def _jax_grads(v, rng):
    """Each worker's flat gradient of the JAX model on its own batch."""
    model = resnet20()
    images = rng.randn(W, 4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, (W, 4)).astype(np.int32)

    def loss(p, x, y):
        logits, _ = model.apply({"params": p,
                                 "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], axis=1))
    g = jax.jit(jax.vmap(jax.grad(loss), in_axes=(None, 0, 0)))(
        v["params"], images, labels)
    return [{k: np.asarray(a[w]) for k, a in
             jax_named_flatten(g)[0].items()} for w in range(W)]


def _phases(engine, key):
    """The uniforms the JAX engine's ``_sample_rows`` draws from ``key``:
    one per (bucket, stride group) of every sampled bucket."""
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


@pytest.mark.parametrize("epoch", [0, 5])
def test_update_matches_jax(variables, epoch):
    kw = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(variables["params"])[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    spe = 4
    jdist = DistributedOptimizer(
        dgc_sgd(_lr(jlr, spe), momentum=0.9, weight_decay=1e-4), jc,
        world_size=W)
    tdist = TDist(t_dgc_sgd(_lr(tlr, spe), momentum=0.9, weight_decay=1e-4),
                  tc, LocalComm(W))
    jlayout, je = jdist.make_flat(variables["params"])
    tlayout, te = tdist.make_flat(variables["params"])
    assert tlayout.offsets == jlayout.offsets

    jparams = jlayout.flatten(variables["params"])
    jopt = jdist.init(jparams)
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tparams = torch.from_numpy(np.asarray(jparams).copy())
    topt = tdist.init(tparams)
    tmems = [te.init_memory("cpu") for _ in range(W)]

    def worker(fg, opt, params, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        upd, opt, mem = jdist.update_flat(fg, opt, params, mem, key, je)
        return params + upd, opt, mem
    # op by op (no jax.jit), see the module docstring
    jstep = jax.vmap(worker, in_axes=(0, None, None, 0, None),
                     axis_name="data")

    rng = np.random.RandomState(epoch)
    S, P_ = tlayout.sentinel, tlayout.total
    for s in range(2):
        grads = np.stack([np.asarray(jlayout.flatten(g))
                          for g in _jax_grads(variables, rng)])
        key = jax.random.PRNGKey(10 * epoch + s)
        new_p, new_opt, jmem = jstep(jnp.asarray(grads), jopt, jparams,
                                     jmem, key)
        jparams = new_p[0]
        jopt = jax.tree.map(lambda x: x[0], new_opt)
        phases = [_phases(je, jax.random.fold_in(key, w))
                  for w in range(W)]
        # the coordinates both workers send, before the port's memory
        # moves on: their sums are taken in another order
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        sent = [te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])[1]
                for w in range(W)]
        tparams, topt, _ = tdist.update_flat(
            [torch.from_numpy(g) for g in grads], topt, tparams, tmems,
            phases, te)
        idx = torch.cat(sent).numpy()
        idx = idx[idx != S]
        u, c = np.unique(idx, return_counts=True)
        dup = np.zeros(P_, bool)
        dup[u[c > 1]] = True
        got, want = tparams.numpy(), np.asarray(jparams)
        np.testing.assert_array_equal(got[~dup].view(np.int32),
                                      want[~dup].view(np.int32))
        np.testing.assert_allclose(got[dup], want[dup], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            topt.momentum_buffer.numpy(),
            np.asarray(jopt.momentum_buffer))
        assert topt.count == int(jopt.count)
        for w in range(W):
            np.testing.assert_array_equal(tmems[w]["sent_bits"].numpy(),
                                          np.asarray(jmem["sent_bits"][w]))


def _small_cfg():
    cfg = configs.resnet20_wm5()
    cfg.train.batch_size = 8
    cfg.dataset.synthetic_size = 64
    return cfg


def _jax_losses(variables, cfg, steps):
    """The JAX package's own flat train step on a 2-device mesh. Returns
    the mean losses and, per step and worker, the sampling phases the
    step drew."""
    cc, tr = cfg.train.compression, cfg.train
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs)
    named = jax_named_flatten(variables["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxCIFAR(cfg.dataset.root, 10, 32,
                  synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = W * tr.batch_size
    spe = len(ds) // gb
    dist = DistributedOptimizer(
        dgc_sgd(make_lr_schedule(0.1 * W, W, spe, 5, cosine_schedule(195)),
                momentum=0.9, weight_decay=1e-4), comp, world_size=W)
    comp.warmup_compress_ratio(0)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    setup = make_flat_setup(variables, dist)
    state = shard_state(make_flat_state(variables, dist, setup, W), mesh,
                        dist_opt=dist)
    step_fn = build_train_step(resnet20().apply, dist, mesh, donate=False,
                               flat=setup)
    losses, phases = [], []
    base = jax.random.PRNGKey(cfg.seed)
    for b, idx in enumerate(jax_epoch_batches(len(ds), gb, 0,
                                              seed=cfg.seed)):
        if b == steps:
            break
        images, labels = ds.get_batch(idx)
        key = jax.random.fold_in(base, b)
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels),
                           key)
        losses.append(float(m["loss"]))
        # the step's per-worker sparsify key (training/step.py)
        phases += [_phases(setup.engine, jax.random.split(
            jax.random.fold_in(key, w))[1]) for w in range(W)]
    return losses, phases


def test_three_steps_track_jax(variables, monkeypatch):
    cfg = _small_cfg()
    want, phases = _jax_losses(variables, cfg, 3)
    phases.reverse()
    monkeypatch.setattr(tflat.FlatDGCEngine, "draw_phases",
                        lambda self, gen: phases.pop())
    trainer = Trainer(cfg, LocalComm(W), device="cpu")
    trainer.load_flat(*carry_variables(
        variables["params"], variables["batch_stats"], trainer.setup.layout,
        trainer.setup.stats_layout))
    losses = [float(x) for x in trainer.run_epoch(0, steps=3)]
    assert trainer.compression.compress_ratio == pytest.approx(0.316, 1e-3)
    assert not phases                     # one draw per worker and step
    np.testing.assert_allclose(losses, want, rtol=1e-3)
