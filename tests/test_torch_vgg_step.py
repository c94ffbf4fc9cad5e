"""VGG training steps in the port against the JAX package's jitted
``build_train_step``, on the CPU, at the narrow VGG of
``test_torch_vgg.py`` (``cfg=(8, "M", 16, "M")``, 28x28, 10 classes), W=2,
from the same weights on the same batches with the JAX step's sampling
phases (the port's ``draw_phases`` is patched to hand them over):

* one step at epoch 1 (fc1 and fc2 on the 3-D fallback, fc2 split into 4
  segment rows) and one at epoch 5 (the segment path), dropout off (the
  two packages draw masks from different generators): the loss within
  rtol 1e-4 and the new parameters within 1e-6 of their scale plus 2 x
  the largest update at any coordinate, almost all within rtol 1e-5 (the
  convolutions sum in other orders, and under jit XLA-CPU contracts the
  compensate's multiply-adds into FMAs, so a selection at the threshold's
  margin may differ). The exchange on given gradients is bitwise, ties
  aside: ``test_torch_wide.py`` and ``test_torch_wide_exchange.py``;
* one bf16 step against the JAX ``model_dtype`` step at epoch 5: one cast
  of the [P] buffer a worker step, every parameter bound as a bf16 view of
  it, no opaque copy, the parameters f32; the loss within rtol 1e-2 (bf16
  activations, 8 bits of mantissa, summed in other orders). Each worker's
  f32 gradient is held, tensor by tensor, against the JAX gradient of the
  same loss through the same cast, on the same images and statistics:
  within 0.35 in relative L2. bf16 rounding alone moves the reference's
  own gradient that far from its f32 one (0.33 at most, at a BatchNorm
  scale; the port read 0.22 at most), while a zero gradient reads 1
  and a BatchNorm backward with its statistics detached 0.69. The
  exception is the convolution biases: BatchNorm's mean subtraction makes
  their exact gradient zero, so both sides hold rounding noise there, and
  the port's may be no larger than the reference's. The new parameters
  lie within 2 x the largest update at any coordinate of the JAX step's,
  almost all within 3% of their update plus 1e-3 of the largest (a
  selection at the threshold's margin may differ under bf16 noise), and
  the largest update is over 100 x the one weight decay alone gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.data import ImageNet as JaxImageNet
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.training import build_train_step
from dgc_tpu.training import lr as jlr
from dgc_tpu.training import make_flat_setup, make_flat_state, shard_state
from dgc_tpu.training.step import make_loss_fn
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import step as tstep
from test_torch_vgg import (CLASSES, SIDE, W, _cfg, _flax,  # noqa: F401
                            one_torch_thread, variables)


def _phases(engine, key):
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def _jax_step(variables, cfg, epoch, model_dtype=None):
    """One step of the JAX package's flat train step on a 2-device mesh,
    from the recipe's values: the mean loss, the new flat parameters and
    each worker's sampling phases."""
    cc, tr = cfg.train.compression, cfg.train
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs)
    named = jax_named_flatten(variables["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxImageNet(cfg.dataset.root, CLASSES, SIDE,
                     synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = W * tr.batch_size
    oc, sc = tr.optimizer, tr.scheduler
    sched = jlr.make_lr_schedule(
        oc.lr * W, W, len(ds) // gb, tr.warmup_lr_epochs,
        jlr.multistep_schedule(sc.milestones, sc.gamma))
    dist = DistributedOptimizer(
        dgc_sgd(sched, momentum=oc.momentum, weight_decay=oc.weight_decay,
                nesterov=oc.nesterov), comp, world_size=W)
    comp.warmup_compress_ratio(epoch)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    setup = make_flat_setup(variables, dist)
    state = shard_state(make_flat_state(variables, dist, setup, W), mesh,
                        dist_opt=dist)
    model = _flax(jnp.bfloat16 if model_dtype else jnp.float32)
    step_fn = build_train_step(model.apply, dist, mesh, donate=False,
                               flat=setup, model_dtype=model_dtype)
    idx = next(iter(jax_epoch_batches(len(ds), gb, epoch, seed=cfg.seed)))
    images, labels = ds.get_batch(idx)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels), key)
    phases = [_phases(setup.engine, jax.random.split(
        jax.random.fold_in(key, w))[1]) for w in range(W)]
    return (float(m["loss"]), np.asarray(jax.device_get(state.params)),
            phases, float(sched(jnp.asarray(epoch * (len(ds) // gb)))))


def _port_step(variables, cfg, epoch, phases, monkeypatch):
    phases = list(reversed(phases))
    monkeypatch.setattr(tflat.FlatDGCEngine, "draw_phases",
                        lambda self, gen: phases.pop())
    trainer = Trainer(cfg, LocalComm(W), device="cpu")
    trainer.load_flat(*carry_variables(
        variables["params"], variables["batch_stats"], trainer.setup.layout,
        trainer.setup.stats_layout))
    p0 = trainer.state.params.clone()
    tflat.ROUTES.update(lax_top_k=0, sel3d=0)
    loss = float(trainer.run_epoch(epoch, steps=1)[0])
    assert not phases
    return trainer, loss, p0


@pytest.mark.parametrize("epoch", [1, 5])
def test_train_step_tracks_jax(variables, epoch, monkeypatch):
    cfg = _cfg()
    want_loss, want_params, phases, lr = _jax_step(variables, cfg, epoch)
    trainer, loss, p0 = _port_step(variables, cfg, epoch, phases,
                                   monkeypatch)
    eng = trainer.setup.engine
    if epoch == 1:
        assert eng._sel3d[:2] == [True, True] and tflat.ROUTES["sel3d"] == 4
    else:
        assert eng._seg[:2] == [True, True] and tflat.ROUTES["sel3d"] == 0
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    got = trainer.state.params.numpy()
    step = np.abs(want_params - p0.numpy()).max()
    assert step > 0
    np.testing.assert_allclose(got, want_params,
                               atol=1e-6 * np.abs(want_params).max()
                               + 2 * step)
    # almost every coordinate agrees to f32 rounding
    close = np.isclose(got, want_params, rtol=1e-5, atol=1e-7)
    assert close.mean() > 0.9999


def _jax_bf16_grad(variables, images, labels):
    """The JAX ``model_dtype`` worker's gradient of the mean loss on one
    NHWC batch: the f32 parameters cast to bf16 inside the differentiated
    function, the gradient f32 (per leaf here; the cast is elementwise)."""
    loss_fn = make_loss_fn(_flax(jnp.bfloat16).apply)

    def loss(p):
        return loss_fn(jax.tree.map(lambda a: a.astype(jnp.bfloat16), p),
                       variables["batch_stats"], images, labels, 1.0,
                       None)[0]
    return jax_named_flatten(jax.jit(jax.grad(loss))(
        variables["params"]))[0]


def test_bf16_step_tracks_jax_model_dtype(variables, monkeypatch):
    cfg = _cfg("vgg16_bn_wm5_bf16")
    want_loss, want_params, phases, lr = _jax_step(
        variables, cfg, 5, model_dtype=jnp.bfloat16)
    casts, bound, seen = [], [], []
    narrow, worker_grad = tstep._narrow_binding, tstep.worker_grad

    def spy(layout, flat, dtype):
        casts.append((flat.dtype, dtype))
        b = narrow(layout, flat, dtype)
        bound.append(b)
        return b

    def grad_spy(model, setup, params, stats, images, labels, *a):
        g, loss = worker_grad(model, setup, params, stats, images, labels,
                              *a)
        seen.append((images.permute(0, 2, 3, 1).numpy(), labels.numpy(),
                     g.clone()))
        return g, loss
    monkeypatch.setattr(tstep, "_narrow_binding", spy)
    monkeypatch.setattr(tstep, "worker_grad", grad_spy)
    for name in ("opaque_view", "opaque_view_from"):
        monkeypatch.setattr(tk, name, lambda *a, **k: pytest.fail(
            "the bf16 path binds no opaque copy"))
    trainer, loss, p0 = _port_step(variables, cfg, 5, phases, monkeypatch)
    assert trainer.model.dtype == torch.bfloat16
    assert casts == [(torch.float32, torch.bfloat16)] * W
    for b in bound:
        params = [t for n, t in b.items()]
        assert all(t.dtype == torch.bfloat16 for t in params)
        assert len({t.untyped_storage().data_ptr() for t in params}) == 1
    np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
    assert trainer.state.params.dtype == torch.float32

    layout = trainer.setup.layout
    assert len(seen) == W
    for images, labels, g in seen:
        assert g.dtype == torch.float32
        want = _jax_bf16_grad(variables, jnp.asarray(images),
                              jnp.asarray(labels))
        for n in layout.names:
            o = layout.offsets[n]
            got = g[o:o + layout.sizes[n]].numpy()
            ref = np.asarray(want[n]).ravel()
            if n.startswith("Conv_") and n.endswith("/bias"):
                assert np.linalg.norm(got) <= np.linalg.norm(ref), n
            else:
                err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert err <= 0.35, (n, err)

    got, p0 = trainer.state.params.numpy(), p0.numpy()
    step = np.abs(want_params - p0).max()
    decay = np.abs(lr * cfg.train.optimizer.weight_decay * p0).max()
    assert np.abs(got - p0).max() > 100 * decay
    np.testing.assert_allclose(got, want_params, rtol=0, atol=2 * step)
    close = (np.abs(got - want_params)
             <= 0.03 * np.abs(want_params - p0) + 1e-3 * step)
    assert close.mean() > 0.999
