"""Training the ImageNet ResNets with the port against the JAX package's
jitted ``build_train_step``, at W=2 on the CPU, from the same flax weights
(carried over) on the same synthetic batches, the port drawing the JAX
step's sampling phases (its ``draw_phases`` is patched to hand them over):

* two ResNet-50 steps at ratio 0.001 — the segment path, six of seven
  buckets selecting among the fused compensate's candidates;
* three ResNet-18 steps at the epoch-0 ratio 0.316 — selections beyond the
  top-k kernel's k, through the ``lax_top_k`` route.

The mean losses agree within rtol 1e-3, as in test_torch_step.py: the
convolutions sum in other orders, and under jit XLA-CPU contracts the
compensate's multiply-adds into FMAs, so selections may differ at the
threshold's margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.compression.flat import ParamLayout as JaxLayout
from dgc_tpu.data import ImageNet as JaxImageNet
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.models import resnet18 as flax_resnet18
from dgc_tpu.models import resnet50 as flax_resnet50
from dgc_tpu.training import build_train_step
from dgc_tpu.training import lr as jlr
from dgc_tpu.training import make_flat_setup, make_flat_state, shard_state
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 2
FLAX = {"resnet18": flax_resnet18, "resnet50": flax_resnet50}


def _phases(engine, key):
    """The uniforms the JAX engine's samplers draw from ``key``."""
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def _small_cfg(recipe, batch_size):
    """The recipe at 32x32, 3 steps an epoch at W=2. At 32x32 the last
    stage's BatchNorm normalises ``batch_size`` values a channel: with 2
    or 4 at ratio 0.316 the two packages' f32 differences grow a
    hundredfold a step (ResNet-18: 5e-3 in the loss by the third step);
    with 8 they stay at f32 rounding."""
    cfg = tconfigs.RECIPES[recipe]()
    cfg.train.batch_size = batch_size
    cfg.dataset.image_size = 32
    cfg.dataset.synthetic_size = 3 * W * batch_size
    return cfg


def _jax_losses(variables, cfg, epoch, steps):
    """The JAX package's own flat train step on a 2-device mesh, built from
    the recipe's values. Returns the mean losses and, per step and
    worker, the sampling phases the step drew."""
    cc, tr = cfg.train.compression, cfg.train
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs)
    named = jax_named_flatten(variables["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxImageNet(cfg.dataset.root, 1000, 32,
                     synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = W * tr.batch_size
    spe = len(ds) // gb
    oc, sc = tr.optimizer, tr.scheduler
    wd_mask = None
    if tr.optimize_bn_separately:
        wd_mask = JaxLayout.for_compressor(
            variables["params"], comp).mask_vector(
                lambda n: "BatchNorm" not in n)
    sched = jlr.make_lr_schedule(
        oc.lr * W, W, spe, tr.warmup_lr_epochs,
        jlr.multistep_schedule(sc.milestones, sc.gamma))
    dist = DistributedOptimizer(
        dgc_sgd(sched, momentum=oc.momentum, weight_decay=oc.weight_decay,
                nesterov=oc.nesterov, weight_decay_mask=wd_mask),
        comp, world_size=W)
    comp.warmup_compress_ratio(epoch)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    setup = make_flat_setup(variables, dist)
    state = shard_state(make_flat_state(variables, dist, setup, W), mesh,
                        dist_opt=dist)
    model = FLAX[cfg.model.name](num_classes=1000, zero_init_residual=True)
    step_fn = build_train_step(model.apply, dist, mesh, donate=False,
                               flat=setup)
    losses, phases = [], []
    base = jax.random.PRNGKey(cfg.seed)
    for b, idx in enumerate(jax_epoch_batches(len(ds), gb, epoch,
                                              seed=cfg.seed)):
        if b == steps:
            break
        images, labels = ds.get_batch(idx)
        key = jax.random.fold_in(base, b)
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels),
                           key)
        losses.append(float(m["loss"]))
        phases += [_phases(setup.engine, jax.random.split(
            jax.random.fold_in(key, w))[1]) for w in range(W)]
    return losses, phases, setup.engine


@pytest.mark.parametrize("recipe,epoch,steps,batch_size", [
    ("resnet50_wm5", 5, 2, 4), ("resnet18_wm5", 0, 3, 8)])
def test_steps_track_jax(recipe, epoch, steps, batch_size, monkeypatch):
    cfg = _small_cfg(recipe, batch_size)
    flax_model = FLAX[cfg.model.name](num_classes=1000,
                                      zero_init_residual=True)
    variables = jax.device_get(flax_model.init(
        jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)), train=True))
    want, phases, jengine = _jax_losses(variables, cfg, epoch, steps)
    phases.reverse()
    monkeypatch.setattr(tflat.FlatDGCEngine, "draw_phases",
                        lambda self, gen: phases.pop())
    trainer = Trainer(cfg, LocalComm(W), device="cpu")
    trainer.load_flat(*carry_variables(
        variables["params"], variables["batch_stats"], trainer.setup.layout,
        trainer.setup.stats_layout))
    tflat.ROUTES["lax_top_k"] = 0
    losses = [float(x) for x in trainer.run_epoch(epoch, steps=steps)]
    engine = trainer.setup.engine
    assert not phases                     # one draw per worker and step
    assert engine._seg == [jengine._use_seg_kernel(b)
                           for b in jengine.buckets]
    if epoch == 5:
        assert sum(engine._seg) == 6 and engine._seg_fused
    else:
        assert tflat.ROUTES["lax_top_k"] > 0
    np.testing.assert_allclose(losses, want, rtol=1e-3)
