"""The port's harness pieces against the JAX package: the recipe's values,
the learning-rate schedule, ``dgc_sgd`` (with and without the
per-coordinate weight-decay mask), the synthetic CIFAR data and the batch
order. All bitwise; the JAX optimizer runs op by op (no ``jax.jit``, whose
XLA-CPU FMA contraction the port does not reproduce)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.data import CIFAR as JaxCIFAR
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.optim import dgc_sgd as jax_dgc_sgd
from dgc_tpu.training import lr as jlr
from dgc_tpu.utils.config import Config, configs
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.data import datasets as tdata
from dgc_tpu_torch.data import sampler as tsampler
from dgc_tpu_torch.optim.sgd import dgc_sgd
from dgc_tpu_torch.training import lr as tlr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_recipe(monkeypatch):
    monkeypatch.chdir(REPO)
    Config.reset()
    Config.update_from_modules("configs/cifar/resnet20.py",
                               "configs/dgc/wm5.py")
    yield configs
    Config.reset()


def test_recipe_values_match_the_config_files(jax_recipe):
    c, t = jax_recipe, tconfigs.resnet20_wm5()
    assert t.seed == c.seed
    assert t.dataset.root == c.dataset.root
    assert t.dataset.num_classes == c.dataset.num_classes
    assert t.dataset.image_size == c.dataset.image_size
    assert t.model.name == c.model.callable.__name__
    assert t.model.num_classes == c.model.num_classes
    for k in ("num_epochs", "batch_size", "warmup_lr_epochs",
              "schedule_lr_per_epoch"):
        assert t.train[k] == c.train[k], k
    assert t.train.num_batches_per_step == c.train.get(
        "num_batches_per_step", 1)
    assert t.train.scheduler.t_max == c.train.scheduler.t_max
    assert c.train.scheduler.callable.__name__ == "cosine_schedule"
    for k in ("lr", "momentum", "weight_decay"):
        assert t.train.optimizer[k] == c.train.optimizer[k], k
    assert c.train.optimizer.callable.__name__ == "dgc_sgd"
    for k in ("compress_ratio", "sample_ratio", "strided_sample",
              "compress_upper_bound", "compress_lower_bound",
              "max_adaptation_iters", "resample", "warmup_epochs"):
        assert t.train.compression[k] == c.train.compression[k], k
    assert (t.train.compression.memory.momentum
            == c.train.compression.memory.momentum)


@pytest.mark.parametrize("world,per_epoch", [(1, 391), (4, 4)])
def test_lr_schedule_matches_jax(world, per_epoch):
    kw = dict(scaled_lr=0.1 * world, world_size=world,
              num_steps_per_epoch=per_epoch, warmup_lr_epochs=5)
    j = jlr.make_lr_schedule(decay=jlr.cosine_schedule(195), **kw)
    t = tlr.make_lr_schedule(decay=tlr.cosine_schedule(195), **kw)
    # the warm-up, its end, and the first epochs of the cosine
    for count in list(range(0, 6 * per_epoch, max(1, per_epoch // 7))) + [
            5 * per_epoch, 5 * per_epoch + 1, 7 * per_epoch]:
        assert np.float32(t(count)) == np.asarray(j(count)), count


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
def test_dgc_sgd_matches_jax(masked, nesterov):
    rng = np.random.RandomState(3)
    n = 4096
    mask = (rng.rand(n) < 0.7).astype(np.float32) if masked else None
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
    sched = jlr.make_lr_schedule(0.2, 2, 3, 5, jlr.cosine_schedule(195))
    tsched = tlr.make_lr_schedule(0.2, 2, 3, 5, tlr.cosine_schedule(195))
    jopt = jax_dgc_sgd(sched, weight_decay_mask=(
        None if mask is None else jnp.asarray(mask)), **kw)
    topt = dgc_sgd(tsched, weight_decay_mask=(
        None if mask is None else torch.from_numpy(mask)), **kw)
    p = rng.randn(n).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = rng.randn(n).astype(np.float32)
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        tu, ts = topt.update(torch.from_numpy(g), ts, tp)
        jp, tp = jp + ju, tp + tu
        np.testing.assert_array_equal(tp.numpy().view(np.int32),
                                      np.asarray(jp).view(np.int32))
        np.testing.assert_array_equal(
            ts.momentum_buffer.numpy(), np.asarray(js.momentum_buffer))


def test_synthetic_cifar_and_batch_order_match_jax(tmp_path):
    root = str(tmp_path / "absent")
    j = JaxCIFAR(root, 10, 32, synthetic_size=96)
    t = tdata.CIFAR(root, 10, 32, synthetic_size=96)
    for split in ("train", "test"):
        assert len(t[split]) == len(j[split])
        idx = np.arange(len(j[split]))[::5]
        for a, b in zip(t[split].get_batch(idx), j[split].get_batch(idx)):
            np.testing.assert_array_equal(a, b)
    for drop_last in (False, True):
        assert tsampler.num_steps_per_epoch(96, 40, drop_last) == 2 + (
            not drop_last)
        for a, b in zip(tsampler.epoch_batches(96, 40, 3, 42,
                                               drop_last=drop_last),
                        jax_epoch_batches(96, 40, 3, 42,
                                          drop_last=drop_last)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(strided_sample=False),
                                dict(resample=False)])
def test_unported_compressor_options_raise(kw):
    """Options whose code paths this slice does not port are refused, not
    silently run as the default path."""
    with pytest.raises(ValueError):
        DGCCompressor(0.001, **kw)


def test_cifar_pickles_and_augmentation_match_jax(tmp_path, monkeypatch):
    """The pickle reader and the training augmentation (crop, flip,
    normalise) against the JAX package's numpy path, on a tiny fake
    CIFAR-10 directory."""
    import pickle

    import dgc_tpu.data.native as jnative
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.RandomState(9)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as fh:
            pickle.dump({b"data": rng.randint(0, 256, (6, 3072),
                                              dtype=np.uint8),
                         b"labels": list(rng.randint(0, 10, 6))}, fh)
    j = JaxCIFAR(str(tmp_path), 10, 32)
    t = tdata.CIFAR(str(tmp_path), 10, 32)
    assert len(t["train"]) == len(j["train"]) == 30
    for split, idx in (("train", [3, 0, 29, 7, 7, 12]), ("test", [5, 1])):
        for _ in range(2):                    # the augmentation stream
            for a, b in zip(t[split].get_batch(np.array(idx)),
                            j[split].get_batch(np.array(idx))):
                np.testing.assert_array_equal(a, b)
