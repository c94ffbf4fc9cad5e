"""The port's harness pieces against the JAX package: the recipes'
values, the learning-rate schedule, ``dgc_sgd`` (with and without the
per-coordinate weight-decay mask), the synthetic CIFAR data and the batch
order. All bitwise; the JAX optimizer runs op by op (no ``jax.jit``, whose
XLA-CPU FMA contraction the port does not reproduce). Also the CLI: the
evaluation lines and the recipes' flags reaching the trainer, ``--autotune``
planning and its refusal without DGC, and the flat engine's refusal of the
options this port does not carry yet."""

import json
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
from dgc_tpu_torch import train as ttrain
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu_torch.data import datasets as tdata
from dgc_tpu_torch.data import sampler as tsampler
from dgc_tpu_torch.optim.sgd import dgc_sgd
from dgc_tpu_torch.training import lr as tlr

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
    _check_recipe(c, t)


def _check_recipe(c, t):
    """The port's recipe ``t`` holds the stacked config files' ``c``."""
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


#: the recipes of the reference's stacks: the port's name, then the
#: config files stacked on ``configs/__init__.py`` (each file's package
#: ``__init__.py`` loads first)
STACKS = {
    "resnet20": ("configs/cifar/resnet20.py",),
    "resnet110": ("configs/cifar/resnet110.py",),
    "resnet20_wm0": ("configs/cifar/resnet20.py", "configs/dgc/wm0.py"),
    "resnet20_wm5o": ("configs/cifar/resnet20.py", "configs/dgc/wm5o.py"),
    "resnet20_wm5_nm": ("configs/cifar/resnet20.py", "configs/dgc/wm5.py",
                        "configs/dgc/nm.py"),
    "resnet110_wm5": ("configs/cifar/resnet110.py", "configs/dgc/wm5.py"),
    "resnet110_wm5o": ("configs/cifar/resnet110.py", "configs/dgc/wm5o.py"),
    "resnet50_wm5_cosine": ("configs/imagenet/resnet50.py",
                            "configs/dgc/wm5.py",
                            "configs/imagenet/cosine.py"),
    "vgg16_bn_wm5": ("configs/imagenet/vgg16_bn.py", "configs/dgc/wm5.py"),
    "vgg16_bn_wm5_bf16": ("configs/imagenet/vgg16_bn.py",
                          "configs/dgc/wm5.py", "configs/bf16.py"),
    "resnet20_wm5_fp16": ("configs/cifar/resnet20.py", "configs/dgc/wm5.py",
                          "configs/dgc/fp16.py"),
    "resnet20_wm5_int8": ("configs/cifar/resnet20.py", "configs/dgc/wm5.py",
                          "configs/dgc/int8.py"),
    "resnet20_wm5_int8_packidx": ("configs/cifar/resnet20.py",
                                  "configs/dgc/wm5.py", "configs/dgc/int8.py",
                                  "configs/dgc/packidx.py"),
    "resnet50_wm5_bf16mem": ("configs/imagenet/resnet50.py",
                             "configs/dgc/wm5.py", "configs/dgc/bf16mem.py"),
    "resnet50_wm5_bf16mem_int8_packidx": (
        "configs/imagenet/resnet50.py", "configs/dgc/wm5.py",
        "configs/dgc/bf16mem.py", "configs/dgc/int8.py",
        "configs/dgc/packidx.py"),
    "resnet20_wm5_autotune": ("configs/cifar/resnet20.py",
                              "configs/dgc/wm5.py", "configs/autotune.py"),
}


@pytest.mark.parametrize("recipe", sorted(STACKS))
def test_stacked_recipes_match_the_config_files(recipe, monkeypatch):
    """Every value the port reads, for each of the reference's other
    recipes: the dense baselines (stock ``sgd``, no compression) and the
    DGC variants (warm-up, its coefficients, momentum masking, the
    schedule)."""
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(*STACKS[recipe])
        c, t = configs, tconfigs.RECIPES[recipe]()
        tr, ctr = t.train, c.train
        assert t.seed == c.seed and tr.dgc == ctr.dgc
        for k in ("root", "num_classes", "image_size"):
            assert t.dataset[k] == c.dataset[k], k
        assert t.model.name == c.model.callable.__name__
        assert t.model.num_classes == c.model.num_classes
        assert t.model.zero_init_residual == c.model.get(
            "zero_init_residual", False)
        assert t.model.dtype == np.dtype(c.model.get("dtype",
                                                     jnp.float32)).name
        for k in ("num_epochs", "batch_size", "warmup_lr_epochs",
                  "schedule_lr_per_epoch"):
            assert tr[k] == ctr[k], k
        assert tr.optimize_bn_separately == ctr.get(
            "optimize_bn_separately", False)
        assert tr.num_batches_per_step == ctr.get("num_batches_per_step", 1)
        sched = ctr.scheduler.callable.__name__
        assert sched == f"{tr.scheduler.name}_schedule"
        for k in tr.scheduler:
            if k != "name":
                assert tr.scheduler[k] == ctr.scheduler[k], k
        assert ctr.optimizer.callable.__name__ == (
            "dgc_sgd" if tr.dgc else "sgd")
        for k in ("lr", "momentum", "weight_decay"):
            assert tr.optimizer[k] == ctr.optimizer[k], k
        assert tr.optimizer.nesterov == ctr.optimizer.get("nesterov", False)
        assert tr.metric == ctr.metric
        assert {k: m.k for k, m in tr.meters.items()} == {
            k: m.k for k, m in ctr.meters.items()}
        assert all(m.callable.__name__ == "TopKClassMeter"
                   for m in ctr.meters.values())
        cc, tc = ctr.compression, tr.compression
        if not tr.dgc:
            assert cc.callable.__name__ == "NoneCompressor"
            assert tc.name == "none"
            return
        assert cc.callable.__name__ == "DGCCompressor"
        for k in ("compress_ratio", "sample_ratio", "strided_sample",
                  "compress_upper_bound", "compress_lower_bound",
                  "max_adaptation_iters", "resample", "warmup_epochs"):
            assert tc[k] == cc[k], k
        assert tc.warmup_coeff == cc.get("warmup_coeff", None)
        assert tc.memory.momentum == cc.memory.momentum
        assert tc.memory.nesterov == cc.memory.get("nesterov", False)
        assert tc.memory.momentum_masking == cc.memory.get(
            "momentum_masking", True)
        # the wires and the state (the JAX compressor's defaults where the
        # files leave them unset)
        for k, default in (("fp16_values", False), ("int8_values", False),
                           ("int8_error_feedback", True),
                           ("packed_indices", False),
                           ("int32_indices", True)):
            assert tc[k] == cc.get(k, default), k
        assert tc.memory.dtype == cc.memory.get("dtype", None)
        at, cat = tr.get("autotune"), ctr.get("autotune", None)
        assert (at is None) == (cat is None)
        if at is not None:
            assert dict(at) == {k: cat[k] for k in cat}
    finally:
        Config.reset()


def test_recipes_reach_the_trainer_and_the_cli_evaluates(monkeypatch,
                                                         capsys, tmp_path):
    """``momentum_masking=False`` (nm), the warm-up coefficients (wm5o)
    and the dense baseline's optimizer reach the trainer; the CLI prints
    the evaluation before training and after each epoch, with the best
    top-1, and ``--evaluate`` only evaluates. (The CLI keeps its
    checkpoints under ``runs/`` in the working directory.)"""
    monkeypatch.chdir(tmp_path)
    seen = []

    class Spy(ttrain.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)
    monkeypatch.setattr(ttrain, "Trainer", Spy)
    common = ["--device", "cpu", "--world", "2", "--batch-size", "4",
              "--synthetic-size", "64"]
    assert ttrain.main(common + ["--config", "resnet20_wm5_nm",
                                 "--evaluate"]) == []
    out = capsys.readouterr().out
    assert "[acc/test_top1] = " in out and "[acc/test_top5] = " in out
    assert ttrain.main(common + ["--config", "resnet20", "--epochs", "1",
                                 "--steps", "1"])
    out = capsys.readouterr().out
    assert out.count("[acc/test_top1] = ") == 2
    assert "[acc/test_top1_best] = " in out
    ttrain.main(common + ["--config", "resnet20_wm5o", "--epochs", "0"])
    nm, dense, wm5o = seen
    assert nm.compression.memory.momentum_masking is False
    assert nm.dist.optimizer.__class__.__name__ == "DGCSGD"
    assert dense.dist.optimizer.__class__.__name__ == "SGD"
    assert dense.setup.engine.payload_size == 0
    assert dense.state.memory == [{}, {}]
    assert wm5o.compression.warmup_coeff == [1, 1, 1, 1, 1]


def test_cli_autotune_plans_and_refuses_without_dgc(monkeypatch, capsys,
                                                    tmp_path):
    """``--autotune``: the initial plan printed, a refit at each epoch
    boundary written to ``<save_path>/fabric.json``, the engine rebuilt
    only when the plan's key changed; the wire recipes reach the
    compressor; refused without DGC."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DGC_FABRIC", raising=False)
    seen = []

    class Spy(ttrain.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)
    monkeypatch.setattr(ttrain, "Trainer", Spy)
    common = ["--device", "cpu", "--world", "2", "--batch-size", "4",
              "--synthetic-size", "64"]
    with pytest.raises(SystemExit, match="DGC"):
        ttrain.main(common + ["--config", "resnet20", "--autotune"])
    assert ttrain.main(common + ["--config", "resnet20_wm5", "--autotune",
                                 "--epochs", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert "[autotune] fabric autotuned-32x25GbE" in out and "-> plan [" in out
    assert out.count("[autotune] refit") == 2
    (trainer,) = seen
    at = trainer.autotuner
    assert at.refit_count == 2 and len(at.points) == 4
    assert trainer.setup.engine.plan is not None
    # a replan whose key changed rebuilds the engine at the next epoch
    # only, with the memory carried
    mem = trainer.state.memory
    pending = trainer.setup.engine.regimes != at.plan.regimes
    assert trainer._plan_pending == pending
    trainer.run_epoch(2, 1)
    assert trainer.setup.engine.regimes == at.plan.regimes
    assert not trainer._plan_pending
    assert [m.keys() for m in trainer.state.memory] == [m.keys()
                                                          for m in mem]
    path = tmp_path / "runs" / "cifar.resnet20+dgc.wm5.np2" / "fabric.json"
    fab = json.loads(path.read_text())
    assert fab["schema"] == "dgc-fabric" and fab["provenance"]["refit"] == 2
    ttrain.main(common + ["--config", "resnet20_wm5_int8_packidx",
                          "--epochs", "0"])
    ttrain.main(common + ["--config", "resnet20_wm5_fp16", "--epochs", "0"])
    i8, f16 = seen[1:]
    assert i8.compression.int8_values and i8.compression.packed_indices
    assert i8.setup.engine.regimes[0] == "int8_packed"
    assert f16.setup.engine.regimes[0] == "fp16"


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


@pytest.mark.parametrize("kw", [dict(checksum=True, int8_values=True),
                                dict(plan=("gossip_ring",))])
def test_unported_compressor_options_raise(kw):
    """Options whose code paths the flat engine does not carry (the gossip
    regimes, ROADMAP.md queue 1 item 8; the payload checksum over the int8
    wire, whose scales it would not cover — the reference refuses it too)
    are refused, not silently run as the default path, at a compressed
    ratio and at a dense one (whose engine has no bucket: an empty plan,
    no payload)."""
    kw = dict(kw)
    plan = kw.pop("plan", None)
    for coeff in (None, [1, 1, 1, 1, 1]):
        comp = DGCCompressor(0.001, warmup_epochs=5, warmup_coeff=coeff,
                             **kw)
        comp.initialize([("w", (64, 64))])
        comp.warmup_compress_ratio(0)
        layout = ParamLayout({"w": (64, 64), "b": (64,)}, ["w"])
        if coeff is not None and "checksum" in kw:
            # a dense epoch sends no payload: nothing to checksum
            assert not FlatDGCEngine(comp, layout, plan=plan).checksum
            continue
        with pytest.raises(ValueError, match="item 8|int8_values"):
            FlatDGCEngine(comp, layout, plan=plan)


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
