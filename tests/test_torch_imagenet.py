"""The port's ImageNet models and recipes against the JAX package, on
the CPU.

* Recipes: ``resnet50_wm5`` / ``resnet18_wm5`` against the stacked
  ``configs/imagenet/*.py`` + ``configs/dgc/*.py`` files; the multistep
  schedule; the synthetic ImageNet split.
* Models: ResNet-50 and ResNet-18 at full width on 32x32 inputs, from the
  flax weights carried over (bitwise round trip). Loss and
  BatchNorm statistics within rtol 1e-4 / atol 1e-5 as in
  test_torch_model.py (convolutions sum in other orders). Logits within
  1e-4 and the flat gradients within 1e-3 in relative L2 norm, each at
  least as close as flax's to the same step in float64: at 32x32 the last stage
  normalises over 4 values a channel, where flax's one-pass variance
  E[x^2] - E[x]^2 loses digits (ResNet-50: flax 5e-4 from float64 in
  relative L2, the port 7e-5).
* The opaque-view guard: the same gradients with and without it, and the
  same guarded set as the JAX step's.

Training against the JAX train step is in test_torch_imagenet_step.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import ParamLayout as JaxLayout
from dgc_tpu.data import ImageNet as JaxImageNet
from dgc_tpu.models import resnet18 as flax_resnet18
from dgc_tpu.models import resnet20 as flax_resnet20
from dgc_tpu.models import resnet50 as flax_resnet50
from dgc_tpu.training import lr as jlr
from dgc_tpu.utils.config import Config, configs
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.dgc import DGCCompressor as TCompressor
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.data import datasets as tdata
from dgc_tpu_torch.interop import carry_variables, export_variables
from dgc_tpu_torch.models import create, param_tree, stats_tree
from dgc_tpu_torch.models import resnet_imagenet
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import lr as tlr
from dgc_tpu_torch.training.step import FlatSetup, worker_grad
from test_torch_folder import image_folder


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 2
TOL = dict(rtol=1e-4, atol=1e-5)
FLAX = {"resnet18": flax_resnet18, "resnet50": flax_resnet50}


@pytest.fixture(params=[("resnet50_wm5", "configs/imagenet/resnet50.py"),
                        ("resnet18_wm5", "configs/imagenet/resnet18.py")])
def recipe(request, monkeypatch):
    import os
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    Config.reset()
    Config.update_from_modules(request.param[1], "configs/dgc/wm5.py")
    yield configs, tconfigs.RECIPES[request.param[0]]()
    Config.reset()


def test_recipe_values_match_the_config_files(recipe):
    c, t = recipe
    assert t.seed == c.seed
    for k in ("root", "num_classes", "image_size"):
        assert t.dataset[k] == c.dataset[k], k
    assert c.dataset.callable.__name__ == "ImageNet"
    assert t.model.name == c.model.callable.__name__
    assert t.model.num_classes == c.model.num_classes
    assert t.model.zero_init_residual == c.model.zero_init_residual
    for k in ("num_epochs", "batch_size", "warmup_lr_epochs",
              "schedule_lr_per_epoch", "optimize_bn_separately"):
        assert t.train[k] == c.train[k], k
    assert t.train.num_batches_per_step == c.train.get(
        "num_batches_per_step", 1)
    assert c.train.scheduler.callable.__name__ == "multistep_schedule"
    assert t.train.scheduler.milestones == c.train.scheduler.milestones
    assert t.train.scheduler.gamma == c.train.scheduler.gamma
    for k in ("lr", "momentum", "weight_decay"):
        assert t.train.optimizer[k] == c.train.optimizer[k], k
    assert t.train.optimizer.nesterov == c.train.optimizer.get("nesterov",
                                                               False)
    assert c.train.optimizer.callable.__name__ == "dgc_sgd"
    for k in ("compress_ratio", "sample_ratio", "strided_sample",
              "compress_upper_bound", "compress_lower_bound",
              "max_adaptation_iters", "resample", "warmup_epochs"):
        assert t.train.compression[k] == c.train.compression[k], k
    assert (t.train.compression.memory.momentum
            == c.train.compression.memory.momentum)


def test_multistep_schedule_matches_jax():
    ms = [25, 55, 75]
    j, t = jlr.multistep_schedule(ms, 0.1), tlr.multistep_schedule(ms, 0.1)
    for e in (0, 1, 24, 24.5, 25, 54, 55, 74, 75, 89):
        assert np.float32(t(np.float32(e))) == np.asarray(j(jnp.float32(e)))
    kw = dict(scaled_lr=0.0125 * 8, world_size=8, num_steps_per_epoch=7,
              warmup_lr_epochs=5)
    js = jlr.make_lr_schedule(decay=jlr.multistep_schedule(ms, 0.1), **kw)
    ts = tlr.make_lr_schedule(decay=tlr.multistep_schedule(ms, 0.1), **kw)
    for count in range(0, 90 * 7, 5):
        assert np.float32(ts(count)) == np.asarray(js(count)), count


def test_synthetic_imagenet_matches_jax(tmp_path):
    root = str(tmp_path / "absent")
    j = JaxImageNet(root, 1000, 32, synthetic_size=40)
    t = tdata.ImageNet(root, 1000, 32, synthetic_size=40)
    for split in ("train", "test"):
        assert len(t[split]) == len(j[split])
        idx = np.arange(len(j[split]))[::3]
        for a, b in zip(t[split].get_batch(idx), j[split].get_batch(idx)):
            np.testing.assert_array_equal(a, b)
    # a root with train/ and val/ class folders is read, as the JAX
    # package reads it (test_torch_folder.py holds the batches)
    real = image_folder(tmp_path / "real", classes=2, per_class=2)
    t, j = tdata.ImageNet(real, 2, 32), JaxImageNet(real, 2, 32)
    for split in ("train", "test"):
        assert isinstance(t[split], tdata.ImageFolderSplit)
        t[split].workers = j[split].workers = 1
        assert t[split].samples == j[split].samples
        idx = np.arange(len(j[split]))
        for a, b in zip(t[split].get_batch(idx), j[split].get_batch(idx)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ #
# the models                                                         #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def case(request):
    name = request.param
    flax_model = FLAX[name](num_classes=1000, zero_init_residual=True)
    v = jax.device_get(flax_model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)), train=True))
    rng = np.random.RandomState(1)
    # the zero-init residual scales would hide every block's last BN
    v["params"] = jax.tree.map(
        lambda a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                   if a.ndim == 1 else a), v["params"])
    images = rng.randn(4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 1000, 4).astype(np.int32)
    model = getattr(resnet_imagenet, name)(1000, zero_init_residual=True)
    layout = ParamLayout(param_tree(model))
    stats_layout = ParamLayout(stats_tree(model))
    flat_p, flat_s = carry_variables(v["params"], v["batch_stats"], layout,
                                     stats_layout)
    return dict(name=name, flax=flax_model, v=v, images=images,
                labels=labels, model=model,
                setup=FlatSetup(layout, stats_layout, None),
                flat_p=flat_p, flat_s=flat_s)


def test_carry_round_trips(case):
    params, stats = export_variables(case["flat_p"], case["flat_s"],
                                     case["setup"].layout,
                                     case["setup"].stats_layout)
    for got, want in ((params, case["v"]["params"]),
                      (stats, case["v"]["batch_stats"])):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    jflat = np.asarray(JaxLayout(case["v"]["params"]).flatten(
        case["v"]["params"]))
    np.testing.assert_array_equal(case["flat_p"].numpy().view(np.int32),
                                  jflat.view(np.int32))
    with pytest.raises(ValueError):
        carry_variables(case["v"]["params"], {}, case["setup"].layout,
                        case["setup"].stats_layout)


def test_forward_backward_matches_flax(case):
    v = case["v"]

    def loss_fn(params):
        logits, upd = case["flax"].apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            case["images"], train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, case["labels"]).mean()
        return loss, (logits, upd["batch_stats"])
    (loss, (logits, new_stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(v["params"])
    setup = case["setup"]
    stats = case["flat_s"].clone()
    x = torch.from_numpy(case["images"]).permute(0, 3, 1, 2)
    y = torch.from_numpy(case["labels"]).long()
    g, tloss = worker_grad(case["model"], setup, case["flat_p"], stats, x, y)
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    # the same step in float64
    f64 = case["flat_p"].double().requires_grad_(True)
    binding = {n.replace("/", "."): t for n, t in
               {**setup.layout.unflatten_named(f64),
                **setup.stats_layout.unflatten_named(
                    case["flat_s"].double())}.items()}
    model64 = copy.deepcopy(case["model"]).double()
    logits64 = torch.func.functional_call(model64, binding, (x.double(),),
                                          {"train": True})
    F.cross_entropy(logits64, y).backward()
    g64 = f64.grad.numpy()
    want = setup.layout.flatten(grads).numpy()

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(g.numpy(), want) <= 1e-3
    assert rel(g.numpy(), g64) <= rel(want, g64)
    np.testing.assert_allclose(
        stats.numpy(), setup.stats_layout.flatten(new_stats).numpy(), **TOL)
    with torch.no_grad():
        binding = {n.replace("/", "."): t for n, t in
                   {**setup.layout.unflatten_named(case["flat_p"]),
                    **setup.stats_layout.unflatten_named(
                        case["flat_s"].clone())}.items()}
        tlogits = torch.func.functional_call(case["model"], binding, (x,),
                                             {"train": True})
    assert rel(tlogits.numpy(), np.asarray(logits)) <= 1e-4
    assert rel(tlogits.numpy(), logits64.detach().numpy()) <= rel(
        np.asarray(logits), logits64.detach().numpy())


def test_zero_init_residual_and_names():
    """Flax's module names, and a zero scale on each block's last
    residual-branch BatchNorm."""
    x = jnp.zeros((1, 32, 32, 3))
    for name in ("resnet18", "resnet50"):
        model = create(name, 1000, torch.Generator().manual_seed(0),
                       zero_init_residual=True)
        shapes = jax.eval_shape(lambda: FLAX[name](
            zero_init_residual=True).init(jax.random.PRNGKey(0), x,
                                          train=True))
        for tree, ttree in ((shapes["params"], param_tree(model)),
                            (shapes["batch_stats"], stats_tree(model))):
            want = {n: a.shape for n, a in
                    jax_named_flatten(tree)[0].items()}
            got = {n: tuple(a.shape) for n, a in
                   jax_named_flatten(ttree)[0].items()}
            assert got == want
        last = "BatchNorm_2" if name == "resnet50" else "BatchNorm_1"
        for n, p in model.named_parameters():
            if n.endswith(f"{last}.scale") and n.count(".") == 2:
                assert float(p.detach().abs().max()) == 0.0, n
            elif n.endswith(".scale"):
                assert float(p.detach().min()) == 1.0, n


# ------------------------------------------------------------------ #
# the opaque-view guard                                              #
# ------------------------------------------------------------------ #

def _compressed_layouts(tree):
    comp_names = [n for n, a in jax_named_flatten(tree)[0].items()
                  if len(a.shape) > 1]
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9))
    jc.initialize((n, jax_named_flatten(tree)[0][n]) for n in comp_names)
    tc = TCompressor(0.001)
    tc.initialize((n, jax_named_flatten(tree)[0][n].shape)
                  for n in comp_names)
    return (JaxLayout.for_compressor(tree, jc),
            ParamLayout.for_compressor(tree, tc))


def test_guarded_set_matches_jax():
    x32 = jnp.zeros((1, 32, 32, 3))
    want = {"resnet20": {"BasicBlock_3/Conv_2/kernel",
                         "BasicBlock_6/Conv_2/kernel"},
            "resnet50": {"Bottleneck_0/Conv_0/kernel"}}
    for name, fn in (("resnet20", flax_resnet20), ("resnet50",
                                                   flax_resnet50)):
        tree = jax.eval_shape(lambda: fn().init(jax.random.PRNGKey(0), x32,
                                                train=True))["params"]
        jl, tl = _compressed_layouts(tree)
        assert tl.convert_hoist_risky() == jl.convert_hoist_risky()
        assert set(tl.convert_hoist_risky()) == want[name]


def test_opaque_guard_keeps_the_gradients(monkeypatch):
    """ResNet-20 binds one guarded weight of each kind; its gradients are
    those of the plain views, and so are the BatchNorm statistics."""
    trainer = Trainer(tconfigs.resnet20_wm5(), LocalComm(1), device="cpu")
    setup = trainer.setup
    risky = setup.layout.convert_hoist_risky()
    kinds = {tflat.kernels.opaque_view_eligible(
        setup.layout.total, setup.layout.offsets[n], setup.layout.sizes[n])
        for n in risky}
    assert kinds == {True, False}
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    params = trainer.state.params
    out = []
    for guarded in (True, False):
        if not guarded:
            monkeypatch.setattr(ParamLayout, "convert_hoist_risky",
                                lambda self: frozenset())
        stats = trainer.state.batch_stats[0].clone()
        g, loss = worker_grad(trainer.model, setup, params, stats, x, y)
        out.append((g, loss, stats))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
