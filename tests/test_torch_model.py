"""The port's CIFAR ResNet against the flax model, from the same weights
(carried with ``dgc_tpu_torch.interop``) on the same numpy batch.

Logits and flat gradients agree within rtol 1e-4 / atol 1e-5, not
bitwise: PyTorch's and XLA's CPU convolutions sum in different orders, and
flax normalises with the one-pass variance E[x^2] - E[x]^2. The BatchNorm
running statistics (flax's biased-variance update) agree within the same
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgc_tpu.compression.flat import ParamLayout as JaxLayout
from dgc_tpu.models.resnet_cifar import CifarResNet as FlaxResNet
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.interop import carry_variables, export_variables
from dgc_tpu_torch.models import param_tree, resnet_cifar, stats_tree
from dgc_tpu_torch.training.step import FlatSetup, worker_grad


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGES = (1, 1, 1)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def case():
    flax_model = FlaxResNet(stage_sizes=STAGES)
    v = jax.device_get(flax_model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=True))
    rng = np.random.RandomState(0)
    images = rng.randn(8, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 8).astype(np.int32)
    model = resnet_cifar.CifarResNet(STAGES)
    layout = ParamLayout(param_tree(model))
    stats_layout = ParamLayout(stats_tree(model))
    flat_p, flat_s = carry_variables(v["params"], v["batch_stats"], layout,
                                     stats_layout)
    return dict(flax=flax_model, v=v, images=images, labels=labels,
                model=model, setup=FlatSetup(layout, stats_layout, None),
                flat_p=flat_p, flat_s=flat_s)


def _flax_loss(model, v, images, labels):
    def loss_fn(params):
        logits, upd = model.apply({"params": params,
                                   "batch_stats": v["batch_stats"]},
                                  images, train=True,
                                  mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, (logits, upd["batch_stats"])
    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(v["params"])
    return loss, logits, stats, grads


def test_carry_round_trips(case):
    params, stats = export_variables(case["flat_p"], case["flat_s"],
                                     case["setup"].layout,
                                     case["setup"].stats_layout)
    for got, want in ((params, case["v"]["params"]),
                      (stats, case["v"]["batch_stats"])):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    # the carried buffer is the JAX package's own flat layout, bitwise
    jflat = np.asarray(JaxLayout(case["v"]["params"]).flatten(
        case["v"]["params"]))
    np.testing.assert_array_equal(case["flat_p"].numpy().view(np.int32),
                                  jflat.view(np.int32))


def test_forward_backward_matches_flax(case):
    loss, logits, new_stats, grads = _flax_loss(
        case["flax"], case["v"], case["images"], case["labels"])
    setup = case["setup"]
    stats = case["flat_s"].clone()
    x = torch.from_numpy(case["images"]).permute(0, 3, 1, 2)
    y = torch.from_numpy(case["labels"]).long()
    g, tloss = worker_grad(case["model"], setup, case["flat_p"], stats, x, y)
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    np.testing.assert_allclose(
        g.numpy(), setup.layout.flatten(grads).numpy(), **TOL)
    np.testing.assert_allclose(
        stats.numpy(), setup.stats_layout.flatten(new_stats).numpy(), **TOL)
    # the forward itself, on the same binding
    with torch.no_grad():
        binding = {n.replace("/", "."): t for n, t in
                   {**setup.layout.unflatten_named(case["flat_p"]),
                    **setup.stats_layout.unflatten_named(
                        case["flat_s"].clone())}.items()}
        tlogits = torch.func.functional_call(case["model"], binding, (x,),
                                             {"train": True})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)


def test_eval_forward_matches_flax(case):
    v = case["v"]
    rng = np.random.RandomState(1)
    # non-trivial running statistics
    stats = jax.tree.map(
        lambda a: (np.abs(rng.randn(*a.shape)) + 0.5).astype(np.float32),
        v["batch_stats"])
    logits = case["flax"].apply({"params": v["params"],
                                 "batch_stats": stats}, case["images"],
                                train=False)
    setup = case["setup"]
    flat_s = setup.stats_layout.flatten(stats)
    binding = {n.replace("/", "."): t for n, t in
               {**setup.layout.unflatten_named(case["flat_p"]),
                **setup.stats_layout.unflatten_named(flat_s)}.items()}
    x = torch.from_numpy(case["images"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        tlogits = torch.func.functional_call(case["model"], binding, (x,),
                                             {"train": False})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)


def test_init_follows_reference_recipe():
    """Kaiming-normal (fan_out) convolutions and a truncated lecun-normal
    dense kernel, deterministic from the generator."""
    a, b = resnet_cifar.resnet20(), resnet_cifar.resnet20()
    resnet_cifar.init_variables(a, torch.Generator().manual_seed(0))
    resnet_cifar.init_variables(b, torch.Generator().manual_seed(0))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    k = a.BasicBlock_8.Conv_1.kernel.detach()  # HWIO [3, 3, 64, 64]
    assert abs(float(k.std()) - np.sqrt(2.0 / (9 * 64))) < 0.01
    d = a.Dense_0.kernel.detach()              # [64, 10]
    assert float(d.abs().max()) <= 2 * np.sqrt(1 / 64) / .87962566103423978
    assert float(a.BatchNorm_0.scale.detach().min()) == 1.0
