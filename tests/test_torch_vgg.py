"""VGG-16-BN, dropout and bf16 compute in the port against the JAX package,
on the CPU, at a narrow VGG: ``cfg=(8, "M", 16, "M")`` at 28x28 with 10
classes (20,039,082 parameters). Its 4096-wide classifier keeps VGG's
wide buckets: fc2 ([4096, 4096]) split into 4 segment rows of 4,194,304,
fc1 ([784, 4096]) one row of 3,276,800, both on the 3-D fallback at the
epoch-1 ratio and on the segment path at epoch 5.

* The model: flax's parameter names and shapes (full VGG-16 too), the
  forward from carried weights in training and evaluation mode (logits
  and BatchNorm statistics within rtol 1e-4 / atol 1e-5 of flax: the
  convolutions and matmuls sum in other orders, and flax's BatchNorm
  variance is one-pass), the average pool to 7x7 of a 56x56 input, and
  the refusal of a size that does not reach a multiple of 7.
* Dropout: ``where(uniform < keep, x / keep, 0)`` bitwise flax's formula
  on the same mask; the same generator state gives the same masks;
  evaluation draws none; a training forward without a generator raises.
* bf16 compute: the worker's gradient f32, every element a widened bf16
  value.
* Resume with the dropout generators: a run interrupted by a checkpoint
  equal to the uninterrupted one, bitwise.

The train steps against the JAX package are ``test_torch_vgg_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.models import vgg16_bn as flax_vgg16_bn
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.models import param_tree, stats_tree, vgg
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import checkpoint, step as tstep
from dgc_tpu_torch.utils.pytree import named_flatten

W = 2
NARROW = (8, "M", 16, "M")
SIDE, CLASSES = 28, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: the files run beside
    other test workers, where several threads a worker oversubscribe the
    cores. Every comparison stays within this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax(dtype=jnp.float32, **kw):
    return flax_vgg16_bn(num_classes=CLASSES, cfg=NARROW, dropout_rate=0.0,
                         dtype=dtype, **kw)


@pytest.fixture(scope="module")
def variables():
    v = jax.device_get(_flax().init(jax.random.PRNGKey(42),
                                    jnp.zeros((1, SIDE, SIDE, 3)),
                                    train=True))
    rng = np.random.RandomState(1)
    # non-trivial BatchNorm scales and biases
    v["params"] = jax.tree.map(
        lambda a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                   if a.ndim == 1 else a), v["params"])
    return v


def _shapes(tree):
    return {n: tuple(getattr(a, "shape", a)) for n, a in
            jax_named_flatten(tree)[0].items()}


def test_vgg16_names_and_shapes_match_flax():
    tree = jax.eval_shape(lambda: flax_vgg16_bn().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    with torch.device("meta"):
        model = vgg.vgg16_bn()
    got = {n: tuple(t.shape) for n, t in
           named_flatten(param_tree(model)).items()}
    assert got == _shapes(tree["params"])
    assert sum(int(np.prod(s)) for s in got.values()) == 138_365_992
    assert ({n: tuple(t.shape) for n, t in
             named_flatten(stats_tree(model)).items()}
            == _shapes(tree["batch_stats"]))


def _port(v, dtype=torch.float32):
    model = vgg.VGG(NARROW, CLASSES, dropout_rate=0.0, dtype=dtype)
    layout = ParamLayout(param_tree(model))
    stats_layout = ParamLayout(stats_tree(model))
    fp, fs = carry_variables(v["params"], v["batch_stats"], layout,
                             stats_layout)
    return model, layout, stats_layout, fp, fs


def test_narrow_vgg_layout(variables):
    model, layout, *_ = _port(variables)
    assert layout.num_params == 20_039_082
    comp = tconfigs.vgg16_bn_wm5().train.compression
    from dgc_tpu_torch.compression.dgc import DGCCompressor as TComp
    from dgc_tpu_torch.compression.flat import FlatDGCEngine
    c = TComp(comp.compress_ratio, sample_ratio=comp.sample_ratio,
              warmup_epochs=comp.warmup_epochs)
    c.initialize((n.replace(".", "/"), tuple(p.shape))
                 for n, p in model.named_parameters() if p.dim() > 1)
    for epoch, want in ((1, "_sel3d"), (5, "_seg")):
        c.warmup_compress_ratio(epoch)
        eng = FlatDGCEngine(c, ParamLayout.for_compressor(
            param_tree(model), c))
        geo = [(b.rows, b.cols) for b in eng.buckets]
        assert geo[:2] == [(4, 4_194_304), (1, 3_276_800)]
        assert getattr(eng, want)[:2] == [True, True]


@pytest.mark.parametrize("side", [SIDE, 56])
def test_forward_matches_flax(variables, side):
    """Training mode (logits and the updated statistics) and evaluation
    mode; at 56x56 the features are average-pooled to 7x7."""
    model, layout, stats_layout, fp, fs = _port(variables)
    x = np.random.RandomState(side).randn(4, side, side, 3).astype(
        np.float32)
    fm = _flax()
    jl, upd = fm.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    je = fm.apply(variables, jnp.asarray(x), train=False)
    stats = fs.clone()
    binding = {**tstep._binding(layout, fp), **tstep._binding(stats_layout,
                                                              stats)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        tl = torch.func.functional_call(model, binding, (xt,),
                                        {"train": True})
        te = torch.func.functional_call(
            model, {**tstep._binding(layout, fp),
                    **tstep._binding(stats_layout, fs)}, (xt,),
            {"train": False})
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-5)
    want_stats = stats_layout.flatten(jax.device_get(upd["batch_stats"]))
    np.testing.assert_allclose(stats.numpy(), want_stats.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_input_that_misses_a_multiple_of_7_raises(variables):
    model = _port(variables)[0]
    with pytest.raises(ValueError, match="multiple of 7"):
        model(torch.zeros(1, 3, 32, 32), train=False)


def test_dropout_is_flax_dropout_from_a_generator():
    x = torch.from_numpy(np.random.RandomState(0).randn(6, 4096).astype(
        np.float32))
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    got = vgg.dropout(x, 0.5, gen)
    gen.set_state(state)
    mask = torch.rand(x.shape, generator=gen) < 0.5
    want = jax.lax.select(jnp.asarray(mask.numpy()),
                          jnp.asarray(x.numpy()) / 0.5,
                          jnp.zeros(x.shape, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.4 < float(mask.float().mean()) < 0.6
    gen.set_state(state)
    np.testing.assert_array_equal(vgg.dropout(x, 0.5, gen).numpy(),
                                  got.numpy())
    # the model: evaluation draws nothing, training needs a generator
    model = vgg.VGG(NARROW, CLASSES)
    xi = torch.zeros(2, 3, SIDE, SIDE)
    gen.set_state(state)
    model(xi, train=False, dropout_generator=gen)
    assert torch.equal(gen.get_state(), state)
    model(xi, train=True, dropout_generator=gen)
    assert not torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        model(xi, train=True)


def _cfg(recipe="vgg16_bn_wm5", batch_size=4, steps=3):
    cfg = tconfigs.RECIPES[recipe]()
    cfg.train.batch_size = batch_size
    cfg.dataset.update(image_size=SIDE, num_classes=CLASSES,
                       synthetic_size=steps * W * batch_size)
    cfg.model.update(num_classes=CLASSES, cfg=NARROW, dropout_rate=0.0)
    return cfg


def test_bf16_worker_grad_is_f32(variables):
    model, layout, stats_layout, fp, fs = _port(variables, torch.bfloat16)
    setup = tstep.FlatSetup(layout, stats_layout, None)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, 3, SIDE, SIDE).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    g, loss = tstep.worker_grad(model, setup, fp, fs.clone(), x, y)
    assert g.dtype == torch.float32 and g.shape == fp.shape
    assert loss.dtype == torch.float32 and torch.isfinite(g).all()
    # every gradient element is a bf16 value: the cast's backward widens
    assert torch.equal(g.to(torch.bfloat16).float(), g)


def test_resume_with_dropout_generators_is_bitwise(tmp_path):
    """Dropout on (0.5): epochs 5 and 6 uninterrupted against epoch 5, a
    save, a fresh ``Trainer`` that restores, and epoch 6 (the card's
    check runs VGG-16 across the 3-D -> segment handover)."""
    def trainer():
        cfg = _cfg(batch_size=2, steps=2)
        cfg.model.dropout_rate = 0.5
        return Trainer(cfg, LocalComm(W), device="cpu")

    a = trainer()
    assert len(a.dropout_gens) == W
    a.run_epoch(5, 1)
    want = [float(x) for x in a.run_epoch(6, 1)]
    b = trainer()
    b.run_epoch(5, 1)
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    b.save_checkpoint(ckpt, 5, {"acc/test_top1": 0.0})
    rep, workers = checkpoint.state_tensors(b.state, b.gens, b.comm.ranks,
                                            dropout_gens=b.dropout_gens)
    assert all("dropout_generator" in d for d in workers.values())
    c = trainer()
    c.dropout_gens[0].manual_seed(123)
    assert c.restore_checkpoint(ckpt)[0] == 5
    for g, h in zip(c.dropout_gens, b.dropout_gens):
        assert torch.equal(g.get_state(), h.get_state())
    got = [float(x) for x in c.run_epoch(6, 1)]
    assert got == want
    assert torch.equal(c.state.params, a.state.params)
    for ma, mc in zip(a.state.memory, c.state.memory):
        for k in ma:
            assert torch.equal(ma[k], mc[k]), k
