"""The port's per-tensor train step against the JAX package's.

Three per-tensor steps of ResNet-20 at W=2 (``train_step_per_tensor``,
``LocalComm``) against the JAX package's jitted ``build_train_step`` with
``flat=None`` on a 2-device mesh, from the same weights on the same
batches, with the JAX step's strided phases. The JAX step's state is
carried into the port before each step, so each step is held on its own:
its loss within rtol 1e-5, the next batch's loss at its updated weights
within rtol 1e-3 (see the test's docstring for why three free steps are
not held at rtol 1e-3, as tests/test_torch_step.py holds the flat step).
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
from dgc_tpu.training import (TrainState, build_train_step, cosine_schedule,
                              make_lr_schedule, shard_state,
                              with_leading_axis)
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs
from dgc_tpu_torch.data.sampler import epoch_batches
from dgc_tpu_torch.interop import carry_memory, carry_variables
from dgc_tpu_torch.optim.sgd import SGDState
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training.state import TrainState as TorchTrainState
from dgc_tpu_torch.training.step import (make_flat_state,
                                         make_per_tensor_setup,
                                         train_step_per_tensor, worker_grad)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v)


def _small_cfg():
    cfg = configs.resnet20_wm5()
    cfg.train.batch_size = 8
    cfg.dataset.synthetic_size = 64
    return cfg


def _jax_steps(variables, cfg, steps, n_workers):
    """The JAX package's jitted per-tensor step (``flat=None``) on a
    ``n_workers``-device mesh. Returns the mean losses, the state before
    every step and after the last (on the host), and, per step and worker,
    the strided phases the step drew."""
    cc, tr = cfg.train.compression, cfg.train
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs)
    params = variables["params"]
    named = jax_named_flatten(params)[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxCIFAR(cfg.dataset.root, 10, 32,
                  synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = n_workers * tr.batch_size
    spe = len(ds) // gb
    dist = DistributedOptimizer(
        dgc_sgd(make_lr_schedule(0.1 * n_workers, n_workers, spe, 5,
                                 cosine_schedule(195)),
                momentum=0.9, weight_decay=1e-4), comp,
        world_size=n_workers)
    comp.warmup_compress_ratio(0)
    mesh = Mesh(np.array(jax.devices()[:n_workers]), ("data",))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist.init(params),
        memory=with_leading_axis(dist.init_memory(params), n_workers),
        batch_stats=with_leading_axis(variables["batch_stats"], n_workers))
    state = shard_state(state, mesh, dist_opt=dist)
    step_fn = build_train_step(resnet20().apply, dist, mesh, donate=False)
    losses, states, phases = [], [jax.device_get(state)], []
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
        states.append(jax.device_get(state))
        # the step's per-worker sparsify key (training/step.py), then the
        # exchange's per-tensor fold_in
        for w in range(n_workers):
            k = jax.random.split(jax.random.fold_in(key, w))[1]
            phases.append({n: int(jax.random.randint(
                jax.random.fold_in(k, i), (), 0,
                comp.attributes[n].sample_stride, dtype=jnp.int32))
                for i, n in enumerate(named) if n in comp.attributes})
    return losses, states, phases


def _carry_state(js, setup, n_workers, step):
    """A JAX per-tensor ``TrainState`` (host) -> the port's."""
    def worker(tree, w):
        return jax.tree.map(lambda x: x[w], tree)
    params, _ = carry_variables(js.params, worker(js.batch_stats, 0),
                                setup.layout, setup.stats_layout)
    buf = js.opt_state.momentum_buffer
    return TorchTrainState(
        step=step, params=params,
        opt_state=SGDState(int(js.opt_state.count),
                           None if buf is None else setup.layout.flatten(buf)),
        memory=[carry_memory(worker(js.memory, w)) for w in range(n_workers)],
        batch_stats=[setup.stats_layout.flatten(worker(js.batch_stats, w))
                     for w in range(n_workers)])


def _mean_loss(trainer, setup, state, xs, ys):
    """The workers' mean loss at ``state``'s weights (statistics copied,
    so the state is not touched)."""
    losses = [worker_grad(trainer.model, setup, state.params,
                          state.batch_stats[w].clone(), xs[w], ys[w])[1]
              for w in range(len(xs))]
    return float(sum(losses) / len(losses))


def test_per_tensor_steps_track_jax(variables, monkeypatch):
    """Each of three steps starts from the JAX step's state (weights,
    statistics, optimizer state and per-name memory carried over through
    ``interop``), so each step is held on its own: its loss within rtol
    1e-5 of the JAX step's, and the loss of the next batch at the port's
    updated weights within rtol 1e-3 of the JAX step's next loss. Run
    freely, three steps drift 1.3e-3 apart by the third loss: the models'
    gradients differ by their arithmetic (flax's one-pass BatchNorm
    variance, the convolutions' sums; 1e-4 to 1e-2 of an update at a few
    percent of the coordinates), and at the epoch-0 ratio 0.316, with
    thresholds from 1% samples, those differences move the selection's
    margin step after step."""
    n_workers = 2
    cfg = _small_cfg()
    want, states, phases = _jax_steps(variables, cfg, 4, n_workers)
    phases = phases[:3 * n_workers][::-1]
    trainer = Trainer(cfg, LocalComm(n_workers), device="cpu")
    monkeypatch.setattr(trainer.compression, "draw_phases",
                        lambda gen: phases.pop())
    setup = make_per_tensor_setup(trainer.model, trainer.dist)
    assert setup.engine is None
    state = make_flat_state(trainer.model, trainer.dist, setup, "cpu")
    assert all(set(m["velocities"]) == set(setup.layout.names)
               for m in state.memory)
    trainer.compression.warmup_compress_ratio(0)
    assert trainer.compression.compress_ratio == pytest.approx(0.316, 1e-3)
    batches = [trainer._batches(idx) for _, idx in zip(range(4), epoch_batches(
        len(trainer.dataset["train"]), trainer.global_batch, 0,
        seed=trainer.seed))]
    for s in range(3):
        state = _carry_state(states[s], setup, n_workers, s)
        state, loss = train_step_per_tensor(trainer.model, setup,
                                            trainer.dist, state,
                                            *batches[s], trainer.gens)
        assert state.step == s + 1
        np.testing.assert_allclose(float(loss), want[s], rtol=1e-5)
        np.testing.assert_allclose(
            _mean_loss(trainer, setup, state, *batches[s + 1]), want[s + 1],
            rtol=1e-3)
    assert not phases                     # one draw per worker and step
