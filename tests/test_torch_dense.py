"""The dense exchanges and the stock SGD against the JAX package.

(a) ``FlatDenseExchange`` (the dense baseline compressors' engine) and the
    DGC engine's all-dense branch (ratio 1, the wm5o warm-up), at W=4 and
    W=3, the second with a pending transmit record that the dense step
    folds into the memory. The JAX side runs op by op (``jax.vmap`` over a
    named axis, no ``jax.jit``). The gradients lie on a 2**-10 grid small
    enough that every cross-worker sum is exact in any order, so the whole
    exchange is held bitwise; the divide by 3 is an IEEE divide on both
    sides.
(b) The stock ``sgd`` (the dense baseline's optimizer) against JAX ``sgd``
    with and without nesterov and the weight-decay mask: bitwise against
    the op-by-op JAX update; within 4 eps (|p| + |g| + |buf|) against the
    jitted one, whose multiply-adds XLA-CPU contracts into FMAs.
(c) The per-tensor exchange at ratio 1 equals the flat engine's dense
    branch (both sum the workers in rank order: bitwise).
(d) Training across the wm5o handover: two ``resnet20_wm5o`` steps at
    epoch 4 (ratio 1) and two at epoch 5 (0.001) at W=2 through the port's
    train step and the JAX package's jitted ``build_train_step``, on the
    same batches, the port given the JAX step's sampling phases and each
    step started from the JAX state: each step's mean loss within rtol
    1e-5, the next mean loss at its updated weights within rtol 1e-3
    (other convolution sum orders, and FMA contraction under jit; see
    the test's docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.compression import Compression as JCompression
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.data import CIFAR as JaxCIFAR
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.models import resnet20
from dgc_tpu.optim import sgd as jax_sgd
from dgc_tpu.training import (build_train_step, cosine_schedule,
                              make_flat_setup, make_flat_state,
                              make_lr_schedule, shard_state)
from dgc_tpu.training import lr as jlr
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.base import Compression
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.interop import carry_opt_state, carry_variables
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.optim.sgd import sgd as t_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.data.sampler import epoch_batches
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import lr as tlr
from dgc_tpu_torch.training.state import TrainState as TorchTrainState
from dgc_tpu_torch.training.step import train_step, worker_grad


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WM5O = [1, 1, 1, 1, 1]


@pytest.fixture(scope="module")
def variables():
    v = resnet20().init(jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v)


def _grid(rng, shape, bits=10):
    """Values on a 2**-bits grid below 2**3: sums of a few are exact (in
    f16 too at ``bits=3``)."""
    return (rng.randint(-8 << bits, 8 << bits, shape)
            / float(1 << bits)).astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _compressors(params, epoch=4, nesterov=False, masking=True):
    kw = dict(sample_ratio=0.01, warmup_epochs=5, warmup_coeff=WM5O)
    mkw = dict(momentum=0.9, nesterov=nesterov, momentum_masking=masking)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(**mkw), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(**mkw), **kw)
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return jc, tc


def test_warmup_coeff_list_gives_each_epoch_its_ratio(variables):
    ratios = []
    for epoch in range(7):
        jc, tc = _compressors(variables["params"], epoch)
        assert tc.compress_ratio == jc.compress_ratio
        ratios.append(tc.compress_ratio)
    assert ratios == [1, 1, 1, 1, 1, 0.001, 0.001]
    for bad in ([1, 1, 1, 1], [1, 1, 1, 1, 1.5], 0.0):
        with pytest.raises(ValueError):
            tdgc.DGCCompressor(0.001, warmup_epochs=5, warmup_coeff=bad)


@pytest.mark.parametrize("world", [4, 3])
def test_flat_dense_exchange_matches_jax(variables, world):
    params = variables["params"]
    for jcomp, tcomp in ((JCompression.none(), Compression.none()),
                         (JCompression.fp16(), Compression.fp16())):
        layout = ParamLayout.for_compressor(params, jcomp)
        je = jcomp.make_flat_exchange(layout)
        te = tcomp.make_flat_exchange(tflat.ParamLayout.for_compressor(
            params, tcomp))
        assert te.payload_size == 0 and te.init_memory("cpu") == {}
        grads = _grid(np.random.RandomState(world), (world, layout.total),
                      bits=3)

        def worker(fg):
            return je.exchange(fg, {}, None, "data", world)[0]
        want = jax.vmap(worker, axis_name="data")(jnp.asarray(grads))
        got = te.exchange([torch.from_numpy(g) for g in grads],
                          [{}] * world, [None] * world, LocalComm(world))
        for w in range(world):
            np.testing.assert_array_equal(_bits(got[w].numpy()),
                                          _bits(want[w]))


def _dense_case(params, world, pending, nesterov, masking):
    """The all-dense branch of both engines on one planted state: random
    momentum and velocity, and with ``pending`` a transmit record left by a
    compressed step. Returns the JAX and port outputs and memories."""
    jc, tc = _compressors(params, 4, nesterov, masking)
    je = FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc))
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(params, tc))
    assert te.dense and te.payload_size == 0
    T, P_ = te.T, te.layout.total
    rng = np.random.RandomState(7 + world)
    mem = {"momentums_c": rng.randn(T), "velocities_c": rng.randn(T),
           "momentums_d": rng.randn(P_ - T),
           "velocities_d": rng.randn(P_ - T)}
    mem = {k: v.astype(np.float32) for k, v in mem.items()}
    words = kernels.num_sent_words(T)
    mem["sent_bits"] = (rng.randint(-2 ** 31, 2 ** 31, words,
                                    dtype=np.int64).astype(np.int32)
                        if pending else np.zeros(words, np.int32))
    grads = _grid(rng, (world, P_))

    def worker(fg, m):
        return je.exchange(fg, m, jax.random.PRNGKey(0), "data", world)
    jmem = {k: jnp.stack([jnp.asarray(v)] * world) for k, v in mem.items()}
    jout, jmem = jax.vmap(worker, axis_name="data")(jnp.asarray(grads), jmem)
    tmems = [{k: torch.from_numpy(v.copy()) for k, v in mem.items()}
             for _ in range(world)]
    tout = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                       [[]] * world, LocalComm(world))
    return jout, jmem, tout, tmems


@pytest.mark.parametrize("world,pending", [(4, False), (3, True)])
@pytest.mark.parametrize("nesterov,masking", [(False, True), (True, False)])
def test_engine_dense_branch_matches_jax(variables, world, pending,
                                         nesterov, masking):
    jout, jmem, tout, tmems = _dense_case(variables["params"], world,
                                          pending, nesterov, masking)
    for w in range(world):
        np.testing.assert_array_equal(_bits(tout[w].numpy()),
                                      _bits(jout[w]))
        for k in ("momentums_c", "velocities_c", "momentums_d",
                  "velocities_d", "sent_bits"):
            np.testing.assert_array_equal(_bits(tmems[w][k].numpy()),
                                          _bits(jmem[k][w]), err_msg=k)
        assert not tmems[w]["sent_bits"].any()
    if pending:
        # the record's coordinates were zeroed in the velocity
        assert int((tmems[0]["velocities_c"] == 0).sum()) > 1000


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_jax(masked, nesterov):
    rng = np.random.RandomState(11)
    n = 4096
    mask = (rng.rand(n) < 0.7).astype(np.float32) if masked else None
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
    sched = jlr.make_lr_schedule(0.2, 2, 3, 5, jlr.cosine_schedule(195))
    tsched = tlr.make_lr_schedule(0.2, 2, 3, 5, tlr.cosine_schedule(195))
    jopt = jax_sgd(sched, weight_decay_mask=(
        None if mask is None else jnp.asarray(mask)), **kw)
    topt = t_sgd(tsched, weight_decay_mask=(
        None if mask is None else torch.from_numpy(mask)), **kw)
    jupd = jax.jit(jopt.update)
    p = rng.randn(n).astype(np.float32)
    jp, tp, kp = jnp.asarray(p), torch.from_numpy(p.copy()), jnp.asarray(p)
    js, ts, ks = jopt.init(jp), topt.init(tp), jopt.init(kp)
    eps = np.finfo(np.float32).eps
    for _ in range(4):
        g = rng.randn(n).astype(np.float32)
        g[:8] = -0.0                     # the + 0.0 of an unmasked update
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        ku, ks = jupd(jnp.asarray(g), ks, kp)
        tu, ts = topt.update(torch.from_numpy(g), ts, tp)
        jp, tp, kp = jp + ju, tp + tu, kp + ku
        np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))
        np.testing.assert_array_equal(_bits(ts.momentum_buffer.numpy()),
                                      _bits(js.momentum_buffer))
        scale = (np.abs(np.asarray(kp)) + np.abs(g)
                 + np.abs(np.asarray(ks.momentum_buffer)))
        assert (np.abs(tp.numpy() - np.asarray(kp)) <= 4 * eps * scale).all()
    assert ts.count == int(js.count)
    carried = carry_opt_state(jax.device_get(js))
    assert carried.count == ts.count
    np.testing.assert_array_equal(carried.momentum_buffer.numpy(),
                                  ts.momentum_buffer.numpy())


def test_per_tensor_at_ratio_one_equals_the_dense_branch(variables):
    params = variables["params"]
    W = 4
    _, tc = _compressors(params, 4)
    layout = tflat.ParamLayout.for_compressor(params, tc)
    engine = tc.make_flat_exchange(layout)
    dist = TDist(t_dgc_sgd(0.1), tc, LocalComm(W))
    rng = np.random.RandomState(5)
    mems_f = [engine.init_memory("cpu") for _ in range(W)]
    mems_p = [dist.init_memory(params) for _ in range(W)]
    for _ in range(2):
        flat = [torch.from_numpy(rng.randn(layout.total).astype(np.float32))
                for _ in range(W)]
        grads = [layout.unflatten_named(f) for f in flat]
        out_f = engine.exchange(flat, mems_f, [[]] * W, LocalComm(W))
        out_p, mems_p = dist.exchange(grads, mems_p, [{}] * W)
        for w in range(W):
            want = layout.unflatten_named(out_f[w])
            for n in layout.names:
                np.testing.assert_array_equal(_bits(out_p[w][n].numpy()),
                                              _bits(want[n].numpy()), n)
    full = engine.memory_state_dict(mems_f[0])
    for n in layout.names:
        np.testing.assert_array_equal(
            _bits(mems_p[0]["momentums"][n].numpy()),
            _bits(full["momentums"][n].numpy()), n)


def _phases(engine, key):
    """The uniforms the JAX engine's ``_sample_rows`` draws from ``key``."""
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def _jax_wm5o_steps(variables, cfg, schedule, W):
    """The JAX package's own flat train step on a W-device mesh over
    ``schedule`` ``[(epoch, steps)]``, the engine rebuilt at each epoch's
    ratio and the state carried. Returns the mean losses, the state before
    every step (on the host) and, per step and worker, the sampling phases
    the step drew."""
    cc, tr = cfg.train.compression, cfg.train
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs,
                         warmup_coeff=cc.warmup_coeff)
    named = jax_named_flatten(variables["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxCIFAR(cfg.dataset.root, 10, 32,
                  synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = W * tr.batch_size
    spe = len(ds) // gb
    dist = DistributedOptimizer(
        dgc_sgd(make_lr_schedule(0.1 * W, W, spe, 5, cosine_schedule(195)),
                momentum=0.9, weight_decay=1e-4), comp, world_size=W)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    state, losses, states, phases = None, [], [], []
    base = jax.random.PRNGKey(cfg.seed)
    for epoch, steps in schedule:
        comp.warmup_compress_ratio(epoch)
        setup = make_flat_setup(variables, dist)
        if state is None:
            state = shard_state(make_flat_state(variables, dist, setup, W),
                                mesh, dist_opt=dist)
        step_fn = build_train_step(resnet20().apply, dist, mesh,
                                   donate=False, flat=setup)
        for b, idx in enumerate(jax_epoch_batches(len(ds), gb, epoch,
                                                  seed=cfg.seed)):
            if b == steps:
                break
            images, labels = ds.get_batch(idx)
            key = jax.random.fold_in(base, 100 * epoch + b)
            states.append(jax.device_get(state))
            state, m = step_fn(state, jnp.asarray(images),
                               jnp.asarray(labels), key)
            losses.append(float(m["loss"]))
            phases += [_phases(setup.engine, jax.random.split(
                jax.random.fold_in(key, w))[1]) for w in range(W)]
    return losses, states, phases


def _carry_flat_state(js, W, step):
    """A JAX flat ``TrainState`` (host) -> the port's."""
    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32 if np.asarray(
            a).dtype == np.float32 else np.asarray(a).dtype))
    return TorchTrainState(
        step=step, params=tensor(js.params),
        opt_state=carry_opt_state(js.opt_state),
        memory=[{k: tensor(v[w]) for k, v in js.memory.items()}
                for w in range(W)],
        batch_stats=[tensor(js.batch_stats[w]) for w in range(W)])


def test_wm5o_handover_tracks_jax(variables):
    """Two steps at epoch 4 (ratio 1, the dense branch) and two at epoch 5
    (0.001, the first reading the dense steps' momentum and an empty
    record). Each step starts from the JAX step's state (weights,
    statistics, optimizer state and flat memory carried over), so each is
    held on its own: its mean loss within rtol 1e-5 of the JAX step's, and
    the loss of the next batch at the port's updated weights within rtol
    1e-3 of the JAX step's next loss. Run freely, four steps drift apart
    by 5e-3 by the fourth loss on either side of the handover, as free
    steps of the default recipe do (the convolutions' sums, flax's one-pass
    BatchNorm variance, and at 0.001 the selection's margin)."""
    W = 2
    cfg = tconfigs.resnet20_wm5o()
    cfg.train.batch_size = 8
    cfg.dataset.synthetic_size = 64
    schedule = [(4, 2), (5, 3)]
    want, states, phases = _jax_wm5o_steps(variables, cfg, schedule, W)
    trainer = Trainer(cfg, LocalComm(W), device="cpu")
    trainer.load_flat(*carry_variables(
        variables["params"], variables["batch_stats"], trainer.setup.layout,
        trainer.setup.stats_layout))
    batches, setups = [], []
    for epoch, steps in schedule:
        trainer.run_epoch(epoch, 0)           # the warm-up and the rebuild
        setups += [trainer.setup] * steps
        batches += [trainer._batches(idx) for _, idx in zip(
            range(steps), epoch_batches(
                len(trainer.dataset["train"]), trainer.global_batch, epoch,
                seed=trainer.seed))]
    assert [s.engine.dense for s in setups] == [True] * 2 + [False] * 3
    for s in range(4):
        setup = setups[s]
        state = _carry_flat_state(states[s], W, s)
        gens = [None] * W
        if not setup.engine.dense:
            mine = phases[s * W:(s + 1) * W]
            setup.engine.draw_phases = lambda gen: mine.pop(0)
        state, loss = train_step(trainer.model, setup, trainer.dist, state,
                                 *batches[s], gens)
        np.testing.assert_allclose(float(loss), want[s], rtol=1e-5)
        xs, ys = batches[s + 1]
        nxt = [worker_grad(trainer.model, setups[s + 1], state.params,
                           state.batch_stats[w].clone(), xs[w], ys[w])[1]
               for w in range(W)]
        np.testing.assert_allclose(float(sum(nxt) / W), want[s + 1],
                                   rtol=1e-3)
        assert setup.engine.dense or not mine   # a draw for each worker


def test_wm5o_handover_memory_matches_jax(variables):
    """The memory the port's ``Trainer`` carries through its engine
    rebuilds, against the JAX engines' exchanges at W=2, bitwise: a
    compressed step (epoch 5, which leaves a pending transmit record), two
    dense steps (epoch 4: the first folds the record into the memory), then
    two compressed steps (the first reading the dense steps' momentum and
    an empty record). The port's engines are the ones ``run_epoch``
    rebuilds at each ratio change and its memory is the Trainer's own
    state, never reloaded; the JAX side runs op by op. At W=2 a coordinate
    both workers send is one IEEE add either way, so the exchanged
    gradients are held bitwise too."""
    W = 2
    cfg = tconfigs.resnet20_wm5o()
    cfg.train.batch_size = 8
    cfg.dataset.synthetic_size = 64
    trainer = Trainer(cfg, LocalComm(W), device="cpu")
    params = variables["params"]
    jc, _ = _compressors(params, 4)
    je = {}
    for epoch in (4, 5):
        jc.warmup_compress_ratio(epoch)
        je[epoch] = FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc))
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je[4].init_memory())
    rng = np.random.RandomState(11)
    rebuilt = []
    for s, epoch in enumerate((5, 4, 4, 5, 5)):
        before = trainer.setup
        trainer.run_epoch(epoch, 0)              # the warm-up and rebuild
        rebuilt.append(trainer.setup is not before)
        te = trainer.setup.engine
        assert te.dense == (epoch == 4) and te.T == je[epoch].T
        grads = rng.randn(W, te.layout.total).astype(np.float32)
        grads[:, te.T:] *= 0.1
        key = jax.random.PRNGKey(s)

        def worker(fg, mem, key, eng=je[epoch]):
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))
            return eng.exchange(fg, mem, key, "data", W)
        jout, jmem = jax.vmap(worker, in_axes=(0, 0, None),
                              axis_name="data")(jnp.asarray(grads), jmem,
                                                key)
        phases = [[] if te.dense else _phases(
            je[epoch], jax.random.fold_in(key, w)) for w in range(W)]
        tout = te.exchange([torch.from_numpy(g) for g in grads],
                           trainer.state.memory, phases, trainer.comm)
        for w in range(W):
            np.testing.assert_array_equal(_bits(tout[w].numpy()),
                                          _bits(jout[w]), f"step {s}")
            for k, v in trainer.state.memory[w].items():
                np.testing.assert_array_equal(
                    _bits(v.numpy()), _bits(jmem[k][w]),
                    err_msg=f"step {s} {k}")
        pending = bool(trainer.state.memory[0]["sent_bits"].any())
        assert pending == (not te.dense), f"step {s}"
    assert rebuilt == [True, True, False, True, False]
