"""The two-tier exchange against the JAX package (test_hierarchical.py's
oracles), 2 nodes x 4 local workers.

The port's ``LocalComm(8).split(4)`` against the JAX engine run op by op
under two nested ``jax.vmap`` axes (``"hosts"`` outside, ``"local"``
inside), which lowers the node ``psum`` and the cross ``all_gather`` to the
same sums in the same order as the port's groups. Gradients are quantized
to multiples of 2**-12 (|g| <= 4), so the node sums and their divide by 4
are exact: the exchange, the memory and the transmit record are bitwise
the JAX engine's, apart from coordinates that several nodes sent (their
sums within f32 rounding, rtol 1e-6, as test_torch_engine.py has it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer
from dgc_tpu import dgc_sgd as jax_dgc_sgd
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.base import Compression as TCompression
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm

H, L, W = 2, 4, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    rng = np.random.RandomState(0)
    return {
        "conv1": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
        "conv2": {"kernel": rng.randn(3, 3, 8, 8).astype(np.float32)},
        "dense": {"kernel": rng.randn(32, 10).astype(np.float32),
                  "bias": rng.randn(10).astype(np.float32)},
    }


def _quantized(rng, shape):
    x = np.clip(rng.randn(*shape), -4, 4)
    return (np.round(x * 4096) / 4096).astype(np.float32)


def _engines(params, ratio=0.05, **kw):
    named = jax_named_flatten(params)[0]
    jc = DGCCompressor(ratio, memory=DGCSGDMemory(momentum=0.9),
                       sample_ratio=1.0, **kw)
    tc = tdgc.DGCCompressor(ratio, memory=TMemory(momentum=0.9),
                            sample_ratio=1.0, **kw)
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jd = DistributedOptimizer(jax_dgc_sgd(0.1, momentum=0.9), jc,
                              world_size=W, local_axis_name="local",
                              local_size=L, axis_name="hosts")
    td = TDist(dgc_sgd(0.1, momentum=0.9), tc, LocalComm(W), local_size=L)
    return jd, td, jd.make_flat(params)[1], td.make_flat(params)[1]


def _jax_two_tier(engine, op="average"):
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("hosts"))
        return engine.exchange(fg, mem, key, "hosts", H, op=op,
                               local_axis="local", local_size=L)
    inner = jax.vmap(worker, in_axes=(0, 0, None), axis_name="local")
    return jax.vmap(inner, in_axes=(0, 0, None), axis_name="hosts")


def _padded(layout, g):
    data = np.zeros_like(g)
    for n in layout.names:
        o, s = layout.offsets[n], layout.sizes[n]
        data[:, o:o + s] = g[:, o:o + s]
    return data


def _stack_mem(mem):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (H, L) + x.shape),
                        mem)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_exchange(te, gw, touts, jout, sent_idx=None):
    """Bitwise but at coordinates several nodes sent (rtol 1e-6)."""
    jo = np.asarray(jout).reshape(W, -1)
    dup = np.zeros(jo.shape[1], bool)
    if sent_idx is not None:
        real = sent_idx[sent_idx != te.layout.sentinel]
        u, c = np.unique(real, return_counts=True)
        dup[u[c > 1]] = True
    for w in range(W):
        got = touts[w].numpy()
        np.testing.assert_array_equal(_bits(got[~dup]), _bits(jo[w][~dup]))
        np.testing.assert_allclose(got[dup], jo[w][dup], rtol=1e-6)


@pytest.mark.parametrize("op", ["average", "sum"])
def test_two_tier_engine_matches_jax(op):
    """Three exchanges of distinct per-worker gradients: every worker's
    result, its memory and its transmit record equal the JAX two-tier
    engine's; a node's workers hold the same memory."""
    params = _params()
    jd, td, je, te = _engines(params)
    assert td.num_nodes == jd.num_nodes == H
    rng = np.random.RandomState(1)
    jmem = _stack_mem(je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    for step in range(3):
        gw = _padded(te.layout, _quantized(rng, (W, te.layout.total)))
        key = jax.random.PRNGKey(step)
        jout, jmem = _jax_two_tier(je, op)(
            jnp.asarray(gw.reshape(H, L, -1)), jmem, key)
        phases = [te.draw_phases(torch.Generator()) for _ in range(W)]
        touts = te.exchange([torch.from_numpy(g) for g in gw], tmems,
                            phases, td.cross_comm, op=op,
                            local_comm=td.local_comm)
        _assert_exchange(te, gw, touts, jout)
        for w in range(W):
            for k in tmems[w]:
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].numpy()),
                    _bits(np.asarray(jmem[k])[w // L, w % L]),
                    err_msg=f"step {step} {k}")
                np.testing.assert_array_equal(
                    tmems[w][k].numpy(), tmems[(w // L) * L][k].numpy())


def test_two_tier_dense_tail_averages_all_workers():
    """The dense tail of the first step (zero memory) is the mean over all
    8 workers; under ``"sum"`` the sum (the JAX test's oracle)."""
    params = _params()
    _, td, _, te = _engines(params)
    gw = _quantized(np.random.RandomState(2), (W, te.layout.total))
    o, s = te.layout.offsets["dense/bias"], te.layout.sizes["dense/bias"]
    for op, want in (("average", gw[:, o:o + s].mean(0)),
                     ("sum", gw[:, o:o + s].sum(0))):
        out = te.exchange([torch.from_numpy(g) for g in gw],
                          [te.init_memory("cpu") for _ in range(W)],
                          [te.draw_phases(torch.Generator())] * W,
                          td.cross_comm, op=op, local_comm=td.local_comm)
        np.testing.assert_allclose(out[0].numpy()[o:o + s], want,
                                   rtol=1e-6, atol=1e-6)


def test_two_tier_per_tensor_path_matches_flat_engine():
    """``DistributedOptimizer.exchange`` (per tensor) under two tiers
    against the flat engine's two-tier exchange, in the port (rtol 1e-5 /
    atol 1e-6, test_torch_per_tensor.py's per-tensor == flat tolerance),
    and the per-tensor result against the JAX per-tensor two-tier
    exchange run op by op."""
    params = _params()
    jd, td, je, te = _engines(params)
    named = jax_named_flatten(params)[0]
    rng = np.random.RandomState(3)
    gw = {n: _quantized(rng, (W,) + p.shape) for n, p in named.items()}
    lay = te.layout
    flat = np.stack([lay.flatten({n: torch.from_numpy(gw[n][w])
                                  for n in named}).numpy()
                     for w in range(W)])
    pt_grads = [{n: torch.from_numpy(gw[n][w]) for n in named}
                for w in range(W)]
    mems = [td.init_memory({n: torch.from_numpy(p) for n, p in
                            named.items()}) for _ in range(W)]
    phases = [td.compressor.draw_phases(torch.Generator()) for _ in range(W)]
    outs, _ = td.exchange(pt_grads, mems, phases)
    touts = te.exchange([torch.from_numpy(g) for g in flat],
                        [te.init_memory("cpu") for _ in range(W)],
                        [te.draw_phases(torch.Generator())] * W,
                        td.cross_comm, local_comm=td.local_comm)
    got = lay.unflatten_named(touts[0])
    for n in named:
        np.testing.assert_allclose(outs[0][n].numpy().reshape(-1),
                                   got[n].numpy().reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        for w in range(1, W):
            np.testing.assert_array_equal(outs[w][n].numpy(),
                                          outs[0][n].numpy())

    def worker(g, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("hosts"))
        return jd.exchange(g, mem, key)
    f = jax.vmap(jax.vmap(worker, in_axes=(0, 0, None), axis_name="local"),
                 in_axes=(0, 0, None), axis_name="hosts")
    jmem = _stack_mem(jd.init_memory(params))
    jout, _ = f({n: {k: jnp.asarray(gw[f"{n}/{k}"].reshape(
        (H, L) + gw[f"{n}/{k}"].shape[1:])) for k in params[n]}
        for n in params}, jmem, jax.random.PRNGKey(0))
    for n in named:
        a, k = n.split("/")
        np.testing.assert_allclose(
            outs[0][n].numpy(), np.asarray(jout[a][k])[0, 0],
            rtol=1e-6, atol=1e-7, err_msg=n)


def test_two_tier_dense_fp16_wire_divides_before_cast():
    """``FlatDenseExchange`` under two tiers divides the node sum before
    the fp16 wire cast: 4 x 30000 overflows fp16, the node mean does not."""
    params = _params()
    layout = tflat.ParamLayout(params)
    engine = tflat.FlatDenseExchange(TCompression.fp16(), layout)
    local, cross = LocalComm(W).split(L)
    g = [torch.full((layout.total,), 30000.0) for _ in range(W)]
    out = engine.exchange(g, [{}] * W, None, cross, local_comm=local)
    for o in out:
        assert torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), 30000.0)


def test_two_tier_validation_and_groups():
    """The JAX optimizer's refusals, and the groups ``split`` makes."""
    params = _params()
    comp = tdgc.DGCCompressor(0.05)
    with pytest.raises(ValueError, match="local_size"):
        TDist(dgc_sgd(0.1), comp, LocalComm(W), local_size=3)
    with pytest.raises(ValueError, match="local_size"):
        TDist(dgc_sgd(0.1), comp, LocalComm(W), local_size=0)
    td = TDist(dgc_sgd(0.1), comp, LocalComm(W), local_size=L)
    assert (td.num_nodes, td.local_comm.world, td.cross_comm.world) == (
        H, L, H)
    assert td.local_comm.ranks == (0, 1, 2, 3) * 2
    assert td.cross_comm.ranks == (0,) * 4 + (1,) * 4
    xs = [torch.tensor([float(r)]) for r in range(W)]
    np.testing.assert_array_equal(
        [float(t) for t in td.local_comm.all_reduce(xs)],
        [6.0] * 4 + [22.0] * 4)
    np.testing.assert_array_equal(
        td.cross_comm.all_gather(xs)[5].reshape(-1).numpy(), [1.0, 5.0])
    assert [float(t) for t in td.cross_comm.swap(xs, 1)] == [
        4, 5, 6, 7, 0, 1, 2, 3]
    del params


def test_two_tier_train_step_tracks_nbps_simulation():
    """The two-tier step (2 nodes x 4, batch 4 a worker) against the
    reference's simulated form: flat DGC over 2 workers with
    ``num_batches_per_step=4`` on the same data — both run DGC over the
    same two node gradients; the losses and parameters agree within the
    JAX test's tolerance (rtol 1e-4: the node mean and the micro-batch
    sum add in other orders). ResNet-20 at the epoch-5 ratio, the
    epoch's two steps."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.train import Trainer

    def trainer(two_tier):
        cfg = configs.resnet20_wm5()
        cfg.dataset.synthetic_size = 64
        cfg.train.batch_size = 4
        if two_tier:
            cfg.train.num_local_workers = L
            return Trainer(cfg, LocalComm(W), "cpu")
        cfg.train.num_batches_per_step = L
        return Trainer(cfg, LocalComm(H), "cpu")
    a, b = trainer(True), trainer(False)
    assert a.global_batch == b.global_batch == 32
    assert a.topology["num_local_workers"] == L
    # a node's workers draw as the flat run's worker of that index
    assert [g.initial_seed() for g in a.gens] == [
        g.initial_seed() for g in b.gens for _ in range(L)]
    # past the learning-rate warm-up, whose factor depends on the world
    for t in (a, b):
        t.state.opt_state = t.state.opt_state._replace(
            count=5 * t.steps_per_epoch)
    la = [float(x) for x in a.run_epoch(5, 3)]
    lb = [float(x) for x in b.run_epoch(5, 3)]
    np.testing.assert_allclose(la, lb, rtol=1e-4)
    np.testing.assert_allclose(a.state.params.detach().numpy(),
                               b.state.params.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
