"""The port's multi-tensor compensate and its ladder counts, on the CPU.

* :func:`kernels.compensate_plan`: the kernel's block-to-element mapping
  (``csrc/compensate.cu``), written out here in Python, covers every
  element of every entry exactly once, each block inside one entry, and
  a table over capacity splits into launches; at n = 0, 1, 3, 4, 5, odd
  view offsets, streams that share no alignment and bf16 state.
* ``fused_compensate_multi_plain`` (what the wrapper runs on CPU tensors)
  against a loop of the JAX package's ``fused_compensate_reference`` /
  ``fused_compensate_masked_reference``: bitwise (a bf16 NaN need only be
  a NaN: PyTorch's CPU cast writes the canonical NaN). Against the jitted
  Pallas kernels in interpret mode, f32 state within 4 eps (|m| + |g| +
  |v|) — XLA-CPU contracts ``momentum * m0 + g`` into an FMA under jit —
  and bf16 state within one bf16 step, finite state only, as
  test_torch_compensate_ladder.py states.
* The per-tensor exchange compensates every compressed tensor of every
  local worker in one batched call, and still equals the JAX package's
  exchange (the W=8 ResNet-20 case of test_torch_per_tensor_exchange.py).
* :func:`kernels.ladder_plan` at the ladder check's shapes, and
  ``ladder_counts_plain`` against the JAX ``ladder_counts_reference`` and
  Pallas kernel at L = 1, 16, 17 and 128 with cols not a multiple of 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import base as tbase
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import memory as tmemory
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from tests.test_torch_compensate_ladder import (_EPS, _assert_same,
                                                _jax_state, _ladder_input,
                                                _sent, _state, _torch_state,
                                                _within_one_bf16_step)
from tests.test_torch_per_tensor_exchange import (  # noqa: F401
    check_case, one_torch_thread, variables)

# ------------------------------------------------------------------ #
# compensate_plan                                                    #
# ------------------------------------------------------------------ #


def _covered(launch, ns):
    """``{entry: element counts}`` as the kernel's blocks cover them: a
    block finds its entry by the last block0[e] <= block, then covers its
    4,096 elements of the entry's body, block 0 also the scalar head and
    the tail. Asserts that no block covers elements outside its entry."""
    cover = {i: np.zeros(ns[i], np.int64) for i in launch.entries}
    tile = tk.COMPENSATE_TILE
    for b in range(launch.block0[-1]):
        e = max(j for j in range(len(launch.entries))
                if launch.block0[j] <= b)
        i, blk, h = launch.entries[e], b - launch.block0[e], launch.head[e]
        n = ns[i]
        if h >= 0:
            nq = (n - h) // 4
            q0, q1 = blk * tile // 4, min((blk + 1) * tile // 4, nq)
            assert q0 < q1 or (blk == 0 and nq == 0), (b, e)
            cover[i][h + 4 * q0:h + 4 * max(q0, q1)] += 1
            if blk == 0:
                cover[i][:h] += 1
                cover[i][h + 4 * nq:] += 1
        else:
            lo, hi = blk * tile, min((blk + 1) * tile, n)
            assert lo < hi, (b, e)
            cover[i][lo:hi] += 1
    return cover


def _table(ns, offsets, state_bytes=4, shifts=None, masked=False):
    shifts = shifts or [0] * len(ns)
    return [((1 << 20) + 4 * o, (2 << 20) + state_bytes * (o + s),
             (3 << 20) + state_bytes * (o + s),
             (4 << 20) + 4 * o if masked else None)
            for o, s in zip(offsets, shifts)]


@pytest.mark.parametrize("state_bytes", [4, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ns,offsets,shifts", [
    ([0, 1, 3, 4, 5], [0, 0, 0, 0, 0], None),
    ([1, 3, 4, 5, 7, 9], [1, 2, 3, 5, 6, 7], None),
    ([4096, 4097, 8191, 8192, 12289, 36864], [0, 1, 2, 3, 0, 5], None),
    ([5, 4099, 36864, 3, 1000, 17, 2105345], [1, 3, 6, 7, 11, 13, 2],
     [0, 1, 0, 1, 0, 1, 0]),
])
def test_compensate_plan_covers_every_element_once(ns, offsets, shifts,
                                                   state_bytes, masked):
    table = _table(ns, offsets, state_bytes, shifts, masked)
    plan = tk.compensate_plan(ns, table, state_bytes)
    seen = []
    for launch in plan:
        assert len(launch.block0) == len(launch.entries) + 1
        assert launch.block0[0] == 0
        assert all(a < b for a, b in zip(launch.block0, launch.block0[1:]))
        for i, cover in _covered(launch, ns).items():
            assert (cover == 1).all(), (i, ns[i])
        seen += launch.entries
    assert seen == [i for i, n in enumerate(ns) if n]    # n = 0: no block
    heads = dict(zip(seen, (h for x in plan for h in x.head)))
    for i in heads:
        if shifts and shifts[i]:
            assert heads[i] == -1           # the streams share no alignment
        elif heads[i] >= 0:
            g = table[i][0] + 4 * heads[i]
            assert g % 16 == 0 or heads[i] == ns[i]


def test_compensate_head():
    # aligned streams: no head; a view one element in: three scalars first
    assert tk.compensate_head(100, (16, 32, 48, None), 4) == 0
    assert tk.compensate_head(100, (20, 36, 52, None), 4) == 3
    assert tk.compensate_head(2, (20, 36, 52, None), 4) == 2   # n < head
    # m one element off g: no common start
    assert tk.compensate_head(100, (16, 36, 48, None), 4) == -1
    # bf16 state: 8-byte groups of four where g is 16-byte aligned
    assert tk.compensate_head(100, (20, 34, 66, None), 2) == 3
    assert tk.compensate_head(100, (20, 36, 66, None), 2) == -1
    # the count vector must share g's alignment
    assert tk.compensate_head(100, (16, 32, 48, 68), 4) == -1
    assert tk.compensate_head(100, (16, 32, 48, 64), 4) == 0


def test_compensate_plan_splits_over_capacity():
    ns = [432, 0, 36864] * 80
    plan = tk.compensate_plan(ns, _table(ns, [0] * len(ns)))
    live = [i for i, n in enumerate(ns) if n]
    assert [len(x.entries) for x in plan] == [96, 64]
    assert [i for x in plan for i in x.entries] == live
    ns3 = [1] * (2 * tk.COMPENSATE_MAX_ENTRIES + 1)
    assert [len(x.entries) for x in tk.compensate_plan(
        ns3, _table(ns3, [0] * len(ns3)))] == [96, 96, 1]
    # ResNet-20's 22 tensors at W=4 take one launch, ResNet-50's 54 three
    assert -(-88 // tk.COMPENSATE_MAX_ENTRIES) == 1
    assert -(-216 // tk.COMPENSATE_MAX_ENTRIES) == 3


# ------------------------------------------------------------------ #
# fused_compensate_multi against the JAX package                     #
# ------------------------------------------------------------------ #

_SIZES = [432, 2304, 4609, 3, 0, 9216, 1]


def _tables(rng, dtype, masked):
    gs, ms, vs, ss = [], [], [], []
    for n in _SIZES:
        g, m, v = _state(rng, n, dtype)
        if masked and n > 5:
            m[5], v[5] = np.nan, np.nan      # masked out below: stays NaN
        gs.append(g), ms.append(m), vs.append(v)
        s = _sent(rng, n)
        if n > 5:
            s[5] = 1.0
        ss.append(s)
    return gs, ms, vs, ss


#: (masked, momentum_masking): momentum masking applies to the masked form
_FORMS = [(False, True), (True, True), (True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("masked,momentum_masking", _FORMS)
def test_multi_plain_matches_jax(dtype, nesterov, momentum_masking, masked):
    rng = np.random.RandomState(3 + 2 * nesterov + momentum_masking)
    gs, ms, vs, ss = _tables(rng, dtype, masked)
    tm = [_torch_state(m, dtype) for m in ms]
    tv = [_torch_state(v, dtype) for v in vs]
    sents = [torch.from_numpy(s) for s in ss] if masked else None
    kw = dict(momentum_masking=momentum_masking) if masked else {}
    want = tk.fused_compensate_multi_plain(
        [torch.from_numpy(g) for g in gs], tm, tv, 0.9, nesterov, sents, **kw)
    out = tk.fused_compensate_multi([torch.from_numpy(g) for g in gs], tm, tv,
                                    0.9, nesterov, sents, **kw)
    assert out[0] is tm and out[1] is tv                 # updated in place
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    for a, b in zip(tm + tv, want[0] + want[1]):
        np.testing.assert_array_equal(a.view(view).numpy(),
                                      b.view(view).numpy())
    for i, (g, m, v, s) in enumerate(zip(gs, ms, vs, ss)):
        args = (jnp.asarray(g), _jax_state(m, dtype), _jax_state(v, dtype))
        if masked:
            rm, rv = jk.fused_compensate_masked_reference(
                *args, jnp.asarray(s), 0.9, nesterov, momentum_masking)
        else:
            rm, rv = jk.fused_compensate_reference(*args, 0.9, nesterov)
        got = [x.view(view).numpy() for x in (tm[i], tv[i])]
        _assert_same(got[0], rm)
        _assert_same(got[1], rv)
        if not g.size:
            continue
        if masked:
            pm, pv = jk.fused_compensate_masked(*args, jnp.asarray(s), 0.9,
                                                nesterov, momentum_masking)
        else:
            pm, pv = jk.fused_compensate(*args, 0.9, nesterov)
        ok = np.isfinite(m) & np.isfinite(v)
        if dtype == "bfloat16":
            for x, p in ((got[0], pm), (got[1], pv)):
                _within_one_bf16_step(x[ok], np.asarray(p)[ok])
        else:
            bound = 4 * _EPS * (np.abs(m) + np.abs(g) + np.abs(v))
            for t, p in ((tm[i], pm), (tv[i], pv)):
                t, p = t.numpy(), np.asarray(p)
                assert (np.abs(t - p)[ok] <= bound[ok]).all()


def test_multi_refuses_aliases_and_mixed_state():
    g, m, v = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    flat = torch.zeros(32)
    with pytest.raises(ValueError):                      # g is an m
        tk.fused_compensate_multi([g, m], [m, torch.zeros(8)],
                                  [v, torch.zeros(8)], 0.9)
    with pytest.raises(ValueError):                      # one m twice
        tk.fused_compensate_multi([g, torch.zeros(8)], [m, m],
                                  [v, torch.zeros(8)], 0.9)
    with pytest.raises(ValueError):                      # overlapping views
        tk.fused_compensate_multi([g, torch.zeros(8)], [flat[0:8],
                                                        flat[4:12]],
                                  [flat[16:24], flat[24:32]], 0.9)
    with pytest.raises(ValueError):                      # a sent is a v
        tk.fused_compensate_multi([g], [m], [v], 0.9, sents=[v])
    with pytest.raises(ValueError):                      # mixed state
        tk.fused_compensate_multi([g, torch.zeros(8)],
                                  [m, torch.zeros(8, dtype=torch.bfloat16)],
                                  [v, torch.zeros(8, dtype=torch.bfloat16)],
                                  0.9)
    with pytest.raises(ValueError):                      # lengths
        tk.fused_compensate_multi([g], [m, torch.zeros(8)], [v], 0.9)
    # adjacent views of one buffer are fine, and a g may be shared
    mm, vv = flat[0:8], flat[8:16]
    tk.fused_compensate_multi([g, g], [mm, flat[16:24]], [vv, flat[24:32]],
                              0.9)
    assert tk.fused_compensate_multi([], [], [], 0.9) == ([], [])


# ------------------------------------------------------------------ #
# the per-tensor exchange's batched compensate                       #
# ------------------------------------------------------------------ #

def _spy(monkeypatch):
    calls = {"multi": [], "single": 0}
    multi = tk.fused_compensate_multi

    def spy_multi(grads, *a, **kw):
        calls["multi"].append(len(grads))
        return multi(grads, *a, **kw)

    def spy_single(*a, **kw):
        calls["single"] += 1
        raise AssertionError("the per-tensor exchange compensated one "
                             "tensor at a time")
    monkeypatch.setattr(tk, "fused_compensate_multi", spy_multi)
    monkeypatch.setattr(tk, "fused_compensate", spy_single)
    return calls


def test_exchange_compensates_all_workers_in_one_call(variables,  # noqa: F811
                                                      monkeypatch):
    """The W=8 ResNet-20 exchange of test_torch_per_tensor_exchange.py, 3
    steps, still bitwise the JAX package's, with one batched compensate
    call an exchange over the 8 workers' compressed tensors."""
    calls = _spy(monkeypatch)
    check_case(variables["params"], "plain")
    n_comp = sum(1 for p in jax_named_flatten(variables["params"])[0]
                 .values() if np.ndim(p) > 1)
    # 3 steps of the fused and the unfused-payload exchange, each
    # compensating the 8 workers' compressed tensors in one call
    assert calls["multi"] == [8 * n_comp] * 6 and calls["single"] == 0


def _exchange_setup(compressor, world=4):
    shapes = {"a/kernel": (6, 7), "b/kernel": (9,), "c/kernel": (3, 5, 2)}
    dist = TDist(t_dgc_sgd(0.1), compressor, LocalComm(world))
    rng = np.random.RandomState(1)
    grads = [{n: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(world)]
    zeros = {n: torch.zeros(s) for n, s in shapes.items()}
    mems = [dist.init_memory(zeros) for _ in range(world)]
    return dist, shapes, grads, mems


def test_compress_takes_a_compensated_velocity():
    """``compress`` with the velocity ``compensate_all`` gave it equals
    ``compress`` compensating by itself, payload and memory bitwise."""
    comp = [tdgc.DGCCompressor(0.25, memory=tmemory.DGCSGDMemory(0.9),
                               sample_ratio=1.0) for _ in range(2)]
    states = []
    for c in comp:
        c.initialize([("w", (64,))])
        states.append(c.memory.init([("w", torch.zeros(64))]))
    g = torch.from_numpy(np.random.RandomState(2).randn(64)
                         .astype(np.float32))
    pre = comp[0].compensate_all([states[0]], [{"w": g}])
    assert pre[0]["w"] is states[0]["velocities"]["w"]
    a = comp[0].compress(states[0], "w", g, compensated=pre[0]["w"])
    b = comp[1].compress(states[1], "w", g)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for key in ("momentums", "velocities"):
        np.testing.assert_array_equal(states[0][key]["w"].numpy(),
                                      states[1][key]["w"].numpy())


@pytest.mark.parametrize("memory", ["identity", "dense"])
def test_exchange_without_a_batched_compensate_keeps_the_loop(memory,
                                                              monkeypatch):
    """The identity memory and the dense compressors have no batched
    compensate: the exchange compensates (or not) tensor by tensor, as
    before, and makes no batched call."""
    calls = {"multi": 0}
    monkeypatch.setattr(tk, "fused_compensate_multi",
                        lambda *a, **k: calls.__setitem__("multi", 1))
    if memory == "identity":
        comp = tdgc.DGCCompressor(0.25, memory=tmemory.Memory(),
                                  sample_ratio=1.0)
        comp.initialize([("a/kernel", (6, 7)), ("c/kernel", (3, 5, 2))])
        assert comp.compensate_all([{}], [{"a/kernel": torch.zeros(6, 7)}]) \
            is None
    else:
        comp = tbase.Compression.none()
    dist, shapes, grads, mems = _exchange_setup(comp)
    outs, _ = dist.exchange(grads, mems, [{}] * 4)
    assert calls["multi"] == 0
    for n, s in shapes.items():
        assert outs[0][n].shape == s and torch.isfinite(outs[0][n]).all()


# ------------------------------------------------------------------ #
# ladder_counts                                                      #
# ------------------------------------------------------------------ #

#: an H100 SXM's cudaOccupancyMaxActiveClusters for the ladder kernel
#: (``ladder_max_clusters``): clusters of 1..16 blocks of 512 and 1,024
#: threads
_H100_CLUSTERS = {
    512: (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
    1024: (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)}


def _h100(threads, cluster):
    return _H100_CLUSTERS[threads][cluster - 1]


#: the ladder check's shapes (ResNet-50's and ResNet-20's adaptive 2-D
#: buckets) and the plan each gets on an H100: (cluster, splits, threads)
_LADDER_PLANS = {(17, 262144): (6, 1, 1024), (3, 2359296): (16, 2, 1024),
                 (2, 2097152): (16, 3, 1024), (5, 1048576): (16, 1, 1024),
                 (8, 655360): (6, 2, 1024), (11, 65536): (8, 1, 512),
                 (8, 16384): (8, 1, 512), (6, 36864): (8, 1, 512),
                 (16, 9216): (4, 1, 512)}


@pytest.mark.parametrize("shape", list(_LADDER_PLANS))
def test_ladder_plan_at_the_check_shapes(shape):
    R, cols = shape
    plan = tk.ladder_plan(R, cols, 11, _h100)
    assert (plan.cluster, plan.splits, plan.threads) == _LADDER_PLANS[shape]
    assert plan.grid == R * plan.splits * plan.cluster
    assert plan.route == ("cluster" if plan.cluster > 1 else "row")
    # one wave: the card runs the R x splits clusters at once
    assert R * plan.splits <= _h100(plan.threads, plan.cluster)
    wide = cols >= tk.LADDER_WIDE_COLS
    assert plan.cluster <= (16 if wide else 8)
    assert wide or plan.splits == 1
    assert cols // plan.cluster >= 4 * plan.threads


@pytest.mark.parametrize("R,cols,levels,want", [
    (4, 262147, 128, (4, 7)), (4, 300001, 17, (8, 3)),
    (2, 2097152, 128, (8, 7))])
def test_ladder_plan_trades_blocks_a_row_for_splits(R, cols, levels, want):
    """Many levels make counting, not reading, the work: a wide row takes
    smaller clusters and more splits (chip_smoke's planted wide cases)."""
    plan = tk.ladder_plan(R, cols, levels, _h100)
    assert (plan.cluster, plan.splits) == want
    assert R * plan.splits <= _h100(1024, plan.cluster)


@pytest.mark.parametrize("R,cols", [(1, 262144), (2, 2359296), (3, 300001),
                                    (6, 1048576)])
def test_ladder_plan_splits_leave_no_split_empty(R, cols):
    """Every level count of 1-128: splits of ceil(L / splits) levels, none
    of them past the ladder (the kernel refuses such a launch)."""
    for levels in range(1, tk.LADDER_MAX_LEVELS + 1):
        plan = tk.ladder_plan(R, cols, levels, _h100)
        per = -(-levels // plan.splits)
        assert 1 <= plan.splits <= levels
        assert -(-levels // per) == plan.splits
        assert R * plan.splits <= _h100(1024, plan.cluster)


@pytest.mark.parametrize("R,cols", [(1000, 100), (5, 3001), (0, 8), (4, 0),
                                    (400, 300000)])
def test_ladder_plan_falls_back_to_a_block_a_row(R, cols):
    plan = tk.ladder_plan(R, cols, 11, _h100)
    assert (plan.cluster, plan.splits, plan.route) == (1, 1, "row")
    assert plan.threads in (512, 1024) and plan.grid == R
    # a card that runs no cluster of two blocks at all
    none = tk.ladder_plan(R, max(cols, 1 << 22), 11, lambda t, c: 0)
    assert (none.cluster, none.splits, none.grid) == (1, 1, R)
    with pytest.raises(ValueError):
        tk.ladder_plan(R, cols, 129, _h100)


@pytest.mark.parametrize("levels", [1, 16, 17, 128])
@pytest.mark.parametrize("shape", [(5, 1027), (4, 3001)])
def test_ladder_counts_plain_matches_jax(levels, shape):
    rng = np.random.RandomState(levels + shape[1])
    imp, thr = _ladder_input(rng, *shape, levels)
    got = tk.ladder_counts(torch.from_numpy(imp), torch.from_numpy(thr),
                           0.8, levels)
    assert got.dtype == torch.int32 and got.shape == (shape[0], levels)
    ref = jk.ladder_counts_reference(jnp.asarray(imp), jnp.asarray(thr), 0.8,
                                     levels)
    pallas = jk.ladder_counts(jnp.asarray(imp), jnp.asarray(thr), 0.8,
                              levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
