"""The gossip exchange against the JAX package.

* The schedule algebra (``compression.gossip``): the configs, the
  neighborhoods and the numpy twins bitwise the JAX module's for W = 2..9
  and clocks 0..2W; the torch ``round_state`` / ``row_weights`` bitwise
  the JAX traced forms, with and without dropped peers; ``make_config``
  refusing what the JAX module refuses, with its messages.
* The planner: gossip plans on the same bucket geometry, for both
  topologies — the regimes, the cost tables (rtol 1e-12), ``key()``,
  ``verify_descriptor()["gossip"]``, ``replan`` and the family post-pass.
* The exchange: the port's engine (``LocalComm``) against the JAX engine
  run op by op under ``jax.vmap`` (under ``jax.jit`` XLA-CPU contracts the
  compensate's multiply-adds into FMAs, see test_torch_engine.py), on the
  tiny model of tests/test_gossip.py, at W=8 over full and gossip rounds
  for both topologies, through a ``droplink`` round, along the step-exact
  forced-sync ladder, and at W=3 (ring). Outputs, momenta, velocities,
  records, inbox, ages, clock and forced count are bitwise; each round
  also balances the velocity mass against residual, inbox and output
  within 1e-6 relative.
* The memory's canonical view and its state-dict round trip (clock, ages
  and forced count carried, the inbox folded into the velocities).
* The elastic reshard of the gossip round state (merge, split, collapse)
  against ``reshard_state`` on the states of tests/test_elastic.py.
* The trainer: the gossip recipe (ResNet-20's stages cut to one block,
  W=4, the fleet taps on) against the JAX package's jitted flat train
  step with the same gossip plan: losses within the step tests' rtol
  1e-3, the staleness lanes and the forced count bitwise; and a save
  with the inbox in flight, restored, bitwise the uninterrupted run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.compression import gossip as jg
from dgc_tpu.compression import planner as jp
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.data import CIFAR as JaxCIFAR
from dgc_tpu.data import epoch_batches as jax_epoch_batches
from dgc_tpu.models.resnet_cifar import CifarResNet as JResNet
from dgc_tpu.resilience import elastic as jelastic
from dgc_tpu.resilience import faults as jfaults
from dgc_tpu.training import (build_train_step, cosine_schedule,
                              make_flat_setup, make_flat_state,
                              make_lr_schedule, shard_state)
from dgc_tpu.utils.config import Config
from dgc_tpu.utils.config import configs as jconfigs
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs
from dgc_tpu_torch import train as ttrain
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression import gossip as tg
from dgc_tpu_torch.compression import planner as tp
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.models.resnet_cifar import CifarResNet as TResNet
from dgc_tpu_torch.models.resnet_cifar import init_variables
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.resilience import elastic as telastic
from dgc_tpu_torch.resilience import faults as tfaults
from dgc_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_elastic import _gossip_state, _topo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raises_alike(tfn, jfn):
    """Both raise, the same exception type with the same message."""
    with pytest.raises(Exception) as j:
        jfn()
    with pytest.raises(type(j.value)) as t:
        tfn()
    assert str(t.value) == str(j.value)


# --------------------------------------------------------------------- #
# the schedule algebra                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("world", range(2, 10))
def test_schedules_and_numpy_twins_match_jax(world):
    rng = np.random.RandomState(world)
    assert tg.default_sync_every(world) == jg.default_sync_every(world)
    assert tg.default_max_staleness(world) == jg.default_max_staleness(world)
    for topo in tg.TOPOLOGIES:
        assert tg.neighbors_per_round(topo) == jg.neighbors_per_round(topo)
        if topo == "hcube" and world & (world - 1):
            _raises_alike(lambda: tg.make_config(topo, world),
                          lambda: jg.make_config(topo, world))
            continue
        tc, jc = tg.make_config(topo, world), jg.make_config(topo, world)
        assert tuple(tc) == tuple(jc)
        age = np.zeros(world, np.int32)
        for clock in range(2 * world + 1):
            assert tg.ring_stride(clock, max(world, 2)) == jg.ring_stride(
                clock, max(world, 2))
            assert tg.hcube_mask(clock, world) == jg.hcube_mask(clock, world)
            dropped = rng.rand(world) < 0.3
            for w in range(world):
                assert (tg.out_neighbors(tc, clock, w)
                        == jg.out_neighbors(jc, clock, w))
                np.testing.assert_array_equal(
                    tg.recv_weights_np(tc, clock, w),
                    jg.recv_weights_np(jc, clock, w))
                for full in (False, True):
                    for d in (None, dropped):
                        np.testing.assert_array_equal(
                            tg.row_weights_np(tc, clock, w, full, d),
                            jg.row_weights_np(jc, clock, w, full, d))
            for d in (None, dropped):
                t = tg.round_state_np(tc, clock, age, d)
                j = jg.round_state_np(jc, clock, age, d)
                assert t[:2] == j[:2]
                np.testing.assert_array_equal(t[2], j[2])
            age = jg.round_state_np(jc, clock, age, dropped)[2]


@pytest.mark.parametrize("topology,world", [("ring", 8), ("hcube", 8),
                                            ("ring", 6)])
def test_torch_round_state_and_row_weights_match_jax(topology, world):
    rng = np.random.RandomState(0)
    tc = tg.make_config(topology, world, sync_every=3, max_staleness=5)
    jc = jg.make_config(topology, world, sync_every=3, max_staleness=5)
    for clock in range(2 * world):
        age = rng.randint(0, 6, world).astype(np.int32)
        dropped = rng.rand(world) < 0.3
        for d in (None, dropped):
            jf, jfo, ja = jg.round_state(
                jc, jnp.asarray(clock, jnp.int32), jnp.asarray(age),
                None if d is None else jnp.asarray(d))
            tclock = torch.tensor(clock, dtype=torch.int32)
            td = None if d is None else torch.from_numpy(d)
            tf, tfo, ta = tg.round_state(tc, tclock, torch.from_numpy(age),
                                         td)
            assert bool(tf) == bool(jf) and bool(tfo) == bool(jfo)
            assert ta.dtype == torch.int32
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
            for w in range(world):
                jw = jg.row_weights(jc, jnp.asarray(clock, jnp.int32),
                                    jnp.asarray(w, jnp.int32), jf,
                                    None if d is None else jnp.asarray(d))
                tw = tg.row_weights(tc, tclock, w, tf, td)
                assert tw.dtype == torch.float32
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_make_config_refuses_as_jax():
    for args, kw in ((("mesh", 8), {}), (("ring", 1), {}),
                     (("hcube", 6), {}),
                     (("ring", 8), dict(sync_every=4, max_staleness=3)),
                     (("ring", 8), dict(sync_every=0))):
        _raises_alike(lambda: tg.make_config(*args, **kw),
                      lambda: jg.make_config(*args, **kw))
    assert tuple(tg.make_config("ring", 6, 2, None)) == tuple(
        jg.make_config("ring", 6, 2, None))


# --------------------------------------------------------------------- #
# the tiny model of tests/test_gossip.py, both engines                   #
# --------------------------------------------------------------------- #

def _params():
    rng = np.random.RandomState(0)
    return {
        "conv1": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
        "conv2": {"kernel": rng.randn(3, 3, 8, 8).astype(np.float32)},
        "dense": {"kernel": rng.randn(32, 10).astype(np.float32),
                  "bias": rng.randn(10).astype(np.float32)},
    }


def _engines(topology, world, sync_every=4, max_staleness=8):
    """The JAX and the port engine on the same gossip plan."""
    params = _params()
    named = jax_named_flatten(params)[0]
    jc = DGCCompressor(0.05, memory=DGCSGDMemory(momentum=0.9),
                       sample_ratio=1.0)
    tc = tdgc.DGCCompressor(0.05, memory=TMemory(momentum=0.9),
                            sample_ratio=1.0)
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jl = ParamLayout.for_compressor(params, jc)
    tl = tflat.ParamLayout.for_compressor(params, tc)
    kw = dict(fabric="32x25GbE", world=world,
              candidates=("gossip_" + topology,),
              gossip_sync_every=sync_every,
              gossip_max_staleness=max_staleness)
    jplan = jp.plan_buckets([jp.bucket_geometry(b) for b in
                             FlatDGCEngine(jc, jl).buckets], **kw)
    tplan = tp.plan_buckets([tp.bucket_geometry(b) for b in
                             tflat.FlatDGCEngine(tc, tl).buckets], **kw)
    return (FlatDGCEngine(jc, jl, plan=jplan),
            tflat.FlatDGCEngine(tc, tl, plan=tplan))


@pytest.mark.parametrize("topology", tg.TOPOLOGIES)
def test_gossip_plans_match_jax(topology):
    je, te = _engines(topology, 8)
    jplan, tplan = je.plan, te.plan
    assert tplan.regimes == jplan.regimes
    assert tplan.key() == jplan.key() and tplan.gossip == jplan.gossip
    for tcost, jcost in zip(tplan.bucket_costs, jplan.bucket_costs):
        assert set(tcost) == set(jcost)
        for r, v in tcost.items():
            np.testing.assert_allclose(v, jcost[r], rtol=1e-12, atol=0)
    assert tplan.verify_descriptor() == jplan.verify_descriptor()
    assert tplan.verify_descriptor()["gossip"] == topology
    assert tplan.replan(te).key() == jplan.replan(je).key()
    # the family post-pass over the plain regimes and the family, on a
    # slow and a fast fabric
    geoms = [tp.bucket_geometry(b) for b in te.buckets]
    for fab in ("32x25GbE", "ici_v5e8"):
        cands = tp.REGIMES + ("gossip_" + topology,)
        t = tp.plan_buckets(geoms, fabric=fab, world=8, candidates=cands)
        j = jp.plan_buckets(geoms, fabric=fab, world=8, candidates=cands)
        assert t.regimes == j.regimes and t.key() == j.key()
    assert te._gossip == je._gossip
    assert te._seg_fused is False and te.regimes == je.regimes


def _grads(layout, rng, world):
    g = np.zeros((world, layout.total), np.float32)
    for n in layout.names:
        o, s = layout.offsets[n], layout.sizes[n]
        g[:, o:o + s] = rng.randn(world, s)
    return g


def _phases(engine, key):
    """The uniforms the JAX engine's ``_sample_rows`` draws from ``key``:
    one per (bucket, stride group) of every sampled bucket."""
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def _jax_phases(engine, key, world):
    """Each worker's phases in the exchange (its key folded with its
    index)."""
    return [_phases(engine, jax.random.fold_in(key, w))
            for w in range(world)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _mass_balance(te, mems, outs):
    """The velocity mass of the round (the compensate's and the inbox
    fold's, unmasked in the memory under deferred masking) against what
    it became: the residual the records keep, the inbox in flight and the
    output every worker applied, W times. Relative gap, in float64."""
    T = te.T
    vel = res = inbox = 0.0
    for m in mems:
        v = m["velocities_c"].double()
        keep = tk.keep_from_bits(m["sent_bits"], T).double()
        vel += v.sum().item()
        res += (v * keep).sum().item()
        inbox += m["gossip_inbox"].double().sum().item()
    out = len(mems) * outs[0][:T].double().sum().item()
    scale = sum(m["velocities_c"].double().abs().sum().item() for m in mems)
    return abs(vel - (res + inbox + out)) / max(scale, 1e-12)


def _run(je, te, world, steps, seed=3):
    """``steps`` exchanges on both engines from the same gradients and
    sampling phases; everything bitwise after every round. Yields each
    round's ``(port memories, port outputs)``."""
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return je.exchange(fg, mem, key, "data", world, op="average")
    # op by op: no jax.jit around it (see the module docstring)
    jstep = jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")
    jmem = jax.tree.map(lambda x: jnp.stack([x] * world), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(world)]
    assert set(tmems[0]) == set(jmem)
    rng = np.random.RandomState(seed)
    for s in range(steps):
        g = _grads(te.layout, rng, world)
        key = jax.random.PRNGKey(s)
        jout, jmem = jstep(jnp.asarray(g), jmem, key)
        touts = te.exchange([torch.from_numpy(x) for x in g], tmems,
                            _jax_phases(je, key, world), LocalComm(world))
        for w in range(world):
            np.testing.assert_array_equal(_bits(touts[w].numpy()),
                                          _bits(jout[w]), err_msg=f"{s}")
            for k, v in tmems[w].items():
                np.testing.assert_array_equal(
                    _bits(v.numpy()), _bits(np.asarray(jmem[k][w])),
                    err_msg=f"round {s} worker {w} {k}")
        assert _mass_balance(te, tmems, touts) <= 1e-6
        yield tmems, touts


@pytest.mark.parametrize("topology", tg.TOPOLOGIES)
def test_exchange_matches_jax_engine(topology):
    """Rounds 0 and 4 full, 1-3 and 5 gossip (sync_every 4): the output
    zero on gossip rounds, the inbox empty on full ones."""
    je, te = _engines(topology, 8)
    kinds = []
    for s, (mems, outs) in enumerate(_run(je, te, 8, 6)):
        full = s % 4 == 0
        kinds.append(full)
        assert bool(outs[0][:te.T].abs().sum() > 0) == full
        assert bool(mems[3]["gossip_inbox"].abs().sum() > 0) == (not full)
        assert int(mems[0]["gossip_clock"]) == s + 1
    assert kinds.count(False) >= 3 and kinds.count(True) >= 2


def test_droplink_round_matches_jax(monkeypatch):
    """``droplink:peer=3@1-1``: worker 3 weighs 0 on every receiver of
    round 1 and its own record is voided, so its mass stays home."""
    monkeypatch.setenv(tfaults.ENV, "droplink:peer=3@1-1")
    je, te = _engines("ring", 8)
    assert te._faults == tfaults.FaultPlan(*jfaults.plan())
    assert te._faults.droplink_peer == 3
    for s, (mems, _) in enumerate(_run(je, te, 8, 4, seed=4)):
        if s == 1:
            assert bool(tk.keep_from_bits(mems[3]["sent_bits"],
                                          te.T).all())
    assert int(mems[0]["gossip_clock"]) == 4
    assert int(mems[0]["gossip_forced"]) == 0


def test_staleness_ladder_is_step_exact(monkeypatch):
    """tests/test_gossip.py's ladder: ``droplink:peer=3@1-5`` with
    ``sync_every == max_staleness == 4`` forces full syncs at rounds 5
    and 6; worker 3's age is clamped at 4."""
    monkeypatch.setenv(tfaults.ENV, "droplink:peer=3@1-5")
    je, te = _engines("ring", 8, sync_every=4, max_staleness=4)
    want_forced = [0, 0, 0, 0, 0, 1, 2, 2]
    want_age3 = [0, 1, 2, 3, 4, 4, 0, 1]
    for s, (mems, outs) in enumerate(_run(je, te, 8, 8, seed=5)):
        age = mems[0]["gossip_age"]
        assert int(mems[0]["gossip_forced"]) == want_forced[s], s
        assert int(age[3]) == want_age3[s], s
        assert int(age.max()) <= 4
        full = s % 4 == 0 or s in (5, 6)
        assert bool(outs[0][:te.T].abs().sum() > 0) == full, s


def test_exchange_at_w3_matches_the_op_by_op_jax_engine():
    """W=3 (ring; hcube needs a power of two): the row weights W/outdeg =
    1.5 and 3 multiply the gathered values before the IEEE divide by 3,
    in the reference's order."""
    je, te = _engines("ring", 3, sync_every=2, max_staleness=3)
    assert te._gossip == (("ring", 3, 2, 3))
    for _ in _run(je, te, 3, 4, seed=6):
        pass
    _raises_alike(lambda: _engines("hcube", 6),
                  lambda: jg.make_config("hcube", 6))


def test_world_and_op_refusals_match_jax():
    je, te = _engines("ring", 8)
    mems = [te.init_memory("cpu") for _ in range(4)]
    g = [torch.zeros(te.layout.total) for _ in range(4)]
    with pytest.raises(ValueError, match="world=8 but exchange runs with "
                                         "world_size=4"):
        te.exchange(g, mems, [te.draw_phases(torch.Generator())] * 4,
                    LocalComm(4))
    with pytest.raises(ValueError, match="op='average'"):
        te.exchange(g * 2, mems * 2,
                    [te.draw_phases(torch.Generator())] * 8, LocalComm(8),
                    op="sum")


def test_memory_full_and_state_dict_round_trip_match_jax():
    """After three rounds (the inbox in flight): the canonical view folds
    the inbox into the velocities after the mask, and the state-dict
    round trip keeps clock, ages and forced count with an empty inbox —
    bitwise the JAX engine's on the same memory."""
    je, te = _engines("ring", 8)
    for mems, _ in _run(je, te, 8, 3, seed=7):
        pass
    tm = mems[2]
    assert tm["gossip_inbox"].abs().sum() > 0
    jm = {k: jnp.asarray(v.numpy()) for k, v in tm.items()}
    tfull, jfull = te.memory_full(tm), je.memory_full(jm)
    for k in ("momentums", "velocities"):
        np.testing.assert_array_equal(_bits(tfull[k].numpy()),
                                      _bits(jfull[k]), err_msg=k)
    tsd, jsd = te.memory_state_dict(tm), je.memory_state_dict(jm)
    jsd = jax.tree.map(np.asarray, jsd)
    tl, jl = te.load_memory_state_dict(tm, jsd), je.load_memory_state_dict(
        jm, jsd)
    assert set(tl) == set(jl)
    for k, v in tl.items():
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(jl[k]),
                                      err_msg=k)
    for k in ("gossip_clock", "gossip_age", "gossip_forced"):
        assert torch.equal(tl[k], tm[k])
    assert not tl["gossip_inbox"].any()
    for k in ("momentums", "velocities"):
        for n, a in jsd[k].items():
            np.testing.assert_array_equal(_bits(tsd[k][n].numpy()),
                                          _bits(a))


# --------------------------------------------------------------------- #
# elastic reshard                                                        #
# --------------------------------------------------------------------- #

def _port_workers(state, world):
    """tests/test_elastic.py's gossip state as the port's worker dicts."""
    mem = state.memory
    stats = np.zeros((world, 6), np.float32)
    return [{**{f"memory:{k}": torch.from_numpy(np.array(v[w]))
                for k, v in mem.items()},
             "batch_stats": torch.from_numpy(stats[w].copy()),
             "generator": torch.Generator().manual_seed(w).get_state()}
            for w in range(world)]


@pytest.mark.parametrize("fw,tw,kw", [
    (4, 2, dict(age=[0, 3, 1, 2], clock=[6, 7, 7, 5], forced=[2, 5, 2, 2])),
    (2, 4, dict(age=[3, 1])),
    (4, 3, dict(age=[0, 3, 1, 2]))])
def test_elastic_gossip_reshard_matches_jax(fw, tw, kw):
    """Merge (max age a group, max clock and forced count, the inbox
    summed), split (the parent's age, the inbox to the first child) and
    collapse (the global max age): every child's memory bitwise
    ``reshard_state``'s, the inbox total conserved, the log naming the
    gossip round state."""
    state = _gossip_state(fw, **kw)
    jlogs, tlogs = [], []
    jout = jelastic.reshard_state(state, _topo(fw), _topo(tw),
                                  log=jlogs.append)
    fresh = {c: {"generator": torch.Generator().manual_seed(50 + c)
                 .get_state()} for c in range(tw)}
    out = telastic.reshard_workers(_port_workers(state, fw), fresh,
                                   {"world": fw}, {"world": tw},
                                   log=tlogs.append)
    for c in range(tw):
        for k in state.memory:
            got = out[c][f"memory:{k}"].numpy()
            want = np.asarray(jout.memory[k])[c]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{c} {k}")
    assert sum(out[c]["memory:gossip_inbox"].double().sum().item()
               for c in range(tw)) == pytest.approx(
        float(np.asarray(state.memory["gossip_inbox"], np.float64).sum()),
        rel=1e-6)
    assert any("gossip round state" in m for m in tlogs)
    assert [m for m in tlogs if "gossip" in m] == [
        m for m in jlogs if "gossip" in m]


# --------------------------------------------------------------------- #
# the trainer                                                            #
# --------------------------------------------------------------------- #

W = 4
STAGES = (1, 1, 1)


def _small_cfg():
    cfg = configs.resnet20_wm5_gossip()
    cfg.train.batch_size = 4
    cfg.dataset.synthetic_size = 64
    return cfg


@pytest.fixture(scope="module")
def variables():
    return jax.device_get(JResNet(stage_sizes=STAGES).init(
        jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)), train=True))


@pytest.fixture(scope="module")
def jax_gossip_steps(variables):
    """The JAX package's jitted flat fleet step on a 4-device mesh with
    the gossip plan the JAX harness makes (``candidates=("gossip_ring",)``)
    for the recipe's first three steps: losses, fleet lanes and each
    worker's sampling phases."""
    cfg = _small_cfg()
    cc = cfg.train.compression
    comp = DGCCompressor(cc.compress_ratio,
                         memory=DGCSGDMemory(momentum=cc.memory.momentum),
                         sample_ratio=cc.sample_ratio,
                         warmup_epochs=cc.warmup_epochs)
    named = jax_named_flatten(variables["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    ds = JaxCIFAR(cfg.dataset.root, 10, 32,
                  synthetic_size=cfg.dataset.synthetic_size)["train"]
    gb = W * cfg.train.batch_size
    dist = DistributedOptimizer(
        dgc_sgd(make_lr_schedule(0.1 * W, W, len(ds) // gb, 5,
                                 cosine_schedule(195)),
                momentum=0.9, weight_decay=1e-4), comp, world_size=W)
    comp.warmup_compress_ratio(0)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    setup = make_flat_setup(variables, dist)
    plan = jp.plan_engine(setup.engine, world=W,
                          candidates=("gossip_ring",))
    setup = make_flat_setup(variables, dist, plan=plan)
    state = shard_state(make_flat_state(variables, dist, setup, W), mesh,
                        dist_opt=dist)
    step_fn = build_train_step(JResNet(stage_sizes=STAGES).apply, dist, mesh,
                               donate=False, flat=setup, telemetry=True,
                               fleet=True)
    clock = jax.device_put(np.full((W,), 5.0, np.float32),
                           NamedSharding(mesh, P("data")))
    losses, fleet, phases = [], [], []
    base = jax.random.PRNGKey(cfg.seed)
    for b, idx in enumerate(jax_epoch_batches(len(ds), gb, 0,
                                              seed=cfg.seed)):
        if b == 3:
            break
        images, labels = ds.get_batch(idx)
        key = jax.random.fold_in(base, b)
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels),
                           key, clock)
        losses.append(float(m["loss"]))
        fleet.append({k: np.asarray(m["fleet"][k]) for k in (
            "w_staleness", "max_staleness_seen", "gossip_forced_syncs")})
        # the step's per-worker sparsify key (training/step.py)
        phases += [_phases(setup.engine, jax.random.split(
            jax.random.fold_in(key, w))[1]) for w in range(W)]
    return {"losses": losses, "fleet": fleet, "phases": phases,
            "gossip": setup.engine._gossip}


def _model(mc, gen):
    """The recipe's CIFAR ResNet with one block a stage."""
    model = TResNet(STAGES, mc.num_classes)
    init_variables(model, gen)
    return model


def _trainer(monkeypatch, cfg=None):
    monkeypatch.setattr(ttrain, "from_config", _model)
    return ttrain.Trainer(cfg or _small_cfg(), LocalComm(W), device="cpu")


def _load(trainer, variables):
    trainer.load_flat(*carry_variables(
        variables["params"], variables["batch_stats"], trainer.setup.layout,
        trainer.setup.stats_layout))


def test_gossip_recipe_tracks_the_jax_step_and_fleet_lanes(
        variables, jax_gossip_steps, monkeypatch, capsys):
    want = jax_gossip_steps
    phases = list(reversed(want["phases"]))
    monkeypatch.setattr(tflat.FlatDGCEngine, "draw_phases",
                        lambda self, gen: phases.pop())
    trainer = _trainer(monkeypatch)
    assert "[gossip] GossipConfig(topology='ring', world=4" in (
        capsys.readouterr().out)
    _load(trainer, variables)
    assert trainer.setup.engine._gossip == want["gossip"]
    assert set(trainer.setup.engine.regimes) == {"gossip_ring"}
    fleet = []
    losses = [float(x) for x in trainer.run_epoch(
        0, steps=3, on_step=lambda b, m: fleet.append(m["fleet"]))]
    assert not phases                     # one draw per worker and step
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-3)
    for got, jf in zip(fleet, want["fleet"]):
        for k, v in jf.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # round 0 full, round 1 gossip (ages 1), round 2 full (sync_every 2)
    assert [f["w_staleness"].tolist() for f in fleet] == [
        [0.0] * W, [1.0] * W, [0.0] * W]


@pytest.mark.parametrize("recipe", ["resnet20_wm5_gossip",
                                    "resnet50_wm5_gossip"])
def test_gossip_recipes_match_the_config_files(recipe, monkeypatch):
    """The recipes against ``configs/gossip.py`` stacked on the wm5 files:
    the gossip block, and the telemetry block with the fleet taps."""
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(*configs.CONFIG_FILES[recipe])
        t, c = configs.RECIPES[recipe]().train, jconfigs.train
        assert dict(t.gossip) == dict(c.gossip) == {
            "enabled": True, "topology": "ring", "sync_every": None,
            "max_staleness": None}
        assert dict(t.telemetry) == dict(c.telemetry) == {
            "enabled": True, "every": 1, "rotate_mb": 64, "fleet": True}
        base = configs.RECIPES[recipe.replace("_gossip", "")]().train
        assert t.compression == base.compression
    finally:
        Config.reset()
    assert configs.CONFIG_FILES[recipe][-1] == "configs/gossip.py"
    hc = configs.with_gossip(configs.resnet20_wm5(), "hcube", 2, 3).train
    assert dict(hc.gossip) == {"enabled": True, "topology": "hcube",
                               "sync_every": 2, "max_staleness": 3}


def test_trainer_refuses_gossip_without_dgc(monkeypatch):
    cfg = configs.with_gossip(configs.resnet20())
    with pytest.raises(SystemExit, match="gossip decentralizes"):
        _trainer(monkeypatch, cfg)


def test_resume_with_the_inbox_in_flight_is_bitwise(tmp_path, monkeypatch):
    """Saved after round 1 (a gossip round: the inbox holds mass),
    restored into a fresh trainer, two more rounds: losses and memory
    bitwise the uninterrupted run's."""
    a = _trainer(monkeypatch)
    want = [float(x) for x in a.run_epoch(0, steps=4)]
    b = _trainer(monkeypatch)
    got = [float(x) for x in b.run_epoch(0, steps=2)]
    assert all(m["gossip_inbox"].abs().sum() > 0 for m in b.state.memory)
    ckpt = CheckpointManager(str(tmp_path))
    b.save_checkpoint(ckpt, 0, {})
    c = _trainer(monkeypatch)
    assert c.restore_checkpoint(ckpt) is not None
    for mb, mc in zip(b.state.memory, c.state.memory):
        for k, v in mb.items():
            assert torch.equal(mc[k], v), k
    got += [float(x) for x in c.run_epoch(0, steps=4, start=2)]
    assert got == want
    for ma, mc in zip(a.state.memory, c.state.memory):
        for k, v in ma.items():
            np.testing.assert_array_equal(_bits(mc[k].numpy()),
                                          _bits(v.numpy()), err_msg=k)
