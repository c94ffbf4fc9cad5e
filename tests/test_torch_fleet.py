"""The fleet taps and readers against the JAX package.

* ``gather_stats``: the port's one packed all-gather over a ``LocalComm``
  against the JAX ``gather_stats`` under ``jax.vmap`` on the same seeded
  per-worker stats, at W=4 and over two tiers (2 nodes x 2, the JAX axes
  ``("hosts", "local")``, gathered worker-major as the port's whole group
  is): the gathered lanes and the argmax, gap and engagement bitwise, the
  means and the skew within rtol 1e-6 (sums over the workers).
* The fleet step: the JAX package's jitted ``build_train_step(telemetry,
  fleet)`` on a 2-device mesh and the port's ``train_step(telemetry=True,
  fleet=True)`` from the same weights, batches, sampling phases and
  clocks, two steps of a CIFAR ResNet with one block a stage: the same
  keys, the clock, send-fraction and gossip lanes (a constant 0: no
  gossip plan; tests/test_torch_gossip.py holds them under one) and the
  static wire
  bytes bitwise, every other number within the rtol 1e-3 the step parity
  test gives the losses (the convolutions sum in other orders, and XLA
  contracts the compensate's multiply-adds under jit). The fleet step
  makes one all-gather and no all-reduce more than the plain step; the
  telemetry step one all-reduce more.
* The host half on sink shards the port writes (two hosts, rotated
  files, a torn tail): ``discover_shards``, ``load_view``,
  ``worker_series``, ``detect_desync``, ``straggler_table``,
  ``fleet_summary``, ``discover_runs``, ``discover_serving`` and
  ``serving_summary`` give the JAX package's answers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.models.resnet_cifar import CifarResNet as JResNet
from dgc_tpu.telemetry import fleet as jfleet
from dgc_tpu.training import (build_train_step, make_flat_setup,
                              make_flat_state, shard_state)
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.models.resnet_cifar import CifarResNet as TResNet
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.telemetry import fleet as tfleet
from dgc_tpu_torch.telemetry import registry, sink, taps
from dgc_tpu_torch.training import step as tstep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: lanes and scalars the two gathers give bitwise
_EXACT = ("w_clock", "w_grad_norm", "w_residual_mass", "w_sent_ratio",
          "w_eff_ratio", "w_staleness", "straggler", "straggler_gap",
          "adaptive_engaged", "max_staleness_seen", "gossip_forced_syncs")


def _worker_stats(rng, world, nb=3):
    out = []
    for _ in range(world):
        st = {k: np.float32(rng.rand() * 10) for k in
              registry.step_stat_names()}
        st["payload_elems"] = np.float32(rng.randint(100, 1000))
        st["selected_frac"] = rng.rand(nb).astype(np.float32)
        st["threshold"] = rng.rand(nb).astype(np.float32)
        out.append(st)
    return out


def _compare(tel, flt, jtel, jflt, label, exact=_EXACT):
    assert set(tel) == set(jtel) and set(flt) == set(jflt)
    for k in tel:
        np.testing.assert_allclose(tel[k].numpy(), np.asarray(jtel[k]),
                                   rtol=1e-6, err_msg=f"{label} {k}")
    for k in flt:
        got, want = flt[k].numpy(), np.asarray(jflt[k])
        assert got.dtype == np.float32 and got.shape == want.shape, k
        if k in exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("adaptive,gossip", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="gossip")])
def test_gather_stats_matches_jax(adaptive, gossip):
    """The lanes with the adaptive fraction and with the gossip ages and
    forced count (each worker's age, int32 as the memory holds it); off,
    the gossip lane and scalars are a constant 0, as the JAX gather's."""
    W = 4
    rng = np.random.RandomState(int(adaptive))
    stats = _worker_stats(rng, W)
    clock = np.asarray([200.0, 200.0, 350.0, 200.0], np.float32)
    eff = np.asarray([1.0, 1.0, 0.775, 1.0], np.float32)
    age = np.asarray([0, 3, 1, 2], np.int32)
    forced = np.int32(5)
    total = 270_000
    jstack = {k: jnp.stack([jnp.asarray(s[k]) for s in stats])
              for k in stats[0]}

    def worker(st, c, e, a):
        return jfleet.gather_stats(st, ("data",), clock=c[None],
                                   total_elems=total,
                                   eff_ratio=e if adaptive else None,
                                   staleness=a if gossip else None,
                                   forced=(jnp.asarray(forced) if gossip
                                           else None))
    jtel, jflt = jax.vmap(worker, axis_name="data")(
        jstack, jnp.asarray(clock), jnp.asarray(eff), jnp.asarray(age))
    jtel = {k: v[0] for k, v in jtel.items()}
    jflt = {k: v[0] for k, v in jflt.items()}
    tstats = [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
              for s in stats]
    tel, flt = tfleet.gather_stats(
        tstats, LocalComm(W), clock=torch.from_numpy(clock),
        total_elems=total,
        eff_ratio=[torch.tensor(e) for e in eff] if adaptive else None,
        staleness=([torch.tensor(a) for a in age] if gossip else None),
        forced=torch.tensor(forced) if gossip else None)
    _compare(tel, flt, jtel, jflt, "W=4")
    assert float(flt["straggler"]) == 2.0
    assert float(flt["adaptive_engaged"]) == float(adaptive)
    assert flt["w_staleness"].tolist() == (age.tolist() if gossip
                                           else [0.0] * W)
    assert float(flt["max_staleness_seen"]) == (3.0 if gossip else 0.0)
    assert float(flt["gossip_forced_syncs"]) == (5.0 if gossip else 0.0)


def test_gather_stats_two_tiers_worker_major():
    from dgc_tpu.utils.compat import shard_map
    nodes, local = 2, 2
    W = nodes * local
    stats = _worker_stats(np.random.RandomState(7), W)
    clock = np.asarray([5.0, 9.0, 1.0, 3.0], np.float32)
    total = 1000
    axes = ("hosts", "local")
    mesh = Mesh(np.array(jax.devices()[:W]).reshape(nodes, local), axes)
    jstack = {k: jnp.stack([jnp.asarray(s[k]) for s in stats])
              for k in stats[0]}

    def worker(st, c):
        st = {k: x[0] for k, x in st.items()}
        tel, flt = jfleet.gather_stats(st, axes, clock=c, total_elems=total)
        return ({k: x[None] for k, x in tel.items()},
                {k: x[None] for k, x in flt.items()})
    jtel, jflt = jax.jit(shard_map(
        worker, mesh=mesh, in_specs=(P(axes), P(axes)),
        out_specs=(P(axes), P(axes)), check_vma=False))(
        jstack, jnp.asarray(clock))
    jtel = {k: np.asarray(v)[0] for k, v in jtel.items()}
    jflt = {k: np.asarray(v)[0] for k, v in jflt.items()}
    tstats = [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
              for s in stats]
    tel, flt = tfleet.gather_stats(tstats, LocalComm(W),
                                   clock=torch.from_numpy(clock),
                                   total_elems=total)
    # under jit XLA divides the sent count by the constant element count
    # through its reciprocal (one ulp from the port's IEEE divide)
    _compare(tel, flt, jtel, jflt, "2x2",
             exact=tuple(k for k in _EXACT if k != "w_sent_ratio"))
    np.testing.assert_array_equal(flt["w_clock"].numpy(), clock)


def test_make_clock():
    c = tfleet.make_clock(12.5, 4, "cpu")
    assert c.dtype == torch.float32 and c.tolist() == [12.5] * 4


# --------------------------------------------------------------------- #
# the fleet step against the JAX fleet step                              #
# --------------------------------------------------------------------- #

class _Recording(LocalComm):
    def __init__(self, world):
        super().__init__(world)
        self.calls = {"all_gather": 0, "all_reduce": 0}

    def all_gather(self, xs):
        self.calls["all_gather"] += 1
        return super().all_gather(xs)

    def all_reduce(self, xs):
        self.calls["all_reduce"] += 1
        return super().all_reduce(xs)


def _jphases(engine, key):
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def test_fleet_step_tracks_the_jax_fleet_step():
    W, bs, steps = 2, 4, 2
    stages = (1, 1, 1)
    v = jax.device_get(JResNet(stage_sizes=stages).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=True))
    kw = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(v["params"])[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(0)
    tc.warmup_compress_ratio(0)
    jdist = DistributedOptimizer(dgc_sgd(0.1, momentum=0.9), jc,
                                 world_size=W)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    jsetup = make_flat_setup(v, jdist)
    jstate = shard_state(make_flat_state(v, jdist, jsetup, W), mesh,
                         dist_opt=jdist)
    jstep = build_train_step(JResNet(stage_sizes=stages).apply, jdist,
                             mesh, donate=False, flat=jsetup,
                             telemetry=True, fleet=True)

    model = TResNet(stages, 10)
    comm = _Recording(W)
    tdist = TDist(t_dgc_sgd(0.1, momentum=0.9), tc, comm)
    setup = tstep.make_flat_setup(model, tdist)
    fp, fs = carry_variables(v["params"], v["batch_stats"], setup.layout,
                             setup.stats_layout)
    state = tstep.make_flat_state(model, tdist, setup, "cpu", fp, fs)
    rng = np.random.RandomState(0)
    sh = NamedSharding(mesh, P("data"))
    for s in range(steps):
        images = rng.randn(W * bs, 32, 32, 3).astype(np.float32)
        labels = rng.randint(0, 10, W * bs).astype(np.int32)
        clock = np.asarray([3.0 + s, 7.0], np.float32)
        key = jax.random.PRNGKey(s)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                           key, jax.device_put(clock, sh))
        phases = [_jphases(jsetup.engine, jax.random.split(
            jax.random.fold_in(key, w))[1]) for w in range(W)]
        setup.engine.draw_phases = lambda gen, _p=iter(phases): next(_p)
        xs = [torch.from_numpy(images[w * bs:(w + 1) * bs]).permute(
            0, 3, 1, 2) for w in range(W)]
        ys = [torch.from_numpy(labels[w * bs:(w + 1) * bs]).long()
              for w in range(W)]
        before = dict(comm.calls)
        state, m = tstep.train_step(
            model, setup, tdist, state, xs, ys, [None] * W,
            telemetry=True, fleet=True, clock=torch.from_numpy(clock))
        # the plain step: one all-gather a lane and two all-reduces (the
        # dense tail, the loss); the fleet gather is one all-gather more
        lanes = len(setup.engine.encode(
            *setup.engine.compress(torch.zeros(setup.layout.total),
                                   setup.engine.init_memory("cpu"),
                                   phases[0]),
            setup.engine.init_memory("cpu"))[0])
        assert (comm.calls["all_gather"] - before["all_gather"]
                == lanes + 1)
        assert comm.calls["all_reduce"] - before["all_reduce"] == 2
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        for group in ("telemetry", "fleet"):
            assert set(m[group]) == set(jm[group])
            for k, val in m[group].items():
                got, want = val.numpy(), np.asarray(jm[group][k])
                assert got.shape == want.shape, (group, k)
                if k in ("w_clock", "w_eff_ratio", "w_staleness",
                         "straggler", "straggler_gap", "adaptive_engaged",
                         "max_staleness_seen", "gossip_forced_syncs",
                         "wire_bytes"):
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-3,
                                               atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(m["fleet"]["w_clock"].numpy(), clock)


def test_telemetry_step_adds_one_all_reduce():
    """Without the fleet taps the stats ride one packed all-reduce."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.train import Trainer
    calls = {}
    for tel in (False, True):
        cfg = configs.resnet20_wm5()
        cfg.dataset.synthetic_size = 32
        cfg.train.batch_size = 4
        if tel:
            configs.with_telemetry(cfg, fleet=False, trace=False)
        comm = _Recording(2)
        t = Trainer(cfg, comm, "cpu")
        seen = []
        t.run_epoch(5, 2, on_step=lambda b, m: seen.append(m))
        calls[tel] = dict(comm.calls)
        if tel:
            assert set(seen[-1]["telemetry"]) == set(
                registry.step_stat_names())
            assert "fleet" not in seen[-1]
    assert calls[True]["all_gather"] == calls[False]["all_gather"]
    assert calls[True]["all_reduce"] == calls[False]["all_reduce"] + 2


# --------------------------------------------------------------------- #
# the host half on the port's shards                                     #
# --------------------------------------------------------------------- #

def _write_run(root, steps=40, bad_worker=2):
    """Two hosts' fleet shards (rotated), a torn tail on host 1, and a
    worker whose residual mass walks away from the cohort."""
    rng = np.random.RandomState(11)
    for h in range(2):
        s = sink.TelemetrySink(os.path.join(root, "telemetry", f"host{h}"),
                               static={"engine": "FlatDGCEngine",
                                       "world": 4},
                               rotate_bytes=6000, fleet=True)
        for step in range(steps):
            mass = 100.0 + rng.randn(4).astype(np.float32)
            if step > 20:
                mass[bad_worker] *= 1.0 + 0.2 * (step - 20)
            clock = np.asarray([10.0, 10.0, 10.0, 30.0], np.float32) + (
                rng.rand(4).astype(np.float32))
            st = {k: torch.tensor(float(rng.rand()))
                  for k in registry.step_stat_names()}
            st.update({"w_clock": torch.from_numpy(clock),
                       "w_residual_mass": torch.from_numpy(mass),
                       "w_grad_norm": torch.from_numpy(
                           rng.rand(4).astype(np.float32) + 5),
                       "worker_skew": torch.tensor(0.1 * h + 0.05),
                       "straggler_gap": torch.tensor(20.0)})
            s.write(step, st)
        s.write_record({"event": "engine_rebuild", "epoch": h})
        s.close()
    with open(os.path.join(root, "telemetry", "host1",
                           "telemetry.jsonl"), "a") as fh:
        fh.write('{"step": 99, "w_clock": [1.0, ')


def test_host_readers_match_jax(tmp_path):
    run = str(tmp_path / "fleetroot" / "run_a")
    _write_run(run)
    assert tfleet.discover_shards(run) == jfleet.discover_shards(run)
    assert len(tfleet.discover_shards(run)["host0"]) > 1     # rotated
    tv, jv = tfleet.load_view(run), jfleet.load_view(run)
    assert tv.skipped == jv.skipped == 1
    assert tv.world == jv.world == 4
    assert tv.hosts == jv.hosts and tv.events == jv.events
    for metric in ("w_residual_mass", "w_clock", "grad_norm"):
        assert (tfleet.worker_series(tv, metric)
                == jfleet.worker_series(jv, metric))
    series = tfleet.worker_series(tv, "w_residual_mass")
    talerts = tfleet.detect_desync(series)
    assert talerts == jfleet.detect_desync(series) and talerts
    assert {a.worker for a in talerts} == {2}
    assert tfleet.straggler_table(tv) == jfleet.straggler_table(jv)
    assert tfleet.straggler_table(tv)[0]["worker"] == 3
    assert tfleet.fleet_summary(tv) == jfleet.fleet_summary(jv)
    root = str(tmp_path / "fleetroot")
    assert tfleet.discover_runs(root) == jfleet.discover_runs(root)
    with pytest.raises(FileNotFoundError):
        tfleet.load_view(str(tmp_path / "nothing"))


def test_serving_readers_match_jax(tmp_path):
    d = tmp_path / "run" / "serving"
    d.mkdir(parents=True)
    (d / "manifest.json").write_text(json.dumps({
        "base_version": 2, "latest_seq": 9, "max_lag": 3,
        "wire_bytes_per_update": 100, "full_checkpoint_bytes": 1000,
        "lineage": {"run": "a"}}))
    for name, seq, health in (("r0", 9, "ok"), ("r1", 4, "ok"),
                              ("r2", 9, "gap")):
        (d / f"replica_{name}.json").write_text(json.dumps({
            "event": "replica_status", "replica": name, "base_version": 2,
            "delta_seq": seq, "latest_seq": 9, "staleness": 9 - seq,
            "max_lag": 3, "health": health, "t": 0.0}))
    (d / "replica_bad.json").write_text('{"event": "replica_status"}')
    run = str(tmp_path / "run")
    assert tfleet.discover_serving(run) == jfleet.discover_serving(run)
    got = tfleet.serving_summary(str(d))
    assert got == jfleet.serving_summary(str(d))
    assert got["stale_replicas"] == ["r1", "r2"] and got["bad_status"] == 1
