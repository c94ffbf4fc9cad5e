"""The resilience layer's pieces against the JAX package (test_resilience.py's
oracles): the fault grammar, the guards' transition, the payload checksum
and its count, the index clamp, the preemption handler, the watchdog and
the flight recorder.

The guard transition and the checksum are integer and elementwise work:
bitwise the JAX functions. The checksum is compared on f32, f16 and bf16
value lanes and int32 / int64 index lanes, including words whose int32
sums wrap."""

import io
import json
import signal
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dgc_tpu.resilience import GuardConfig as JGuardConfig
from dgc_tpu.resilience import faults as jfaults
from dgc_tpu.resilience import guard as jguard
from dgc_tpu.resilience import integrity as jintegrity
from dgc_tpu.telemetry import flight as jflight
from dgc_tpu_torch.resilience import faults, guard, integrity, preempt
from dgc_tpu_torch.telemetry import flight

_PLANS = ("", "nan@2, bitflip:elem=3:bit=7, kill@5, init_fail@2, "
          "badidx:elem=1:set=-4", "bitflip", "badidx:set=99999",
          "slow:ms=50", "slow@3-7:ms=20", "slow:ms=20@4", "hang:secs=2@3",
          "hang@1-2", "exit:code=9@4", "exit@2-5", "droplink:peer=1@2-4",
          "nan@0,kill@1")


@pytest.mark.parametrize("spec", _PLANS)
def test_fault_grammar_parses_as_jax(spec):
    assert tuple(faults.plan(spec)) == tuple(jfaults.plan(spec))


def test_fault_grammar_refusals(monkeypatch):
    for bad in ("tyop@3", "droplink@2"):
        with pytest.raises(ValueError):
            jfaults.plan(bad)
        with pytest.raises(ValueError):
            faults.plan(bad)
    monkeypatch.delenv(faults.ENV, raising=False)
    assert not faults.armed() and faults.active_plan() is None
    assert not faults.should_fail_init(0)
    monkeypatch.setenv(faults.ENV, "nan@0,init_fail@2")
    assert faults.armed() and faults.active_plan().nan_step == 0
    assert [faults.should_fail_init(a) for a in range(3)] == [
        jfaults.should_fail_init(a) for a in range(3)] == [True, True, False]
    # droplink arms as in the JAX package: the same plan, and the same
    # dropped vector at every gossip round of its window
    for spec in ("droplink:peer=1", "droplink:peer=9@2-3"):
        monkeypatch.setenv(faults.ENV, spec)
        p = faults.active_plan()
        assert tuple(p) == tuple(jfaults.plan())
        for clock in range(5):
            want = jfaults.gossip_dropped(8, jnp.asarray(clock, jnp.int32))
            got = faults.gossip_dropped(p, 8, torch.tensor(clock,
                                                           dtype=torch.int32))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    monkeypatch.setenv(faults.ENV, "nan@0")
    assert faults.gossip_dropped(faults.active_plan(), 8,
                                 torch.zeros((), dtype=torch.int32)) is None
    assert jfaults.gossip_dropped(8, jnp.zeros((), jnp.int32)) is None


def test_injectors_copy_and_match_jax():
    p = faults.plan("bitflip:elem=5:bit=30,badidx:elem=9:set=-5,nan@3")
    rng = np.random.RandomState(0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float16, jnp.float16)):
        v = torch.from_numpy(rng.randn(4, 6).astype(np.float32)).to(dt)
        got = faults.corrupt_wire(p, v)
        assert got is not v and not torch.equal(got.view(-1)[5:6].view(
            torch.int16 if dt == torch.float16 else torch.int32),
            v.view(-1)[5:6].view(torch.int16 if dt == torch.float16
                                 else torch.int32))
        with pytest.MonkeyPatch.context() as m:
            m.setenv(jfaults.ENV, "bitflip:elem=5:bit=30")
            want = np.asarray(jfaults.corrupt_wire(jnp.asarray(
                v.float().numpy(), jdt)))
        np.testing.assert_array_equal(
            got.numpy().view(np.int16 if dt == torch.float16 else np.int32),
            want.view(np.int16 if dt == torch.float16 else np.int32))
    i = torch.arange(24, dtype=torch.int32).view(4, 6)
    got = faults.corrupt_indices(p, i)
    assert got is not i and int(got.view(-1)[9]) == -5
    assert int(i.view(-1)[9]) == 9
    g = [torch.ones(3), torch.ones(3)]
    assert faults.inject_nan_grads(p, g, 2) is g
    assert all(torch.isnan(x).all() for x in faults.inject_nan_grads(p, g, 3))
    assert faults.corrupt_wire(None, i) is i


def test_guard_config_validation():
    for kw in (dict(spike_window=-1), dict(spike_window=4, spike_factor=1.0)):
        with pytest.raises(ValueError):
            JGuardConfig(**kw)
        with pytest.raises(ValueError):
            guard.GuardConfig(**kw)


def _same_state(t, j):
    assert set(t) == set(j)
    for k in t:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("cfg", [
    dict(nonfinite=False, spike_window=2, spike_factor=2.0),
    dict(nonfinite=True, spike_window=3, spike_factor=4.0),
    dict(nonfinite=True)])
def test_guard_transition_matches_jax(cfg):
    """The breaker's window semantics (arms when full, trips on loss >
    factor x mean, spiked losses enter the window, non-finite ones never)
    and the non-finite count, step by step against ``guard.apply``."""
    tc, jc = guard.GuardConfig(**cfg), JGuardConfig(**cfg)
    ts, js = guard.init_state(tc), jguard.init_state(jc)
    _same_state(ts, js)
    losses = [1.0, 1.0, 10.0, 1.0, 5.0, float("nan"), 2.0, 40.0, 1.5]
    bads = [0, 0, 0, 1, 0, 0, 2, 0, 0]
    chk = [0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 1.0]
    skips = []
    for v, b, c in zip(losses, bads, chk):
        tskip, ts, tm = guard.apply(
            tc, ts, bad_count=torch.tensor(float(b)),
            mean_loss=torch.tensor(v), checksum_failures=torch.tensor(c))
        jskip, js, jm = jguard.apply(
            jc, js, bad_count=jnp.asarray(float(b)),
            mean_loss=jnp.asarray(v), checksum_failures=jnp.asarray(c))
        assert bool(tskip) == bool(jskip)
        skips.append(bool(tskip))
        _same_state(ts, js)
        _same_state(tm, jm)
    if cfg == dict(nonfinite=False, spike_window=2, spike_factor=2.0):
        # the JAX test's sequence: warm-up, a 10x spike trips, recovery
        assert skips[:5] == [False, False, True, False, False]


def test_tree_select_and_snapshot():
    skip, keep = torch.tensor(True), torch.tensor(False)
    old = {"a": torch.zeros(3), "b": [torch.ones(2)]}
    snap = guard.snapshot(old)
    assert snap["a"] is not old["a"]
    new = {"a": torch.full((3,), 2.0), "b": [torch.full((2,), 3.0)]}
    assert torch.equal(guard.tree_select(skip, snap, new)["b"][0],
                       torch.ones(2))
    assert torch.equal(guard.tree_select(keep, snap, new)["a"],
                       torch.full((3,), 2.0))
    g = torch.tensor([1.0, float("inf")])
    assert float(guard.nonfinite_flag(g, torch.tensor(1.0))) == 1.0
    assert float(guard.nonfinite_flag(torch.ones(2),
                                      torch.tensor(float("nan")))) == 1.0
    assert float(guard.nonfinite_flag(torch.ones(2), torch.tensor(1.0))) == 0


def _to_jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("vdt", [torch.float32, torch.float16,
                                 torch.bfloat16])
@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
def test_payload_checksum_bitwise_jax(vdt, idt):
    """Per-bucket words bitwise ``integrity.payload_checksum`` (the int32
    wraparound sum), on values with specials (±0, ±inf, NaN, large) and
    indices up to 2**31 - 1, over [payload] and [W, payload]."""
    rng = np.random.RandomState(int(str(vdt)[-2:]) + (idt == torch.int64))
    nb, per = 5, 3000
    seg = np.repeat(np.arange(nb, dtype=np.int32), per)
    v = rng.randn(nb * per).astype(np.float32) * 1e4
    v[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 3e38]
    vals = torch.from_numpy(v).to(vdt)
    idx = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, nb * per)).to(idt)
    got = integrity.payload_checksum(vals, idx, torch.from_numpy(seg), nb)
    want = jintegrity.payload_checksum(
        _to_jnp(vals), jnp.asarray(idx.to(torch.int32).numpy()), seg, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # [W, payload]: each worker's row, and the mismatch count
    gv, gi = torch.stack([vals, vals.flip(0)]), torch.stack([idx, idx])
    g_chk = integrity.payload_checksum(gv, gi, torch.from_numpy(seg), nb)
    np.testing.assert_array_equal(g_chk[0].numpy(), got.numpy())
    assert float(integrity.count_mismatches(
        gv, gi, g_chk, torch.from_numpy(seg), nb)) == 0.0
    bad = gi.clone()
    bad[1, 4000] += 1
    bad[0, 2] += 7
    n = integrity.count_mismatches(gv, bad, g_chk, torch.from_numpy(seg), nb)
    assert n.dtype == torch.float32 and float(n) == 2.0
    jn = jintegrity.count_mismatches(
        _to_jnp(gv), jnp.asarray(bad.to(torch.int32).numpy()),
        jnp.asarray(g_chk.numpy()), seg, nb)
    assert float(jn) == 2.0


def test_bucket_segments_match_jax():
    """The slot -> bucket map (the clamp itself is the engine's decode:
    test_torch_checksum.py's bad indices)."""
    class B:
        def __init__(self, p):
            self.payload = p
    bs = [B(3), B(0), B(5)]
    np.testing.assert_array_equal(integrity.bucket_segments(bs),
                                  jintegrity.bucket_segments(bs))


def test_preemption_handler_sets_flag_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with preempt.PreemptionHandler() as h:
        assert not h.requested
        signal.raise_signal(signal.SIGTERM)
        assert h.requested and h.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev


def test_agree_preempt_single_process_short_circuits():
    assert preempt.agree_preempt(True) is True
    assert preempt.agree_preempt(False) is False


def test_watchdog_detects_stall_and_dumps_flight(tmp_path):
    """Silence past the timeout: the stacks, one flight dump, the
    callback; the clock rearms. A beating loop stays quiet."""
    stream, hits = io.StringIO(), []
    rec = flight.FlightRecorder(capacity=4, static={"world": 2})
    rec.record(1, loss=torch.tensor(2.5))
    path = str(tmp_path / "flight.json")
    with preempt.Watchdog(0.2, interval=0.05, stream=stream, flight=rec,
                          flight_path=path,
                          on_stall=lambda: hits.append(1)) as wd:
        time.sleep(0.6)
    assert wd.stalls >= 1 and hits
    assert "no step progress" in stream.getvalue()
    dump = flight.load_dump(path)
    assert dump["records"][0]["loss"] == 2.5
    assert dump["reason"].startswith("watchdog stall")
    quiet = io.StringIO()
    with preempt.Watchdog(0.5, interval=0.05, stream=quiet) as wd:
        for _ in range(8):
            time.sleep(0.05)
            wd.beat()
    assert wd.stalls == 0 and quiet.getvalue() == ""
    with pytest.raises(ValueError):
        preempt.Watchdog(0)


def test_flight_recorder_and_streak_match_jax(tmp_path):
    """The ring, its dump (schema ``dgc-flight`` v1, readable by the JAX
    package's loader; tensors converted at dump time) and the non-finite
    streak breaker."""
    rec = flight.FlightRecorder(capacity=3, static={"world": 4})
    for s in range(5):
        rec.record(s, loss=torch.tensor([float(s)]),
                   guards={"skipped_steps": torch.tensor(1.0)})
    assert len(rec) == 3
    p = rec.dump(str(tmp_path / "f.json"), reason="test")
    obj = jflight.load_dump(p)
    assert [r["step"] for r in obj["records"]] == [2, 3, 4]
    assert obj["records"][0]["loss"] == [2.0]
    assert obj["records"][0]["guards"]["skipped_steps"] == 1.0
    assert json.load(open(p))["static"] == {"world": 4}
    for seq in ([1.0, float("nan"), float("inf"), float("nan"), 1.0],
                [float("nan"), 1.0, float("nan"), float("nan")]):
        t, j = flight.NonfiniteStreak(3), jflight.NonfiniteStreak(3)
        assert [t.update(x) for x in seq] == [j.update(x) for x in seq]


def test_init_retry_recovers_from_injected_failures(monkeypatch):
    """``init_fail@2``: the first two process-group starts raise, the third
    succeeds (one gloo process through the launcher's triple)."""
    import torch.distributed as dist
    from dgc_tpu_torch.parallel import multihost
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
              "RANK", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LAUNCH_NODE_IPADDR",
              "TORCHELASTIC_USE_AGENT_STORE"):
        monkeypatch.delenv(k, raising=False)
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv(faults.ENV, "init_fail@2")
    monkeypatch.setattr(multihost.time, "sleep", lambda s: None)
    try:
        assert multihost.initialize_multihost("cpu", init_retries=3)
        assert dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    monkeypatch.setenv(faults.ENV, "init_fail@5")
    with pytest.raises(RuntimeError, match="injected"):
        multihost.initialize_multihost("cpu", init_retries=3)
