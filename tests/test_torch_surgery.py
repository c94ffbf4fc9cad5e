"""The port's cohort surgery (``dgc_tpu_torch.resilience.surgery``) against
the JAX package's (``dgc_tpu.resilience.surgery``) on the CPU.

* The files: an order or exit record one package writes, the other reads
  the same, and both degrade torn or malformed files to "none".
* The agreement's lanes: ``encode_lanes`` / ``decode_lanes`` bitwise the
  reference's on the same cases; ``shrink_updates`` (the launcher's
  ``JAX_NUM_PROCESSES`` key) and ``remap_process_id`` over a grid.
* ``probe_checksum`` of tensors (f32, int, bool, 0-d, non-contiguous,
  bf16) is the reference's hex of the same values as arrays: numpy's shape
  and dtype strings, not torch's.
* The coordinator with an injected allgather: a quiet boundary, an agreed
  excise, the deadline and its retries ending in ``lost``, a collective
  error, a late arrival inside the budget, the single-process short
  circuit — each the reference's ``Agreement``.
* Two processes over gloo: the order only one of them reads is agreed by
  both through the one gather, with the other's preemption flag.
* The CLI: ``--surgery --device cpu --world 2`` with an excise order
  published before step 2 exits 76 with the exit record, the order
  cleared, and an emergency checkpoint from which the same command
  resumes bitwise the uninterrupted run; its lost-cohort exit dumps the
  flight ring and writes the record before ``os._exit(76)``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.resilience import surgery as jsurgery
from dgc_tpu_torch import train
from dgc_tpu_torch.resilience import surgery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match_reference():
    assert surgery.EXIT_SURGERY == jsurgery.EXIT_SURGERY == 76
    assert surgery.ORDER_FILE == jsurgery.ORDER_FILE
    assert surgery.EXIT_RECORD == jsurgery.EXIT_RECORD
    assert surgery.VERDICTS == jsurgery.VERDICTS


@pytest.mark.parametrize("writer,reader", [(surgery, jsurgery),
                                           (jsurgery, surgery)])
def test_order_and_exit_record_files_cross_packages(tmp_path, writer,
                                                    reader):
    path = str(tmp_path / surgery.ORDER_FILE)
    assert reader.read_order(path) is None
    writer.publish_order(path, "desync", 2, step=30, extra={"rule": 3})
    got = reader.read_order(path)
    assert got == surgery.read_order(path) == jsurgery.read_order(path)
    assert (got["verdict"], got["target"], got["step"], got["rule"]) == (
        "desync", 2, 30, 3)
    for bad in ("none", "bogus"):
        with pytest.raises(ValueError):
            writer.publish_order(path, bad, 1)
    for torn in ('{"verdict": "des', json.dumps({"verdict": "desync"}),
                 json.dumps(["not", "a", "dict"])):
        with open(path, "w") as f:
            f.write(torn)
        assert reader.read_order(path) is None
    writer.clear_order(path)
    writer.clear_order(path)
    assert reader.read_order(path) is None
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]

    rec_path = str(tmp_path / surgery.EXIT_RECORD)
    assert reader.read_exit_record(rec_path) is None
    ag = writer.Agreement(excise=True, target=1, verdict="hang", lost=True)
    writer.write_exit_record(rec_path, ag, world=3, process_index=0, step=17)
    rec = reader.read_exit_record(rec_path)
    assert {k: rec[k] for k in ("verdict", "target", "lost", "world",
                                "process_index", "step")} == dict(
        verdict="hang", target=1, lost=True, world=3, process_index=0,
        step=17)


def _lane_cases():
    none = (False, None)
    yield [none, none, none]
    yield [(True, None), none, (False, {"verdict": "desync", "target": 2})]
    yield [(False, {"verdict": "desync", "target": 1}),
           (False, {"verdict": "hang", "target": 2})]
    yield [(True, {"verdict": "manual", "target": 0})]
    yield [(False, {"verdict": "straggler", "target": 5}), (True, None)]
    yield [(False, {"verdict": "unknown", "target": 3})]


@pytest.mark.parametrize("case", range(6))
def test_lanes_match_reference(case):
    rows = list(_lane_cases())[case]
    t = [surgery.encode_lanes(p, o) for p, o in rows]
    j = [jsurgery.encode_lanes(p, o) for p, o in rows]
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert surgery.decode_lanes(np.stack(t)) == jsurgery.decode_lanes(
        np.stack(j))
    # a verdict with no target is not an excise
    odd = np.asarray([[0.0, 4.0, 0.0], [0.0, 9.0, 3.0]], np.float32)
    assert surgery.decode_lanes(odd) == jsurgery.decode_lanes(odd)


def test_shrink_and_remap_match_reference():
    for world in range(0, 6):
        for target in range(-2, 7):
            assert surgery.shrink_updates(world, target) == \
                jsurgery.shrink_updates(world, target)
            for pid in range(0, 6):
                assert surgery.remap_process_id(pid, target) == \
                    jsurgery.remap_process_id(pid, target)
    assert surgery.shrink_updates(3, 2) == {"JAX_NUM_PROCESSES": "2"}


def test_probe_checksum_of_tensors_is_the_references():
    rng = np.random.RandomState(0)
    arrays = [rng.randn(48, 32).astype(np.float32),
              np.arange(7, dtype=np.int64), np.array(rng.rand(5) > 0.5),
              np.float32(0.5), rng.randint(0, 9, (3, 4, 2)).astype(np.int32)]
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    assert surgery.probe_checksum(tensors) == jsurgery.probe_checksum(arrays)
    assert surgery.probe_checksum(arrays) == jsurgery.probe_checksum(arrays)
    # a non-contiguous view hashes its values in C order
    m = rng.randn(6, 8).astype(np.float32)
    assert surgery.probe_checksum([torch.from_numpy(m).t()]) == \
        jsurgery.probe_checksum([m.T])
    bf = rng.randn(16).astype(np.float32)
    assert surgery.probe_checksum([torch.from_numpy(bf).bfloat16()]) == \
        jsurgery.probe_checksum([jnp.asarray(bf, jnp.bfloat16)])
    assert surgery.probe_checksum([tensors[0]]) != surgery.probe_checksum(
        [tensors[0].reshape(32, 48)])


def _coordinators(mod, order_path, allgather, **kw):
    return mod.SurgeryCoordinator(order_path, allgather=allgather,
                                  log=lambda m: None, **kw)


def test_coordinator_paths_match_reference(tmp_path):
    order_path = str(tmp_path / surgery.ORDER_FILE)

    def cohort(mod):
        def gather(payload):
            quiet = mod.encode_lanes(False, None)
            return np.stack([payload, quiet, quiet])
        return gather

    def both(make):
        return [make(m) for m in (surgery, jsurgery)]

    three = dict(process_index=0, process_count=3)
    t, j = both(lambda m: _coordinators(m, order_path, cohort(m),
                                        boundary_timeout=5.0, retries=1,
                                        backoff=0.05, **three))
    assert t.agree(False) == j.agree(False) == surgery.Agreement()
    surgery.publish_order(order_path, "straggler", 1)
    assert t.agree(True) == j.agree(True) == surgery.Agreement(
        preempt=True, excise=True, target=1, verdict="straggler")
    assert not t.excised(t.agree(False))
    assert t.excised(surgery.Agreement(excise=True, target=0))

    # the deadline and its retries: lost, within the budget
    t, j = both(lambda m: _coordinators(
        m, order_path, lambda p: time.sleep(30), boundary_timeout=0.05,
        retries=2, backoff=0.05, **three))
    t0 = time.time()
    assert t.agree(False) == j.agree(False) == surgery.Agreement(
        lost=True, verdict="hang")
    assert time.time() - t0 < 5.0

    def boom(payload):
        raise RuntimeError("connection reset by peer")
    t, j = both(lambda m: _coordinators(m, order_path, boom,
                                        boundary_timeout=1.0, retries=0,
                                        **three))
    assert t.agree(False).lost and j.agree(False).lost

    def late(mod):
        def gather(payload):
            time.sleep(0.3)
            return cohort(mod)(payload)
        return gather
    t, j = both(lambda m: _coordinators(m, order_path, late(m),
                                        boundary_timeout=0.1, retries=3,
                                        backoff=0.15, **three))
    assert t.agree(False) == j.agree(False)
    assert t.agree(False).excise

    def forbidden(payload):
        raise AssertionError("single-process agree must not communicate")
    t, j = both(lambda m: _coordinators(m, order_path, forbidden,
                                        process_index=0, process_count=1))
    assert t.agree(False) == j.agree(False) == surgery.Agreement(
        excise=True, target=1, verdict="straggler")
    surgery.clear_order(order_path)
    assert t.agree(True) == surgery.Agreement(preempt=True)
    # without a group the topology is one process
    solo = surgery.SurgeryCoordinator(order_path, allgather=forbidden)
    assert solo._topology() == (0, 1)


def test_gather_lanes_use_the_callers_card(tmp_path, monkeypatch):
    """The current CUDA device is per thread, and the gather runs on a
    side thread whose current device is card 0. The lanes must go to the
    caller's card (card 1 here, as ``cuda:<local rank>`` on a node of
    several cards)."""
    import threading

    import torch.distributed as dist
    main = threading.main_thread()
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: 1 if threading.current_thread() is main
                        else 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    seen = []

    def gather(payload, device):
        seen.append((threading.current_thread() is main,
                     torch.device(device)))
        quiet = surgery.encode_lanes(False, None)
        return np.stack([payload, quiet])
    monkeypatch.setattr(surgery, "_default_allgather", gather)
    coord = surgery.SurgeryCoordinator(
        str(tmp_path / surgery.ORDER_FILE), process_index=0,
        process_count=2, log=lambda m: None)
    assert coord.agree(True) == surgery.Agreement(preempt=True)
    assert seen == [(False, torch.device("cuda:1"))]


_AGREE = """
import json, sys
import torch.distributed as dist
from dgc_tpu_torch.resilience import surgery
url, rank, order = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=url, world_size=2, rank=rank)
coord = surgery.SurgeryCoordinator(order, boundary_timeout=60.0,
                                   log=lambda m: None)
out = [coord.agree(rank == 0)._asdict()]
surgery.clear_order(order) if rank == 1 else None
dist.barrier()
out.append(coord.agree(False)._asdict())
out.append(list(coord._topology()))
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_agreement_over_gloo(tmp_path):
    """Process 1 reads an excise order for itself, process 0 reads none
    but was preempted: one gather, and both agree on both; at the next
    boundary (the order cleared) both agree on a quiet one."""
    url = f"tcp://localhost:{_free_port()}"
    orders = [str(tmp_path / "none.json"), str(tmp_path / "order.json")]
    surgery.publish_order(orders[1], "straggler", 1)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _AGREE, url, str(r), orders[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    want = surgery.Agreement(preempt=True, excise=True, target=1,
                             verdict="straggler")._asdict()
    for r, g in enumerate(got):
        assert g[0] == want
        assert g[1] == surgery.Agreement()._asdict()
        assert g[2] == [r, 2]


ARGS = ["--config", "resnet20_wm5_resilience", "--device", "cpu",
        "--world", "2", "--batch-size", "4", "--synthetic-size", "64",
        "--epochs", "1", "--steps", "3"]
RUN = "runs/cifar.resnet20+dgc.wm5+resilience{}.np2"


def test_cli_refuses_surgery_without_the_resilience_block(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="needs train.resilience"):
        train.main(["--config", "resnet20_wm5", "--device", "cpu",
                    "--surgery"])


def test_cli_excise_exits_76_and_resumes_bitwise(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    want = train.main(ARGS + ["--suffix", ".full"])
    capsys.readouterr()
    stop = train._Resilience.stop

    def stop_publishing(self, epoch):
        check = stop(self, epoch)

        def publish_then_check(batch):
            if batch == 1:
                surgery.publish_order(
                    os.path.join(self.ckpt_dir, surgery.ORDER_FILE),
                    "manual", 0, step=1)
            return check(batch)
        return publish_then_check
    monkeypatch.setattr(train._Resilience, "stop", stop_publishing)
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--surgery"])
    assert e.value.code == surgery.EXIT_SURGERY
    out = capsys.readouterr().out
    assert ("[surgery] excise agreed: verdict=manual target=0 — stopping "
            "at epoch 0, batch 0") in out
    ckpt = os.path.join(RUN.format(""), "checkpoints")
    rec = jsurgery.read_exit_record(os.path.join(ckpt, surgery.EXIT_RECORD))
    assert {k: rec[k] for k in ("verdict", "target", "lost", "world",
                                "process_index", "step")} == dict(
        verdict="manual", target=0, lost=False, world=1, process_index=0,
        step=1)
    assert not os.path.exists(os.path.join(ckpt, surgery.ORDER_FILE))
    meters = json.load(open(os.path.join(ckpt, "e0", "meters.json")))
    assert meters["preempt_batch"] == 0
    monkeypatch.setattr(train._Resilience, "stop", stop)
    resumed = train.main(ARGS + ["--surgery"])
    assert "[resumed] mid-epoch 0 at batch 1" in capsys.readouterr().out
    assert resumed == want[1:]
    a = torch.load(os.path.join(ckpt, "e0", "state.pt"), weights_only=True)
    b = torch.load(os.path.join(RUN.format(".full"), "checkpoints", "e0",
                                "state.pt"), weights_only=True)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_lost_cohort_dumps_records_and_exits_76(tmp_path, monkeypatch):
    """The CLI's lost-cohort exit (``_Resilience._cohort_lost``): the
    flight ring dumped with the reason, the exit record (``lost``, the
    verdict ``hang``, the step), then ``os._exit(76)``."""
    from types import SimpleNamespace

    from dgc_tpu_torch.telemetry.flight import FlightRecorder, load_dump

    def exit_now(code):
        raise SystemExit(code)
    monkeypatch.setattr(train.os, "_exit", exit_now)
    res = SimpleNamespace(
        flight=FlightRecorder(capacity=4), gstep=5,
        flight_path=str(tmp_path / "flight.json"), ckpt_dir=str(tmp_path),
        surgeon=surgery.SurgeryCoordinator(str(tmp_path / "order.json"),
                                           process_index=1,
                                           process_count=3))
    res._exit_record = lambda ag: train._Resilience._exit_record(res, ag)
    res.flight.record(5, loss=1.0)
    with pytest.raises(SystemExit) as e:
        train._Resilience._cohort_lost(res, surgery.Agreement(
            lost=True, verdict="hang"))
    assert e.value.code == 76
    assert load_dump(res.flight_path)["reason"] == "surgery: cohort lost"
    rec = jsurgery.read_exit_record(str(tmp_path / surgery.EXIT_RECORD))
    assert {k: rec[k] for k in ("verdict", "target", "lost", "world",
                                "process_index", "step")} == dict(
        verdict="hang", target=-1, lost=True, world=3, process_index=1,
        step=5)
