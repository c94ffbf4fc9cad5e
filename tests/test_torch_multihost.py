"""The port's multi-process start-up (``parallel/multihost.py``) against
the JAX package's: the same process count, rank and coordinator from the
same environment (the JAX side with ``jax.distributed.initialize``
patched out), the same refusal of a partial set, the same batch slices;
torchrun's variables; the bounded retry; and a two-process gloo run of
the harness launched through the environment, whose losses are
``LocalComm(2)``'s."""

import json
import os
import socket
import subprocess
import sys

import jax
import pytest
import torch

from dgc_tpu.parallel import multihost as jmh
from dgc_tpu_torch import configs
from dgc_tpu_torch.parallel import multihost as mh
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: these are many small CPU
    ops, no faster on several threads, and the files run beside other
    test workers, where several threads a worker oversubscribe the cores
    and slow every op by orders of magnitude. (A convolution's backward
    sums in another order at another thread count: each comparison here
    stays within one process, or sets one thread in its subprocesses.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: every variable either side reads
_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
         "SLURM_NTASKS", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT",
         "WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_LOCALID",
         "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS")

ENVS = {
    "none": {},
    "triple": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
               "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"},
    "slurm": {"JAX_COORDINATOR_ADDRESS": "node0:8476", "SLURM_NTASKS": "8",
              "SLURM_PROCID": "5"},
    "triple_over_slurm": {"JAX_COORDINATOR_ADDRESS": "h:1",
                          "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
                          "SLURM_NTASKS": "8", "SLURM_PROCID": "5"},
}

PARTIAL = {
    "count_and_rank": {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
    "slurm_alone": {"SLURM_NTASKS": "4", "SLURM_PROCID": "1"},
    "address_alone": {"JAX_COORDINATOR_ADDRESS": "h:1"},
    "no_rank": {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2"},
}


@pytest.fixture
def env(monkeypatch):
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)

    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
    return set_env


def _jax_launch(monkeypatch):
    """What the JAX ``initialize_multihost`` hands to
    ``jax.distributed.initialize``; None when it starts nothing."""
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    if not jmh.initialize_multihost(init_retries=1):
        return None
    (kw,) = calls
    return kw["coordinator_address"], kw["num_processes"], kw["process_id"]


@pytest.mark.parametrize("case", sorted(ENVS))
def test_resolves_what_jax_resolves(case, env, monkeypatch):
    env(ENVS[case])
    assert mh.resolve_launch() == _jax_launch(monkeypatch)


@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_partial_set_raises_like_jax(case, env, monkeypatch):
    env(PARTIAL[case])
    with pytest.raises(RuntimeError, match="partial"):
        _jax_launch(monkeypatch)
    with pytest.raises(RuntimeError, match="partial") as e:
        mh.resolve_launch()
    assert "missing" in str(e.value)


@pytest.mark.parametrize("values, want", [
    ({"MASTER_ADDR": "a", "MASTER_PORT": "29500", "WORLD_SIZE": "2",
      "RANK": "1"}, ("a:29500", 2, 1)),
    ({"MASTER_ADDR": "a", "MASTER_PORT": "1", "WORLD_SIZE": "1",
      "RANK": "0"}, ("a:1", 1, 0)),
    # the launch scripts' triple comes first
    ({"MASTER_ADDR": "a", "MASTER_PORT": "1", "WORLD_SIZE": "2",
      "RANK": "0", "JAX_COORDINATOR_ADDRESS": "b:2",
      "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"}, ("b:2", 4, 3)),
])
def test_torchrun_variables(values, want, env):
    env(values)
    assert mh.resolve_launch() == want


@pytest.mark.parametrize("values", [
    {"MASTER_ADDR": "a", "WORLD_SIZE": "2", "RANK": "0"},
    {"WORLD_SIZE": "2", "RANK": "0"},
])
def test_torchrun_partial_raises(values, env):
    env(values)
    with pytest.raises(RuntimeError, match="partial"):
        mh.resolve_launch()


@pytest.mark.parametrize("batch, n, i", [(8, 2, 1), (12, 3, 0), (7, 1, 0),
                                         (10, 5, 4), (9, 2, 0), (10, 3, 2)])
def test_local_batch_slice_matches_jax(batch, n, i):
    if batch % n:
        for f in (mh.local_batch_slice, jmh.local_batch_slice):
            with pytest.raises(ValueError, match="split evenly"):
                f(batch, n, i)
    else:
        assert mh.local_batch_slice(batch, n, i) == jmh.local_batch_slice(
            batch, n, i)
    # no process group: this process is the coordinator and feeds it all
    assert mh.is_coordinator()
    assert mh.local_batch_slice(batch) == slice(0, batch)


def test_single_process_starts_nothing(env, monkeypatch):
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("started a group"))
    assert mh.initialize_multihost("cpu") is False


def test_bounded_retry_with_backoff(env, monkeypatch):
    env(ENVS["triple"])
    calls, sleeps = [], []

    def init(backend, **kw):
        calls.append((backend, kw))
        if len(calls) < 3:
            raise RuntimeError("connection refused")
    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.setattr(mh.time, "sleep", sleeps.append)
    assert mh.initialize_multihost("cpu", init_backoff=0.5)
    assert sleeps == [0.5, 1.0] and len(calls) == 3
    assert calls[-1] == ("gloo", {"init_method": "tcp://10.0.0.1:1234",
                                  "world_size": 4, "rank": 3})
    calls.clear()
    with pytest.raises(RuntimeError, match="refused"):
        mh.initialize_multihost("cpu", init_retries=2)
    assert len(calls) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_from_the_environment_match_local_comm(tmp_path):
    args = ["--device", "cpu", "--epochs", "1", "--steps", "2",
            "--batch-size", "4", "--synthetic-size", "32"]
    env = {k: v for k, v in os.environ.items()
           if k not in _VARS and k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               JAX_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               JAX_NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dgc_tpu_torch.train", *args], cwd=tmp_path,
        env=dict(env, JAX_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1])["loss"]
           for out, _ in outs]
    cfg = configs.resnet20_wm5()
    cfg.train.batch_size, cfg.dataset.synthetic_size = 4, 32
    want = [float(x) for x in Trainer(cfg, LocalComm(2),
                                      device="cpu").run_epoch(0, steps=2)]
    assert got[0] == got[1] == want
    # one experiment directory, written by both processes' workers
    ckpt = tmp_path / "runs" / "cifar.resnet20+dgc.wm5.np2" / "checkpoints"
    assert sorted(os.listdir(ckpt / "e0")) == [
        "meters.json", "state.pt", "w0.pt", "w1.pt"]
