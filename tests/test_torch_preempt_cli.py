"""The CLI's preemption drill and resilience exits on ResNet-20 at a small
size (W=2, batch 4 a worker, 8 steps an epoch), as the JAX harness runs
them (``DGC_FAULTS=kill@K`` -> the emergency checkpoint of the epoch in
progress -> exit 75 -> the same command again resumes at the next batch).

The resumed run's losses and its final state are bitwise the
uninterrupted run's: the epoch's batch order is a function of the epoch
and the seed, and the checkpoint carries every worker's memory, transmit
record, statistics, sampling generator and the guard state."""

import json
import os

import pytest
import torch

from dgc_tpu_torch import train
from dgc_tpu_torch.resilience import faults
from dgc_tpu_torch.telemetry import flight

ARGS = ["--config", "resnet20_wm5_resilience", "--device", "cpu",
        "--world", "2", "--batch-size", "4", "--synthetic-size", "64",
        "--epochs", "2"]
RUN = "runs/cifar.resnet20+dgc.wm5+resilience{}.np2"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summaries(out):
    return [json.loads(x) for x in out.splitlines()
            if x.startswith('{"epoch"')]


def _final(path):
    return torch.load(os.path.join(path, "checkpoints", "e1", "state.pt"),
                      weights_only=True)


def test_kill_and_resume_is_bitwise_the_uninterrupted_run(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(faults.ENV, raising=False)
    want = train.main(ARGS + ["--suffix", ".full"])
    capsys.readouterr()
    # SIGTERM after the 11th step: epoch 1, batch 2 is the last trained
    monkeypatch.setenv(faults.ENV, "kill@11")
    with pytest.raises(SystemExit) as e:
        train.main(ARGS)
    assert e.value.code == 75
    out = capsys.readouterr().out
    assert "[preempt] signal 15: stopping at epoch 1, batch 2" in out
    meters = json.load(open(os.path.join(RUN.format(""), "checkpoints",
                                         "e1", "meters.json")))
    assert meters["preempt_batch"] == 2
    assert meters["_topology"]["world"] == 2
    dump = flight.load_dump(os.path.join(RUN.format(""), "flight.json"))
    assert dump["reason"] == "preempt signal 15"
    assert dump["records"][-1]["step"] == 11
    monkeypatch.delenv(faults.ENV)
    resumed = train.main(ARGS)
    out = capsys.readouterr().out
    assert "[resumed] mid-epoch 1 at batch 3" in out
    killed = [x for s in _summaries(out) for x in s["loss"]]
    assert len(resumed) == 5 and killed == resumed
    assert resumed == want[-5:]
    a, b = _final(RUN.format("")), _final(RUN.format(".full"))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for w in (0, 1):
        a = torch.load(os.path.join(RUN.format(""), "checkpoints", "e1",
                                    f"w{w}.pt"), weights_only=True)
        b = torch.load(os.path.join(RUN.format(".full"), "checkpoints", "e1",
                                    f"w{w}.pt"), weights_only=True)
        for k in a:
            assert torch.equal(a[k], b[k]), (w, k)


def test_nonfinite_streak_aborts_with_70(tmp_path, monkeypatch, capsys):
    """Losses that stay non-finite (here every loss, by a patched loss
    function): the guards skip every step, the breaker trips after three
    at the epoch's end, the flight ring is dumped and the run exits 70."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(faults.ENV, raising=False)
    from dgc_tpu_torch.training import step as tstep
    ce = tstep.F.cross_entropy
    monkeypatch.setattr(tstep.F, "cross_entropy",
                        lambda *a, **k: ce(*a, **k) * float("nan"))
    with pytest.raises(SystemExit) as e:
        train.main(ARGS[:-1] + ["1", "--steps", "4"])
    assert e.value.code == 70
    out = capsys.readouterr().out
    assert "consecutive nonfinite losses at epoch 0" in out
    dump = flight.load_dump(os.path.join(RUN.format(""), "flight.json"))
    assert dump["reason"] == "nonfinite-streak x4"
    assert dump["records"][-1]["guards"]["skipped_steps"] == 4.0
