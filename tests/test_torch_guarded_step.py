"""The guarded train step (the reference's ``build_train_step(guards=...)``)
on ResNet-20, W=2 on the CPU, against test_resilience.py's oracles: a NaN
step is skipped atomically (every piece of state bitwise its pre-step
value, the step counter advancing), the counters read as the reference's
(skipped 1, non-finite rate 1/2, then 1/3), the checksum counts a bitflip
every step, and a guarded step makes the unguarded step's collectives and
kernel calls and, without a fault, its numbers bitwise."""

import numpy as np
import pytest
import torch

from dgc_tpu_torch import configs
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.resilience import faults
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import step as tstep
from dgc_tpu_torch.training.checkpoint import CheckpointManager


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recording(LocalComm):
    """A ``LocalComm`` that counts its collectives."""

    def __init__(self, world):
        super().__init__(world)
        self.calls = {"all_gather": 0, "all_reduce": 0}

    def all_gather(self, xs):
        self.calls["all_gather"] += 1
        return super().all_gather(xs)

    def all_reduce(self, xs):
        self.calls["all_reduce"] += 1
        return super().all_reduce(xs)


def _cfg(resilience=True, checksum=True):
    cfg = configs.resnet20_wm5()
    if resilience:
        configs.with_resilience(cfg, checksum=checksum)
    cfg.dataset.synthetic_size = 64
    cfg.train.batch_size = 4
    return cfg


def _state(t):
    """Everything a step may write, on the CPU (the optimizer's count
    read after the pending verdict)."""
    tstep.resolve_pending_skip(t.state)
    st = t.state
    out = {"params": st.params.detach().clone(),
           "count": st.opt_state.count}
    if st.opt_state.momentum_buffer is not None:
        out["buf"] = st.opt_state.momentum_buffer.detach().clone()
    for w, (m, s) in enumerate(zip(st.memory, st.batch_stats)):
        out[f"stats{w}"] = s.clone()
        out.update({f"mem{w}:{k}": v.clone() for k, v in m.items()})
    return out


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k].view(torch.int32)
                               if a[k].dtype == torch.float32 else a[k],
                               b[k].view(torch.int32)
                               if b[k].dtype == torch.float32 else b[k]), k
        else:
            assert a[k] == b[k], k


def test_nan_step_is_skipped_atomically(monkeypatch):
    monkeypatch.setenv(faults.ENV, "nan@1")
    t = Trainer(_cfg(checksum=False), LocalComm(2), "cpu")
    seen = []
    t.run_epoch(5, 1, on_step=lambda b, m: seen.append(m))
    pre = _state(t)
    assert float(seen[0]["guards"]["skipped_steps"]) == 0.0
    # the poisoned step: batch 1 of the epoch, at state.step 1
    t.run_epoch(5, 2, start=1, on_step=lambda b, m: seen.append(m))
    g = seen[1]["guards"]
    assert seen[1]["step"] == 1 and t.state.step == 2
    assert float(g["skipped_steps"]) == 1.0
    assert float(g["nonfinite_rate"]) == pytest.approx(0.5)
    _equal(_state(t), pre)
    # and training goes on: the next step moves the parameters
    t.run_epoch(6, 1, on_step=lambda b, m: seen.append(m))
    assert not torch.equal(t.state.params, pre["params"])
    assert float(seen[2]["guards"]["skipped_steps"]) == 1.0
    assert float(seen[2]["guards"]["nonfinite_rate"]) == pytest.approx(1 / 3)
    assert torch.isfinite(t.state.params).all()


def _counting(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        f = getattr(kernels, n)

        def wrap(*a, _f=f, _n=n, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(kernels, n, wrap)
    return calls


def test_guards_add_no_collective_and_change_no_number(monkeypatch):
    """Guards and the checksum on: the same all-gathers and all-reduces a
    step (the flag rides the loss all-reduce, the words the index lane),
    the same kernel calls, and with no fault the same state, bitwise, as
    the unguarded step."""
    monkeypatch.delenv(faults.ENV, raising=False)
    names = ("compensate_bits", "compensate_bits_cands", "topk_rows",
             "apply_rows")
    runs = {}
    for guarded in (False, True):
        comm = _Recording(2)
        t = Trainer(_cfg(resilience=guarded), comm, "cpu")
        assert t.setup.engine.checksum == guarded
        calls = _counting(monkeypatch, names)
        t.run_epoch(5, 2)
        runs[guarded] = (dict(comm.calls), dict(calls), _state(t))
        monkeypatch.undo()
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1] and runs[True][1]["apply_rows"]
    _equal(runs[True][2], runs[False][2])


def test_checksum_counts_a_bitflip_every_step(monkeypatch):
    monkeypatch.setenv(faults.ENV, "bitflip:elem=0:bit=18")
    t = Trainer(_cfg(), LocalComm(2), "cpu")
    seen = []
    t.run_epoch(5, 2, on_step=lambda b, m: seen.append(m))
    assert [float(m["guards"]["checksum_failures"]) for m in seen] == [
        1.0, 2.0]
    assert torch.isfinite(t.state.params).all()
    monkeypatch.setenv(faults.ENV, "badidx:elem=0:set=-5")
    t = Trainer(_cfg(), LocalComm(2), "cpu")
    seen = []
    t.run_epoch(5, 2, on_step=lambda b, m: seen.append(m))
    assert float(seen[-1]["guards"]["checksum_failures"]) == 2.0
    assert torch.isfinite(t.state.params).all()


def test_guard_state_in_checkpoints(tmp_path, monkeypatch):
    """The guard state rides ``state.pt``; a checkpoint written without
    guards restores into a guarded run with fresh counters (the
    reference's pre-resilience rule), and a guarded one into an unguarded
    run without them."""
    monkeypatch.setenv(faults.ENV, "nan@0")
    t = Trainer(_cfg(checksum=False), LocalComm(2), "cpu")
    t.run_epoch(5, 2)
    ckpt = CheckpointManager(str(tmp_path / "g"))
    t.save_checkpoint(ckpt, 5, {"acc/test_top1": 1.0})
    rep = torch.load(tmp_path / "g" / "e5" / "state.pt", weights_only=True)
    assert int(rep["guards:skipped"]) == 1 and int(rep["guards:steps"]) == 2
    monkeypatch.delenv(faults.ENV)
    u = Trainer(_cfg(checksum=False), LocalComm(2), "cpu")
    assert u.restore_checkpoint(ckpt)[0] == 5
    for k, v in t.state.guards.items():
        assert torch.equal(u.state.guards[k], v), k
    plain = Trainer(_cfg(resilience=False), LocalComm(2), "cpu")
    assert plain.restore_checkpoint(ckpt)[0] == 5
    assert plain.state.guards is None
    old = CheckpointManager(str(tmp_path / "old"))
    plain.save_checkpoint(old, 5, {"acc/test_top1": 1.0})
    v = Trainer(_cfg(checksum=False), LocalComm(2), "cpu")
    assert v.restore_checkpoint(old)[0] == 5
    assert int(v.state.guards["steps"]) == 0
    assert torch.equal(v.state.params, plain.state.params)
    np.testing.assert_array_equal(v.state.memory[1]["velocities_c"].numpy(),
                                  plain.state.memory[1]["velocities_c"]
                                  .numpy())
