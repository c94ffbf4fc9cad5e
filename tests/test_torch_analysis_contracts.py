"""The port's contracts (layer 2): the recorded-step primitives, the
standing suite green on the CPU from the JAX fixture's own weights, the
recorded collective counts equal to the JAX fixture's lowered ones, and
every flag-off contract red once a probe op is planted in its build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.analysis import hlo
from dgc_tpu_torch.analysis import program as prg
from dgc_tpu_torch.analysis.contracts import (BuildGuard, Contract,
                                              ContractViolation,
                                              record_step)
from dgc_tpu_torch.analysis.suite import (DENSE_COLLECTIVES,
                                          FLAT_COLLECTIVES, build_fixture,
                                          run_contract_suite)
from dgc_tpu_torch.parallel.comm import LocalComm

#: the reference suite's 33 contracts (dgc_tpu/analysis/suite.py)
REFERENCE_CONTRACTS = (
    "flat-step-one-sparse-exchange", "telemetry-on-exactly-one-pmean",
    "telemetry-off-compiles-away", "fleet-on-one-packed-gather",
    "fleet-off-compiles-away", "adaptive-off-compiles-away",
    "adaptive-on-no-new-collectives", "guards-off-compiles-away",
    "guards-on-no-new-collectives", "trace-on-no-new-collectives",
    "trace-off-compiles-away", "elastic-off-compiles-away",
    "donated-state-aliases-outputs", "dense-engine-no-gathers",
    *(f"plan-matches-collectives[{r}]" for r in (
        "dense", "fp32", "int8", "int8_packed", "int4_packed",
        "int8_delta_idx")),
    "autotune-off-compiles-away", "gossip-off-compiles-away",
    "gossip-on-collective-count[ring]", "gossip-on-collective-count[hcube]",
    "control-plane-host-only", "surgery-off-compiles-away",
    "surgery-on-no-new-collectives", "autotune-replan-pins-compile",
    "megakernel-off-compiles-away", "megakernel-on-no-new-collectives",
    "fused-epilogue-no-opt-barriers", "recompile-guard-same-shapes",
    "shard-state-collective-free")

#: the contracts that pin "off equals never mentioned"
OFF_CONTRACTS = tuple(n for n in REFERENCE_CONTRACTS
                      if n.endswith("-off-compiles-away")) + (
    "control-plane-host-only",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX fixture's own flax initialisation (PRNGKey(0))."""
    from flax import linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, x, train=True):
            x = nn.Conv(8, (3, 3))(x)
            x = nn.BatchNorm(use_running_average=not train)(x)
            x = nn.relu(x)
            return nn.Dense(10)(x.mean(axis=(1, 2)))

    v = jax.device_get(M().init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 3))))
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def suite_results(jax_variables):
    return run_contract_suite(variables=jax_variables)


# --------------------------------------------------------------------- #
# primitives                                                             #
# --------------------------------------------------------------------- #

def test_recording_comm_counts_and_labels_axes():
    comm = prg.RecordingComm(LocalComm(4))
    xs = [torch.ones(3) * r for r in range(4)]
    comm.all_gather(xs)
    comm.all_reduce(xs)
    local, cross = comm.split(2)
    local.all_reduce(xs)
    cross.swap(xs, 1)
    assert comm.calls == {"all_gather": 1, "all_reduce": 2, "swap": 1}
    assert comm.counts()["all-reduce"] == 2
    assert comm.counts("data") == {**{k: 0 for k in prg.COLLECTIVE_OPS},
                                   "all-gather": 1, "all-reduce": 1}
    assert [s[1] for s in comm.sites] == ["data", "data", "local", "hosts"]
    assert comm.sites[0][2:] == ("torch.float32", (3,))
    assert prg.normalize_op("swap") == "collective-permute"
    assert prg.normalize_op("all_gather") == "all-gather"


def test_recorder_ops_views_and_inplace_writes():
    a = torch.ones(8)
    with prg.Recorder() as rec:
        b = a * 2
        v = b[2:]
        v.add_(1)
        c = b.to(torch.bfloat16)
        z = torch.zeros_like(c)
    prog = rec.prog
    counts = prg.op_counts(prog)
    assert counts["aten.mul"] == 1 and counts["aten.add_"] == 1
    assert prg.collective_counts(prog) == {k: 0 for k in prg.COLLECTIVE_OPS}
    mul, add = prog.eqns[0], next(e for e in prog.eqns
                                  if e.prim == "aten.add_")
    # the in-place write of a view makes a new value of b's storage that
    # reads the old one
    assert mul.outvars[0] in add.invars
    assert add.outvars[0] not in mul.outvars
    cast = next(e for e in prog.eqns if "dst_dtype" in e.params)
    assert cast.params["dst_dtype"] == torch.bfloat16
    assert "test_torch_analysis_contracts.py" not in cast.source
    zl = next(e for e in prog.eqns if e.prim == "aten.zeros_like")
    assert zl.invars == ()            # no data flows into a zeros_like
    taint = prg.forward_taint(prog, mul.outvars)
    assert add.outvars[0] in taint and zl.outvars[0] not in taint
    assert prg.peak_live_bytes(prog) >= a.nbytes
    del z, c


def _toy_contract(name, n_gather, n_reduce, f64=False):
    comm = prg.RecordingComm(LocalComm(2))

    def record():
        with prg.Recorder() as rec:
            xs = [torch.ones(4), torch.ones(4)]
            for _ in range(n_gather):
                comm.all_gather(xs)
            for _ in range(n_reduce):
                comm.all_reduce(xs)
            if f64:
                xs[0].double()
        from dgc_tpu_torch.analysis.contracts import RecordedStep
        return RecordedStep(rec.prog, comm.counts(), {}, {}, None, {})
    return Contract(name, record)


def test_contract_collectives_pass_and_fail():
    c = _toy_contract("c", 2, 2).expects(collectives=FLAT_COLLECTIVES)
    assert c.check() == []
    bad = _toy_contract("d", 1, 2).expects(collectives={"all_gather": 2})
    assert bad.check() and "all-gather" in bad.check()[0]


def test_contract_identical_delta_and_f64():
    base = _toy_contract("base", 2, 1)
    same = _toy_contract("same", 2, 1).expects(identical_to=base)
    assert same.check() == []
    more = _toy_contract("more", 2, 2).expects(
        identical_to=base, collectives_delta=(base, {"all-reduce": 1}))
    out = more.check()
    assert len(out) == 1 and "op trace differs" in out[0]
    assert _toy_contract("f", 1, 1, f64=True).expects(
        no_f64=True).check()
    assert _toy_contract("g", 1, 1).expects(no_f64=True).check() == []


def test_enforce_raises_with_all_violations():
    c = _toy_contract("x", 1, 1, f64=True).expects(
        collectives={"all-gather": 2, "all-reduce": 2}, no_f64=True)
    with pytest.raises(ContractViolation) as ei:
        c.enforce()
    assert len(ei.value.violations) == 3


def test_modules_inplace_state_and_calls_on_a_fixture_step():
    fx = build_fixture()
    c = Contract("plain", lambda: record_step(fx)).expects(
        forbid_modules=["telemetry/fleet"],
        require_modules=["compression/flat.py:compress"],
        inplace_state=("memory", "batch_stats"),
        calls={"ops/kernels.py:apply_rows": 8})
    out = c.check()
    # the transmit record and the dense momentum are fresh tensors a step
    assert out and all("memory." in v and ("sent_bits" in v
                                           or "momentums_d" in v)
                       for v in out), out
    assert c.recorded.same["memory.3.velocities_c"]


def test_syncs_are_read_on_the_card_only():
    fx = build_fixture()
    c = Contract("s", lambda: record_step(fx, trace=False)).expects(
        max_syncs=0)
    assert "card only" in c.check()[0]


def test_guard_window_push_reads_no_host_value():
    """The spike window's push is a select at the slot: the guarded step
    reads no device value on the host (an index_put with a 0-dim device
    index did, one sync a step on the card, found by the card's
    guards-on-no-new-syncs contract)."""
    from dgc_tpu_torch.resilience import guard as G
    cfg = G.GuardConfig(spike_window=4)
    st = G.init_state(cfg)
    with prg.Recorder() as rec:
        for loss in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
            _, st, _ = G.apply(cfg, st, bad_count=torch.zeros(()),
                               mean_loss=torch.tensor(loss))
    assert "aten._local_scalar_dense" not in prg.op_counts(rec.prog)
    assert st["loss_window"].tolist() == [5.0, 6.0, 3.0, 4.0]
    assert int(st["wpos"]) == 2 and int(st["wcount"]) == 4


def test_build_guard_counts_engine_constructions():
    fx = build_fixture()
    fx.step(fx.state)
    with BuildGuard(expect=0, name="same-shapes"):
        fx.step(fx.state)
    with pytest.raises(ContractViolation, match="construct FlatDGCEngine"):
        with BuildGuard(expect=0, name="rebuild"):
            fx.dist.make_flat({"w": torch.zeros(4, 4)})


# --------------------------------------------------------------------- #
# the standing suite                                                     #
# --------------------------------------------------------------------- #

def test_contract_suite_all_green(suite_results):
    failed = {n: v for n, v in suite_results if v}
    assert not failed, failed


def test_suite_has_every_reference_contract(suite_results):
    assert [n for n, _ in suite_results] == list(REFERENCE_CONTRACTS)


def _jax_counts(mesh, **kw):
    from dgc_tpu.analysis.contracts import Contract as JContract
    from dgc_tpu.analysis.suite import build_fixture as jax_fixture
    state, step, _, (images, labels, key) = jax_fixture(mesh, **kw)
    args = (state, images, labels, key)
    if kw.get("fleet"):
        from dgc_tpu.telemetry import fleet as jfleet
        args += (jfleet.make_clock(0.0, mesh, 8),)
    return hlo.collective_counts(JContract("j", step, args=args)
                                 .lowered_text)


def _plan(reg, planner):
    return planner.plan_buckets([], fabric="32x25GbE", world=8,
                                candidates=(reg,))


@pytest.mark.parametrize("config", [
    "plain", "telemetry", "fleet", "guards_checksum", "planned.int8_packed",
    "gossip_ring", "dense"])
def test_recorded_counts_equal_the_jax_lowered_counts(config, mesh8,
                                                      jax_variables):
    from dgc_tpu.compression import planner as jplanner
    from dgc_tpu.resilience import GuardConfig as JGuard
    from dgc_tpu_torch.compression import planner as tplanner
    from dgc_tpu_torch.resilience.guard import GuardConfig
    jkw, tkw = {
        "plain": ({}, {}),
        "telemetry": ({"telemetry": True}, {"telemetry": True}),
        "fleet": ({"telemetry": True, "fleet": True},
                  {"telemetry": True, "fleet": True}),
        "guards_checksum": (
            {"guards": JGuard(spike_window=8),
             "compressor_kwargs": {"checksum": True}},
            {"guards": GuardConfig(spike_window=8),
             "compressor_kwargs": {"checksum": True}}),
        "planned.int8_packed": (
            {"plan": _plan("int8_packed", jplanner)},
            {"plan": _plan("int8_packed", tplanner)}),
        "gossip_ring": ({"plan": _plan("gossip_ring", jplanner)},
                        {"plan": _plan("gossip_ring", tplanner)}),
        "dense": ({"compressor": "none"}, {"compressor": "none"}),
    }[config]
    want = _jax_counts(mesh8, donate=False, **{"telemetry": False, **jkw})
    fx = build_fixture(variables=jax_variables, **tkw)
    got = record_step(fx, trace=False).collectives
    assert got == want
    if config == "plain":
        assert {k: got[k] for k in FLAT_COLLECTIVES} == FLAT_COLLECTIVES
    if config == "dense":
        assert {k: got[k] for k in DENSE_COLLECTIVES} == DENSE_COLLECTIVES


def test_flag_off_contracts_turn_red_on_a_planted_op():
    """An extra op in each off build (and a call into the feature's own
    module) turns every off-equals-never-mentioned contract red."""
    def plant(name, fx):
        if name not in OFF_CONTRACTS:
            return
        inner = fx.step

        def step(state, **kw):
            out = inner(state, **kw)
            torch.ones(1).add_(1.0)           # the probe op
            return out
        fx.step = step
    results = dict(run_contract_suite(probe=plant, only=OFF_CONTRACTS))
    assert set(results) == set(OFF_CONTRACTS)
    for name, violations in results.items():
        assert any("op trace differs" in v for v in violations), name


def test_contracts_cli_raises_without_a_card(capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--contracts"])
