"""The port's standing contract suite (layer 2).

Counterpart of ``dgc_tpu/analysis/suite.py``: the same 33 contracts by
name, over recorded steps of the same tiny model — Conv(8) + BatchNorm +
Dense(10) on 16x16x3 images, 4 a worker, W=8 over a
:class:`~dgc_tpu_torch.parallel.comm.LocalComm` wrapped in a
:class:`~dgc_tpu_torch.analysis.program.RecordingComm`. The guarantees
they pin:

* **one sparse exchange**: the plain DGC step runs exactly 2 all-gathers
  (the value and index lanes) and 2 all-reduces (the dense tail and the
  loss mean); the dense engine none of the gathers
  (:data:`FLAT_COLLECTIVES`, :data:`DENSE_COLLECTIVES`, the reference's).
* **off equals never mentioned**: telemetry, fleet, adaptive, guards,
  trace, elastic, autotune, gossip, surgery and megakernel switched off
  give the same op trace as a build that never named them, and none of
  the feature's code runs.
* **features ride existing collectives**: telemetry adds one all-reduce,
  fleet one all-gather in its place; adaptive, guards (with the
  checksum), trace, megakernel and surgery add none; every planner regime
  and both gossip topologies run exactly ``Plan.collectives()`` plus the
  loss mean.
* **state in place** (``donated-state-aliases-outputs``): the step
  updates the error-feedback state and the BatchNorm statistics in their
  own storages.
* **no repeated set-up**: a second same-shape step, or a replan that
  keeps the plan's key, builds, loads or constructs nothing
  (:class:`~dgc_tpu_torch.analysis.contracts.BuildGuard`).
* **the control plane is host-only**; **the state assembly is
  collective-free**; **the apply is one kernel a worker**
  (``fused-epilogue-no-opt-barriers``: XLA's optimization barrier has no
  eager counterpart); **f32 end to end**.

On the card (``device="cuda"``) two more contracts read a profiler
window: guards and telemetry add no synchronising call over the plain
step.

:func:`build_fixture` takes the model's weights as flax-shaped ``params``
and ``batch_stats`` trees (the tests pass the JAX fixture's own
``PRNGKey(0)`` initialisation through
:func:`~dgc_tpu_torch.interop.carry_variables`); without them it draws its
own from ``torch.Generator`` seed 0. The images and labels are the
reference's ``RandomState(0)`` draws. The port's BatchNorm keeps the
reference models' momentum 0.9 where the fixture's flax default is 0.99:
the running statistics differ, no count or trace does.
"""

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgc_tpu_torch.analysis.contracts import (BuildGuard, Contract,
                                              record_step)

__all__ = ["run_contract_suite", "build_fixture", "Fixture",
           "FixtureNet", "FLAT_COLLECTIVES", "DENSE_COLLECTIVES",
           "state_assembly_check"]

FLAT_COLLECTIVES = {"all-gather": 2, "all-reduce": 2}
DENSE_COLLECTIVES = {"all-gather": 0, "all-reduce": 2}
#: the fixture's geometry (the reference's)
WORLD, PER_WORKER, SIZE = 8, 4, 16


class FixtureNet(nn.Module):
    """The reference fixture's model with flax's names and layouts:
    ``Conv_0`` (3x3, 8 channels, SAME, bias), ``BatchNorm_0``, ReLU, the
    spatial mean, ``Dense_0`` (10)."""

    def __init__(self):
        super().__init__()
        from dgc_tpu_torch.models.resnet_cifar import BatchNorm, Conv, Dense
        self.Conv_0 = Conv(3, 8, 3, 1, 1, bias=True)
        self.BatchNorm_0 = BatchNorm(8)
        self.Dense_0 = Dense(8, 10)

    def forward(self, x, train: bool = True):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return self.Dense_0(x.mean(dim=(2, 3)))


@dataclass
class Fixture:
    model: nn.Module
    setup: object
    dist: object
    state: object
    #: ``step(state, **kw) -> (state, out)``; ``kw`` overrides the
    #: fixture's ``train_step`` keywords (``clock=``)
    step: Callable
    comm: object
    device: str


def _init(model: FixtureNet, gen: torch.Generator) -> None:
    """lecun-normal kernels (flax's default), zero biases, unit scales."""
    with torch.no_grad():
        for mod in (model.Conv_0, model.Dense_0):
            k = mod.kernel
            fan_in = math.prod(k.shape[:-1])
            k.copy_(torch.randn(k.shape, generator=gen)
                    / math.sqrt(fan_in))


def build_fixture(world: int = WORLD, compressor: str = "dgc",
                  compressor_kwargs=None, plan=None, device: str = "cpu",
                  variables=None, comm=None, **step_kwargs) -> Fixture:
    """The tiny model's flat train step over ``world`` workers.

    ``compressor``: ``"dgc"`` (``DGCCompressor(0.05)`` with momentum-0.9
    memory; ``compressor_kwargs`` added) or ``"none"`` (the dense
    engine). ``plan``: an exchange plan threaded through
    ``make_flat_setup``. ``variables``: ``(params, batch_stats)`` flax
    trees. ``comm``: the collectives (a fresh recording ``LocalComm``).
    ``step_kwargs`` pass to :func:`~dgc_tpu_torch.training.step.
    train_step` (``telemetry``, ``fleet``, ``guards``, ``adaptive``,
    ``nbps``); a ``guards`` / ``adaptive`` config also seeds the state."""
    from dgc_tpu_torch.analysis.program import RecordingComm
    from dgc_tpu_torch.compression.base import NoneCompressor
    from dgc_tpu_torch.compression.dgc import DGCCompressor
    from dgc_tpu_torch.compression.memory import DGCSGDMemory
    from dgc_tpu_torch.interop import carry_variables
    from dgc_tpu_torch.models import param_tree
    from dgc_tpu_torch.optim.distributed import DistributedOptimizer
    from dgc_tpu_torch.optim.sgd import dgc_sgd
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.telemetry import fleet as _fleet
    from dgc_tpu_torch.training.step import (make_flat_setup,
                                             make_flat_state, train_step)
    from dgc_tpu_torch.utils.pytree import named_flatten

    model = FixtureNet()
    _init(model, torch.Generator().manual_seed(0))
    if compressor == "dgc":
        comp = DGCCompressor(0.05, memory=DGCSGDMemory(momentum=0.9),
                             **(compressor_kwargs or {}))
        named = named_flatten(param_tree(model))
        comp.initialize((n, p.shape) for n, p in named.items()
                        if p.ndim > 1)
    elif compressor == "none":
        comp = NoneCompressor()
    else:
        raise ValueError(f"unknown compressor {compressor!r}")
    comm = comm if comm is not None else RecordingComm(LocalComm(world))
    dist = DistributedOptimizer(dgc_sgd(0.1, momentum=0.9), comp, comm)
    setup = make_flat_setup(model, dist, plan=plan)
    flat = (None, None)
    if variables is not None:
        flat = carry_variables(variables[0], variables[1], setup.layout,
                               setup.stats_layout)
    model.to(device)
    state = make_flat_state(model, dist, setup, device, flat_params=flat[0],
                            flat_stats=flat[1],
                            guards=step_kwargs.get("guards"),
                            adaptive=step_kwargs.get("adaptive"))

    rng = np.random.RandomState(0)
    n = world * PER_WORKER
    images = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(
        np.float32)).permute(0, 3, 1, 2).contiguous().to(device)
    labels = torch.from_numpy(rng.randint(0, 10, n)).to(torch.int64).to(
        device)
    ims = list(images.chunk(world))
    lbs = list(labels.chunk(world))
    nbps = step_kwargs.pop("nbps", 1)
    if step_kwargs.get("fleet"):
        step_kwargs.setdefault("clock", _fleet.make_clock(0.0, world,
                                                          device))

    def step(state, **kw):
        gens = [torch.Generator().manual_seed(1000 * state.step + 1 + w)
                for w in range(world)]
        return train_step(model, setup, dist, state, ims, lbs, gens, nbps,
                          **{**step_kwargs, **kw})
    return Fixture(model, setup, dist, state, step, comm, device)


def state_assembly_check(device: str = "cpu") -> List[str]:
    """The state assembly (``make_flat_state``) must be collective-free,
    as the reference's multi-process ``shard_state`` is: no collective
    while a fixture's state is built."""
    from dgc_tpu_torch.analysis.program import RecordingComm
    from dgc_tpu_torch.parallel.comm import LocalComm
    comm = RecordingComm(LocalComm(WORLD))
    build_fixture(device=device, comm=comm)
    if any(comm.calls.values()):
        return [f"make_flat_state ran collectives {comm.calls}: the state "
                "assembly must stay collective-free"]
    return []


def _contract(name: str, fx: Fixture, **expects) -> Contract:
    return Contract(name, lambda: record_step(fx)).expects(**expects)


def _plan_want(fx: Fixture) -> dict:
    want = dict(fx.setup.engine.plan.collectives(dense_reduces=1))
    want["all-reduce"] += 1     # the step's loss mean
    return want


def run_contract_suite(log: Callable[[str], None] = None,
                       device: str = "cpu", variables=None,
                       probe: Optional[Callable] = None,
                       only: Optional[Sequence[str]] = None,
                       ) -> List[Tuple[str, List[str]]]:
    """Run every standing contract (or those named in ``only``) on
    ``device``; returns ``(name, violations)`` pairs. ``variables``: the
    fixture's flax weights. ``probe(name, fixture)``: a hook called on the
    build a contract names (tests plant a probe op in an off build to see
    it go red). Steps are recorded lazily: a contract left out records
    nothing."""
    say = log or (lambda s: None)
    results: List[Tuple[str, List[str]]] = []

    def fx(name="", **kw) -> Fixture:
        f = build_fixture(device=device, variables=variables, **kw)
        if probe is not None:
            probe(name, f)
        return f

    def run(name, fn):
        if only is not None and name not in only:
            return
        say(f"contract: {name}")
        try:
            results.append((name, fn()))
        except Exception as e:      # a build failure is a violation too
            results.append((name, [f"errored: {type(e).__name__}: {e}"]))

    plain = _contract("flat-step-one-sparse-exchange", fx(),
                      collectives=FLAT_COLLECTIVES, no_f64=True)
    run(plain.name, plain.check)

    telem = _contract("telemetry-on-exactly-one-pmean", fx(telemetry=True),
                      collectives_delta=(plain, {"all-reduce": 1,
                                                 "all-gather": 0}),
                      no_f64=True)
    run(telem.name, telem.check)

    # a build that never names telemetry= runs the same ops as
    # telemetry=False: the flag is Python-static, not a no-op at run time
    off = _contract("telemetry-off-compiles-away",
                    fx("telemetry-off-compiles-away", telemetry=False),
                    forbid_modules=["telemetry/taps", "telemetry/fleet"],
                    identical_to=_contract("telemetry-never-built", fx()))
    run(off.name, off.check)

    # fleet taps: ONE packed all_gather in place of the telemetry mean
    fon = _contract("fleet-on-one-packed-gather",
                    fx(telemetry=True, fleet=True),
                    collectives_delta=(plain, {"all-gather": 1,
                                               "all-reduce": 0}),
                    no_f64=True)
    run(fon.name, fon.check)

    foff = _contract("fleet-off-compiles-away",
                     fx("fleet-off-compiles-away", telemetry=True,
                        fleet=False),
                     forbid_modules=["telemetry/fleet"],
                     identical_to=telem)
    run(foff.name, foff.check)

    aoff = _contract("adaptive-off-compiles-away",
                     fx("adaptive-off-compiles-away", telemetry=True,
                        fleet=True, adaptive=None),
                     forbid_modules=["resilience/adaptive"],
                     identical_to=fon)
    run(aoff.name, aoff.check)

    from dgc_tpu_torch.resilience.adaptive import AdaptiveConfig
    aon = _contract("adaptive-on-no-new-collectives",
                    fx(telemetry=True, fleet=True,
                       adaptive=AdaptiveConfig()),
                    collectives_delta=(fon, {"all-gather": 0,
                                             "all-reduce": 0}),
                    no_f64=True)
    run(aon.name, aon.check)

    goff = _contract("guards-off-compiles-away",
                     fx("guards-off-compiles-away", guards=None),
                     forbid_modules=["resilience/guard",
                                     "resilience/preempt"],
                     identical_to=plain)
    run(goff.name, goff.check)

    # guards + checksum: the skip verdict rides the loss all-reduce and
    # the checksum words ride the index lane — no collective more
    from dgc_tpu_torch.resilience.guard import GuardConfig
    gon = _contract("guards-on-no-new-collectives",
                    fx(guards=GuardConfig(spike_window=8),
                       compressor_kwargs={"checksum": True}),
                    collectives_delta=(plain, {"all-reduce": 0,
                                               "all-gather": 0}),
                    no_f64=True)
    run(gon.name, gon.check)

    # trace markers on: host-side ranges only, no collective more; the
    # markers' code runs. Recording is lazy, so check inside the window
    from dgc_tpu_torch.telemetry import trace as _tr
    prev = _tr.enable(True)
    try:
        tron = _contract("trace-on-no-new-collectives", fx(),
                         collectives_delta=(plain, {"all-reduce": 0,
                                                    "all-gather": 0}),
                         require_modules=["utils/profiling"], no_f64=True)
        run(tron.name, tron.check)
    finally:
        _tr.enable(prev)
    troff = _contract("trace-off-compiles-away",
                      fx("trace-off-compiles-away"),
                      forbid_modules=["utils/profiling"],
                      identical_to=plain)
    run(troff.name, troff.check)

    # elastic resharding is restore-time host code: a step built after the
    # (identity) batch-geometry resolution is the plain step
    from dgc_tpu_torch.resilience.elastic import resolve_batch_geometry
    nbps, _note = resolve_batch_geometry(WORLD, WORLD, 1)
    ela = _contract("elastic-off-compiles-away",
                    fx("elastic-off-compiles-away", nbps=nbps),
                    forbid_modules=["resilience/elastic"],
                    identical_to=plain)
    run(ela.name, ela.check)

    # the step updates the error-feedback state and the BatchNorm
    # statistics in their own storages (donation's eager counterpart)
    don = _contract("donated-state-aliases-outputs", fx(),
                    inplace_state=("memory.0.momentums_c",
                                   "memory.0.velocities_c",
                                   "batch_stats"))
    run(don.name, don.check)

    dense = _contract("dense-engine-no-gathers", fx(compressor="none"),
                      collectives=DENSE_COLLECTIVES, no_f64=True)
    run(dense.name, dense.check)

    # whatever regime the planner picks, Plan.collectives() (plus the loss
    # mean) is what the step runs — the all-dense plan included
    from dgc_tpu_torch.compression.planner import plan_buckets
    for reg in ("dense", "fp32", "int8", "int8_packed", "int4_packed",
                "int8_delta_idx"):
        name = f"plan-matches-collectives[{reg}]"

        def pmc(reg=reg, name=name):
            f = fx(plan=plan_buckets([], fabric="32x25GbE", world=WORLD,
                                     candidates=(reg,)))
            return _contract(name, f, collectives=_plan_want(f),
                             no_f64=True).check()
        run(name, pmc)

    import dgc_tpu_torch.compression.autotune  # noqa: F401 — import must not leak
    atoff = _contract("autotune-off-compiles-away",
                      fx("autotune-off-compiles-away"),
                      forbid_modules=["compression/autotune"],
                      identical_to=plain)
    run(atoff.name, atoff.check)

    import dgc_tpu_torch.compression.gossip  # noqa: F401 — import must not leak
    gsoff = _contract("gossip-off-compiles-away",
                      fx("gossip-off-compiles-away"),
                      forbid_modules=["compression/gossip"],
                      identical_to=plain)
    run(gsoff.name, gsoff.check)

    for topo in ("ring", "hcube"):
        name = f"gossip-on-collective-count[{topo}]"

        def gsn(topo=topo, name=name):
            f = fx(plan=plan_buckets([], fabric="32x25GbE", world=WORLD,
                                     candidates=("gossip_" + topo,)))
            return _contract(name, f, collectives=_plan_want(f),
                             no_f64=True).check()
        run(name, gsn)

    def control():
        # importing and ticking the control plane touches no device and
        # runs no collective; the step afterwards is the plain step
        import tempfile

        from dgc_tpu_torch.analysis.program import RecordingComm
        from dgc_tpu_torch.control.plane import DevicePool
        from dgc_tpu_torch.control.scheduler import GangScheduler
        from dgc_tpu_torch.parallel.comm import LocalComm
        import dgc_tpu_torch.control  # noqa: F401
        out = []
        was = torch.cuda.is_initialized()
        probe_comm = RecordingComm(LocalComm(WORLD))
        pool = DevicePool({"a": 2, "b": 1})
        pool.quarantine("b")
        pool.snapshot()
        with tempfile.TemporaryDirectory() as d:
            s = GangScheduler(4, root=d, clock=lambda: 1.0)
            s.admit("a", 2, priority=0, now=1.0)
            s.tick(now=2.0)
            s.close()
        if torch.cuda.is_initialized() and not was:
            out.append("the control plane initialised CUDA")
        if any(probe_comm.calls.values()):
            out.append(f"the control plane ran collectives "
                       f"{probe_comm.calls}")
        return out + _contract(
            "control-plane-host-only", fx("control-plane-host-only"),
            forbid_modules=["control/supervisor", "control/plane",
                            "control/rules", "control/actions",
                            "control/scheduler"],
            identical_to=plain).check()
    run("control-plane-host-only", control)

    import dgc_tpu_torch.resilience.surgery  # noqa: F401 — import must not leak
    soff = _contract("surgery-off-compiles-away",
                     fx("surgery-off-compiles-away"),
                     forbid_modules=["resilience/surgery"],
                     identical_to=plain)
    run(soff.name, soff.check)

    def surgery_on():
        # an ACTIVE coordinator with a published order adds no collective
        # to the step: the agreement is a host exchange at the boundary
        import os
        import tempfile

        from dgc_tpu_torch.resilience import surgery as _surgery
        with tempfile.TemporaryDirectory() as d:
            order = os.path.join(d, _surgery.ORDER_FILE)
            _surgery.publish_order(order, "manual", 1)
            coord = _surgery.SurgeryCoordinator(
                order, process_index=0, process_count=1)
            if not coord.agree(False).excise:
                return ["the surgery coordinator did not agree to excise"]
            return _contract(
                "surgery-on-no-new-collectives",
                fx("surgery-on-no-new-collectives"),
                forbid_modules=["resilience/surgery"],
                collectives_delta=(plain, {"all-gather": 0,
                                           "all-reduce": 0})).check()
    run("surgery-on-no-new-collectives", surgery_on)

    def autotune_pin():
        # an epoch-boundary refit that keeps the plan's key rebuilds
        # nothing, and the autotuned build runs exactly its plan
        from dgc_tpu_torch.compression.autotune import Autotuner
        probe_fx = fx()
        tuner = Autotuner(fabric="32x25GbE", world=WORLD, min_points=2)
        f = fx(plan=tuner.plan_for(probe_fx.setup.engine))
        out = []
        if f.setup.engine.plan.key() != tuner.plan.key():
            out.append("realized plan key differs from the tuner's plan")
        out += _contract("autotune-replan-pins-compile", f,
                         collectives=_plan_want(f), no_f64=True).check()
        with BuildGuard(expect=0, name="autotune-replan-pins-compile"):
            f.step(f.state)
            for b in (1e4, 1e5, 1e6):
                tuner.record_step(
                    tuner.fabric.alpha_ms + b / (tuner.fabric.gbps * 1e6),
                    int(b))  # dgclint: ok[sync-in-loop] — b is a Python loop constant, not a step output
            if tuner.epoch_end(f.setup.engine) is not None:
                out.append("same-key refit signalled a rebuild")
            if tuner.refit_count != 1:
                out.append("refit did not run")
            f.step(f.state)
        return out
    run("autotune-replan-pins-compile", autotune_pin)

    mkoff = _contract("megakernel-off-compiles-away",
                      fx("megakernel-off-compiles-away",
                         compressor_kwargs={"megakernel": False}),
                      forbid_modules=["ops/kernels.py:dgc_forward_rows",
                                      "flat.py:_compensate_megakernel"],
                      identical_to=plain)
    run(mkoff.name, mkoff.check)

    mkon = _contract("megakernel-on-no-new-collectives",
                     fx(compressor_kwargs={"megakernel": True}),
                     collectives_delta=(plain, {"all-gather": 0,
                                                "all-reduce": 0}),
                     no_f64=True)
    run(mkon.name, mkon.check)

    # XLA's optimization barrier has no eager counterpart; the port's
    # apply is one kernel call a worker (the apply_rows wrapper: a launch
    # each on the card)
    def epilogue():
        f = fx()
        c = _contract("fused-epilogue-no-opt-barriers", f,
                      calls={"ops/kernels.py:apply_rows": WORLD})
        out = c.check()
        n = c.recorded.launches["apply_rows"]
        if device != "cpu" and n != WORLD:
            out.append(f"apply_rows launched {n} times, not once a worker")
        return out
    run("fused-epilogue-no-opt-barriers", epilogue)

    def recompile():
        f = fx()
        f.step(f.state)
        with BuildGuard(expect=0, name="flat-step-same-shapes"):
            f.step(f.state)
        return []
    run("recompile-guard-same-shapes", recompile)

    run("shard-state-collective-free",
        lambda: state_assembly_check(device))

    if device != "cpu":
        # the card only: the synchronising calls a profiled step makes
        def sync_base():
            return record_step(fx(), trace=False, syncs=True)
        base = Contract("plain-syncs", sync_base)
        for name, kw in (("guards-on-no-new-syncs",
                          dict(guards=GuardConfig(spike_window=8),
                               compressor_kwargs={"checksum": True})),
                         ("telemetry-on-no-new-syncs",
                          dict(telemetry=True))):
            def syn(kw=kw, name=name):
                f = fx(**kw)
                c = Contract(name, lambda: record_step(
                    f, trace=False, syncs=True)).expects(
                    syncs_delta=(base, 0))
                out = c.check()
                say(f"syncs {name}: {c.recorded.syncs} at "
                    f"{c.recorded.sync_sites} (plain {base.recorded.syncs})")
                return out
            run(name, syn)
    return results
