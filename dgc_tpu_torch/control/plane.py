"""``ControlPlane`` — N supervised runs, one tick loop, audited actions
(counterpart of ``dgc_tpu/control/plane.py``).

One :class:`~dgc_tpu_torch.control.supervisor.Supervisor` per run, each on its
own thread (the child is a subprocess group of its own; the supervisor
thread just launches, waits, and backs off). Every supervisor event is
re-stamped with the run's fleet name and merged into one fleet-wide JSONL
stream (``<fleet_root>/control_events.jsonl``) next to the plane's own
events — ``plane_start``, per-rule ``control_action`` records (schema
checked by
:func:`dgc_tpu_torch.telemetry.registry.validate_control_action`),
``plane_stop``.

The tick loop closes the observe → decide → act cycle:

1. **observe** — :func:`dgc_tpu_torch.telemetry.monitor.collect` on each
   run dir (tolerant: a young or torn run yields no evidence, not an
   error),
2. **decide** — :class:`dgc_tpu_torch.control.rules.RuleEngine` applies
   the declarative rule table with persistence/debounce/budget hygiene,
3. **act** — :mod:`dgc_tpu_torch.control.actions` executes the remediation
   through the run's supervisor and the result is appended to the audit
   stream with the triggering evidence attached.

Quarantined runs are excluded from further rule evaluation — with ONE
exception (cohort surgery): a quarantined run with
a ``probe_cmd`` keeps being probed, and once the probe passes, the
``readmit`` rule may fire on it. The :class:`DevicePool` ledger tracks
where every run's device slots are (active → quarantined → freed →
active), so capacity freed by quarantines flows back through readmits
instead of leaking; the ledger is published as ``cohort.json`` under
each run dir and the fleet root for the monitor's COHORT line and the
``dgc_cohort_size`` / ``dgc_pool_free`` gauges.

The plane only starts, watches and signals its children, which own the
card: nothing here initialises CUDA or launches a kernel.
"""

import collections
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from dgc_tpu_torch.control import actions as _actions
from dgc_tpu_torch.control.rules import Rule, RuleEngine
from dgc_tpu_torch.control.scheduler import GangScheduler
from dgc_tpu_torch.control.supervisor import Supervisor, parse_env_file
from dgc_tpu_torch.telemetry import registry
from dgc_tpu_torch.telemetry.sink import JsonlAppender

__all__ = ["RunSpec", "DevicePool", "ControlPlane", "CONTROL_EVENTS",
           "COHORT_FILE"]

#: fleet-wide event stream file name under the fleet root
CONTROL_EVENTS = "control_events.jsonl"

#: ledger snapshot file name, written under each run dir and the fleet
#: root every tick (the monitor's COHORT line reads it)
COHORT_FILE = "cohort.json"


class RunSpec(NamedTuple):
    """One run the plane supervises. ``name`` doubles as the fleet label
    on every merged event and metric; ``run_dir`` is where the run's
    telemetry / flight / supervise artifacts land (the monitor's view)."""
    name: str
    cmd: Sequence[str]
    run_dir: str
    watch: Optional[str] = None       # default: <run_dir>/checkpoints
    env_file: Optional[str] = None    # cohort-spec publish target
    env: Optional[Dict[str, str]] = None
    retries: int = 5
    backoff: float = 5.0
    backoff_max: float = 300.0
    success_codes: Tuple[int, ...] = (0,)
    #: re-init probe for readmission: exit 0 = the quarantined worker may
    #: rejoin (clean init + checksum over a held-out batch; a
    #: ``CHECKSUM:<hex>`` stdout line is recorded as probe evidence)
    probe_cmd: Optional[Sequence[str]] = None
    #: device slots this run holds in the :class:`DevicePool` ledger
    slots: int = 1
    #: supervisor-side hang escalation (SIGKILL past a stale heartbeat)
    hang_timeout: Optional[float] = None
    heartbeat: Optional[str] = None
    #: gang-scheduler priority (higher grants first; ties FIFO by admit
    #: time) — only read when the plane has a GangScheduler wired
    priority: int = 0


class DevicePool:
    """Backpressure ledger: where each run's device slots are.

    ``active`` — serving the run. ``quarantined`` — held with the
    quarantined run for post-mortem (not schedulable). ``freed`` — the
    readmit probe passed; capacity is back on the market and
    ``dgc_pool_free`` counts it. A readmit moves the slots back to
    ``active``. All transitions are one-way per call and idempotent, so
    racing ticks cannot double-count a slot."""

    def __init__(self, slots: Dict[str, int]):
        self.slots = {n: int(c) for n, c in slots.items()}
        self.state: Dict[str, str] = {n: "active" for n in self.slots}

    def add(self, name: str, slots: int = 1) -> None:
        """Register (or grow) a run's holding as active — the gang
        scheduler deals seats in as grants execute."""
        self.slots[name] = self.slots.get(name, 0) + int(slots)
        self.state[name] = "active"

    def quarantine(self, name: str) -> None:
        if self.state.get(name) == "active":
            self.state[name] = "quarantined"

    def release(self, name: str) -> None:
        if self.state.get(name) == "quarantined":
            self.state[name] = "freed"

    def activate(self, name: str) -> None:
        if name in self.state:
            self.state[name] = "active"

    def _count(self, want: str) -> int:
        return sum(self.slots[n] for n, s in self.state.items()
                   if s == want)

    @property
    def free(self) -> int:
        return self._count("freed")

    def snapshot(self) -> Dict:
        return {"total": sum(self.slots.values()),
                "active": self._count("active"),
                "free": self.free,
                "quarantined": sorted(n for n, s in self.state.items()
                                      if s == "quarantined"),
                "freed": sorted(n for n, s in self.state.items()
                                if s == "freed")}


class ControlPlane:
    """Supervise a fleet of runs and remediate per the rule table."""

    def __init__(self, specs: Sequence[RunSpec], fleet_root: str,
                 rules: Optional[Sequence[Rule]] = None,
                 interval: float = 5.0, events_out: Optional[str] = None,
                 cohort_planner: Optional[Callable] = None,
                 collect: Optional[Callable] = None,
                 scheduler: Optional[GangScheduler] = None):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate run names in fleet: {names}")
        self.fleet_root = os.path.abspath(fleet_root)
        os.makedirs(self.fleet_root, exist_ok=True)
        self.interval = float(interval)
        self.stream = JsonlAppender(
            events_out or os.path.join(self.fleet_root, CONTROL_EVENTS))
        self.engine = RuleEngine(rules)
        self._planner = cohort_planner or _actions.default_cohort_planner
        if collect is None:
            from dgc_tpu_torch.telemetry import monitor as _monitor
            collect = _monitor.collect
        self._collect = collect
        self.specs: Dict[str, RunSpec] = {}
        self.supervisors: Dict[str, Supervisor] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._rcs: Dict[str, Optional[int]] = {}
        self.actions: List[Dict] = []   # the in-memory audit trail
        self._quarantine_audited: set = set()
        self.pool = DevicePool({s.name: s.slots for s in specs})
        self._probe: Dict[str, Dict] = {}   # run -> last probe result
        self.ticks = 0
        self._started = False
        self._sleep = threading.Event()
        # gang scheduling (control.scheduler): the scheduler
        # loop thread only *decides* (appends to the deque); every
        # mutation of supervisors/pool/stream happens on the tick thread
        # when the decisions drain — one writer, no cross-thread races
        self.scheduler = scheduler
        self._gangs: Dict[str, Dict] = {}        # gang -> meta
        self._gang_specs: Dict[str, List[RunSpec]] = {}
        self._gang_of: Dict[str, str] = {}       # member run -> gang
        self._gang_completed: set = set()
        self._preempt_watch: Dict[str, str] = {}  # victim gang -> seat
        self._sched_decisions: "collections.deque" = collections.deque()
        self._sched_stop = threading.Event()
        self._sched_thread: Optional[threading.Thread] = None
        for spec in specs:
            os.makedirs(spec.run_dir, exist_ok=True)
            self.specs[spec.name] = spec
            self.supervisors[spec.name] = self._make_supervisor(spec)
            self._rcs[spec.name] = None

    def _make_supervisor(self, spec: RunSpec) -> Supervisor:
        return Supervisor(
            spec.cmd,
            retries=spec.retries, backoff=spec.backoff,
            backoff_max=spec.backoff_max, env_file=spec.env_file,
            watch=spec.watch or os.path.join(spec.run_dir, "checkpoints"),
            events=os.path.join(spec.run_dir, "supervise_events.jsonl"),
            success_codes=spec.success_codes, name=spec.name,
            hang_timeout=spec.hang_timeout, heartbeat=spec.heartbeat,
            extra_env=spec.env,
            on_event=lambda rec, _n=spec.name: self._merge(_n, rec))

    # ------------------------------------------------------------------ #
    # event stream                                                       #
    # ------------------------------------------------------------------ #

    def _merge(self, name: str, rec: Dict) -> None:
        """Supervisor event -> fleet stream, stamped with the run name."""
        self.stream.write(dict(rec, run=name))

    def _plane_event(self, kind: str, **fields) -> None:
        self.stream.write(dict(fields, event=kind, t=time.time()))

    def _audit(self, run: str, run_id: str, rule: str, action: str,
               evidence: Dict, result: Dict) -> Dict:
        """One schema-checked ``control_action`` record onto the fleet
        stream + the in-memory trail. EVERY mutation the plane makes —
        rule-fired remediations and scheduler transitions alike — funnels
        through here, so the audit trail is the whole story."""
        rec = {"event": "control_action", "run": run, "run_id": run_id,
               "rule": rule, "action": action, "evidence": evidence,
               "result": result, "t": time.time()}
        registry.validate_control_action(rec)
        self.stream.write(rec)
        self.actions.append(rec)
        return rec

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._plane_event(
            "plane_start", fleet_root=self.fleet_root,
            runs={n: {"cmd": list(s.cmd), "run_dir": s.run_dir}
                  for n, s in self.specs.items()},
            rules=[r.name for r in self.engine.rules])
        for name, sup in self.supervisors.items():
            t = threading.Thread(
                target=self._supervise, args=(name, sup),
                name=f"dgc-control-{name}", daemon=True)
            self._threads[name] = t
            t.start()
        if self.scheduler is not None and self._sched_thread is None:
            t = threading.Thread(target=self._sched_loop,
                                 name="dgc-sched", daemon=True)
            self._sched_thread = t
            t.start()

    def _supervise(self, name: str, sup: Supervisor) -> None:
        # plane threads must not touch signal handlers (main-thread-only)
        self._rcs[name] = sup.run(install_signals=False)

    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads.values())

    def _sched_live(self) -> bool:
        """The fleet isn't done while grantable work is queued or a
        decision is waiting to execute — :meth:`run` keeps ticking even
        when no supervisor thread is up yet (a freshly-submitted fleet
        has zero running members until its first grant)."""
        return (self.scheduler is not None
                and not self._sched_stop.is_set()
                and (self.scheduler.pending() > 0
                     or bool(self._sched_decisions)
                     or bool(self._preempt_watch)))

    def poll(self) -> Dict[str, Dict]:
        """Per-run view: supervisor state, launches, last rc."""
        return {
            name: {"state": sup.state, "launches": sup.launches,
                   "last_rc": sup.last_rc, "rc": self._rcs[name],
                   "run_id": sup.run_id, "quarantined": sup.quarantined}
            for name, sup in self.supervisors.items()
        }

    def stop(self) -> None:
        """Stop every run (SIGTERM through the supervisors), stop the
        scheduler pump, and wake the tick loop; the supervisors stop
        relaunching and queued grants stop executing."""
        self._sched_stop.set()
        for sup in list(self.supervisors.values()):
            sup.request_stop()
        self._sleep.set()

    # ------------------------------------------------------------------ #
    # cohort surgery machinery                                           #
    # ------------------------------------------------------------------ #

    def _spec_world(self, name: str) -> Optional[int]:
        """The published cohort-spec world for this run's env-file."""
        spec = self.specs[name]
        try:
            w = parse_env_file(spec.env_file).get("JAX_NUM_PROCESSES")
            return int(w) if w is not None else None
        except (OSError, ValueError):
            return None

    def _run_probe(self, name: str) -> Dict:
        """Re-init probe for a quarantined run: bounded subprocess; exit
        0 passes, a ``CHECKSUM:<hex>`` stdout line rides the evidence.
        Probed once per quarantine episode — a failing worker stays
        quarantined (its slot never frees) until an operator intervenes."""
        spec = self.specs[name]
        result: Dict = {"t": time.time()}
        try:
            proc = subprocess.run(list(spec.probe_cmd), timeout=120.0,
                                  capture_output=True, text=True)
            result["rc"] = proc.returncode
            result["passed"] = proc.returncode == 0
            for line in (proc.stdout or "").splitlines():
                if line.startswith("CHECKSUM:"):
                    result["checksum"] = line.split(":", 1)[1].strip()
        except (OSError, subprocess.TimeoutExpired) as e:
            result.update(rc=None, passed=False, error=repr(e))
        self._probe[name] = result
        self._plane_event("probe", run=name, **result)
        if result["passed"]:
            self.pool.release(name)
        return result

    def _cohort_state(self, name: str) -> Dict:
        """The ledger view injected into each snapshot (``snap["cohort"]``)
        for the excise/readmit detectors and written to ``cohort.json``."""
        state = dict(self.pool.snapshot())
        state["pool_free"] = state.pop("free")
        sw = self._spec_world(name)
        if sw is not None:
            state["spec_world"] = sw
        probe = self._probe.get(name)
        if probe is not None:
            state["probe"] = dict(probe)
        return state

    def _relaunch(self, name: str) -> bool:
        """Fresh supervisor + thread for a readmitted run (the old one
        returned when it quarantined; a supervisor loop is one life)."""
        old = self.supervisors.get(name)
        if old is not None and old.state == "running":
            return False
        sup = self._make_supervisor(self.specs[name])
        self.supervisors[name] = sup
        self._rcs[name] = None
        self._quarantine_audited.discard(name)
        self._probe.pop(name, None)
        self.pool.activate(name)
        t = threading.Thread(target=self._supervise, args=(name, sup),
                             name=f"dgc-control-{name}", daemon=True)
        self._threads[name] = t
        if self._started:
            t.start()
        return True

    def _restart_cohort(self, readmitted: str) -> List[str]:
        """SIGTERM the readmitted run's still-running cohort peers (the
        runs sharing its env-file) so the grown spec takes effect at the
        next restart boundary."""
        env_file = self.specs[readmitted].env_file
        restarted = []
        for other, osup in self.supervisors.items():
            if other == readmitted or osup.quarantined is not None:
                continue
            if self.specs[other].env_file != env_file:
                continue
            if osup.request_restart(reason="readmit"):
                restarted.append(other)
        return restarted

    def _write_cohort_files(self) -> None:
        """Atomic ``cohort.json`` under each run dir + the fleet root:
        the monitor's COHORT line and the ``dgc_cohort_size`` /
        ``dgc_pool_free`` gauges read these."""
        # lazy import: the control package imports nothing of the
        # serving package until it writes
        from dgc_tpu_torch.serving import protocol as _sproto
        per_run = {n: self._cohort_state(n) for n in self.specs}
        fleet = dict(self.pool.snapshot(), t=time.time(),
                     runs={n: self.pool.state.get(n) for n in self.specs})
        for payload, path in (
                [(dict(per_run[n], t=time.time()),
                  os.path.join(self.specs[n].run_dir, COHORT_FILE))
                 for n in self.specs]
                + [(fleet, os.path.join(self.fleet_root, COHORT_FILE))]):
            try:
                _sproto.write_json_atomic(path, payload)
            except OSError:
                pass    # a full disk must not stop the control loop

    # ------------------------------------------------------------------ #
    # gang scheduling                                                    #
    # ------------------------------------------------------------------ #

    def submit(self, name: str, specs: Sequence[RunSpec],
               priority: int = 0, slots_max: Optional[int] = None,
               grow_spec: Optional[Callable[[int], RunSpec]] = None) -> Dict:
        """Queue a gang for admission: the member RunSpecs launch together
        when the scheduler grants their slots (and not before). ``specs``
        is ordered — member *i* is cohort seat *i*. ``grow_spec(seat)``
        (optional) mints the RunSpec for an elastic-grow seat; without it
        the gang never grows past its submitted size. ``slots_max`` caps
        autoscale growth (default: the submitted size, i.e. no growth).
        The admission itself is an audited ``control_action``."""
        if self.scheduler is None:
            raise RuntimeError("ControlPlane has no GangScheduler wired")
        specs = list(specs)
        if not specs:
            raise ValueError(f"gang {name!r} has no member specs")
        for s in specs:
            if s.name in self.specs or s.name in self._gang_of:
                raise ValueError(f"duplicate run name {s.name!r}")
        if name in self._gangs:
            raise ValueError(f"duplicate gang name {name!r}")
        slots = sum(s.slots for s in specs)
        self._gangs[name] = {
            "members": [s.name for s in specs], "priority": int(priority),
            "slots_max": int(slots_max) if slots_max is not None else slots,
            "grow_spec": grow_spec}
        self._gang_specs[name] = specs
        for s in specs:
            self._gang_of[s.name] = name
        evidence = {"kind": "submit", "gang": name, "slots": slots,
                    "priority": int(priority),
                    "members": [s.name for s in specs]}
        result = _actions.execute(
            "admit", None, evidence,
            enqueue=lambda: self.scheduler.admit(
                name, slots=slots, priority=int(priority), kind="launch"))
        return self._audit(name, f"queued:{name}", "scheduler-admit",
                           "admit", evidence, result)

    def _admit_grow(self, member: str) -> Dict:
        """The autoscale rule's enqueue hook: map the healthy run back to
        its gang and queue ONE extra seat at the gang's priority. The
        scheduler's duplicate check keeps a flapping rule from stacking
        requests; ``slots_max`` is enforced both here and (cheaper) in
        the detector's evidence gate."""
        gang = self._gang_of.get(member)
        meta = self._gangs.get(gang) if gang else None
        if meta is None:
            return {"duplicate": True, "error": "not a gang member"}
        if meta.get("grow_spec") is None:
            return {"duplicate": True, "error": "gang has no grow_spec"}
        holding = self.scheduler.holding(gang) or {}
        if int(holding.get("slots", 0)) >= meta["slots_max"]:
            return {"duplicate": True, "error": "gang at slots_max"}
        return self.scheduler.admit(gang, slots=1,
                                    priority=meta["priority"], kind="grow")

    def _register_and_start(self, spec: RunSpec) -> None:
        """Late-bound run registration: a granted gang member gets its
        supervisor + thread only when the grant executes."""
        os.makedirs(spec.run_dir, exist_ok=True)
        self.specs[spec.name] = spec
        sup = self._make_supervisor(spec)
        self.supervisors[spec.name] = sup
        self._rcs[spec.name] = None
        t = threading.Thread(target=self._supervise, args=(spec.name, sup),
                             name=f"dgc-control-{spec.name}", daemon=True)
        self._threads[spec.name] = t
        if self._started:
            t.start()

    def _sched_loop(self) -> None:
        """Scheduler pump thread ("dgc-sched"): periodically tick the
        gang scheduler and queue its decisions. It NEVER executes them —
        launches, order files, and env publishes all happen on the tick
        thread when :meth:`_drain_sched_decisions` pops the deque, so
        supervisor/pool/stream state keeps a single writer."""
        while not self._sched_stop.wait(self.interval):
            try:
                self._sched_decisions.extend(self.scheduler.tick())
            except Exception:
                pass    # a scheduler hiccup must not kill the pump

    def _drain_sched_decisions(self) -> List[Dict]:
        """Execute every queued scheduler decision (plus a synchronous
        scheduler tick, so a plane tick never waits a pump period for an
        obvious grant). Returns the audited ``control_action`` records."""
        if self._sched_stop.is_set():
            self._sched_decisions.clear()   # no launches after stop
            return []
        try:
            self._sched_decisions.extend(self.scheduler.tick())
        except Exception:
            pass
        fired: List[Dict] = []
        while self._sched_decisions:
            d = self._sched_decisions.popleft()
            try:
                rec = self._exec_decision(d)
            except Exception as e:
                self._plane_event("sched_decision_error", decision=dict(d),
                                  error=repr(e))
                continue
            if rec is not None:
                fired.append(rec)
        return fired

    def _exec_decision(self, d: Dict) -> Optional[Dict]:
        if d.get("decision") == "grant":
            if d.get("kind") == "grow":
                return self._exec_grant_grow(d)
            return self._exec_grant_launch(d)
        if d.get("decision") == "preempt_to_grant":
            return self._exec_preempt(d)
        return None

    def _exec_grant_launch(self, d: Dict) -> Optional[Dict]:
        """A queued gang got its slots: boot every member's supervisor
        and deal their seats into the pool ledger as active."""
        gang = d["name"]
        specs = self._gang_specs.get(gang)
        if specs is None:
            return None

        def launcher() -> List[str]:
            launched = []
            for spec in specs:
                if spec.name in self.supervisors:
                    continue    # idempotent: a replayed grant is a no-op
                self._register_and_start(spec)
                self.pool.add(spec.name, spec.slots)
                launched.append(spec.name)
            return launched

        evidence = dict(d, kind="grant_launch", gang=gang)
        result = _actions.execute("grant", None, evidence,
                                  launcher=launcher)
        sup = self.supervisors.get(self._gangs[gang]["members"][0])
        run_id = sup.run_id if sup is not None else f"gang:{gang}"
        return self._audit(gang, run_id, "scheduler-grant", "grant",
                           evidence, result)

    def _exec_grant_grow(self, d: Dict) -> Optional[Dict]:
        """A granted grow seat: mint the seat's RunSpec, publish the
        grown cohort spec, boot the seat, and restart the running members
        so the 1:k split reshard deals the error-feedback state onto the
        new worker (the ``grow`` action does the surgery-order hygiene)."""
        gang = d["name"]
        meta = self._gangs.get(gang)
        if meta is None or meta.get("grow_spec") is None:
            return None
        sup = self.supervisors.get(meta["members"][0])
        if sup is None:
            return None
        world = self._spec_world(meta["members"][0])
        if world is None:
            world = len(meta["members"])
        seat = world
        spec = meta["grow_spec"](seat)

        def relauncher() -> List[str]:
            meta["members"].append(spec.name)
            self._gang_specs[gang].append(spec)
            self._gang_of[spec.name] = gang
            self._register_and_start(spec)
            self.pool.add(spec.name, spec.slots)
            return [spec.name]

        evidence = dict(d, kind="grant_grow", gang=gang, seat=seat,
                        world=world + 1)
        result = _actions.execute(
            "grow", sup, evidence,
            env_updates={"JAX_NUM_PROCESSES": str(world + 1)},
            relauncher=relauncher,
            cohort_restart=lambda: self._restart_cohort(spec.name))
        return self._audit(gang, sup.run_id, "scheduler-grow", "grow",
                           evidence, result)

    def _exec_preempt(self, d: Dict) -> Optional[Dict]:
        """Shrink the victim gang by one seat through the cohort-surgery
        excise path: the order file lands in EVERY member's watch dir,
        the target seat exits 76 and self-excises, survivors relaunch
        under the shrunk spec, and the elastic merge folds the excised
        seat's residual into a survivor — zero mass lost. The freed seat
        grants to the beneficiary at a later tick (see
        :meth:`_sched_bookkeeping`)."""
        from dgc_tpu_torch.resilience import surgery as _surgery
        victim = d.get("victim")
        vmeta = self._gangs.get(victim)
        if vmeta is None:
            return None
        sup = self.supervisors.get(vmeta["members"][0])
        if sup is None:
            return None
        world = self._spec_world(vmeta["members"][0])
        if world is None:
            world = len(vmeta["members"])
        if world < 2:
            return None     # the elastic merge needs a survivor
        target = world - 1
        seat_name = vmeta["members"][target] \
            if target < len(vmeta["members"]) else vmeta["members"][-1]
        order_paths = []
        for m in vmeta["members"]:
            msup = self.supervisors.get(m)
            if msup is not None and msup.watch:
                order_paths.append(
                    os.path.join(msup.watch, _surgery.ORDER_FILE))
        evidence = dict(d, kind="preempt", gang=victim, worker=target,
                        world=world, beneficiary=d.get("name"))
        result = _actions.execute(
            "preempt_to_grant", sup, evidence,
            env_updates={"JAX_NUM_PROCESSES": str(world - 1)},
            order_paths=order_paths)
        self._preempt_watch[victim] = seat_name
        return self._audit(victim, sup.run_id, "scheduler-preempt",
                           "preempt_to_grant", evidence, result)

    def _sched_bookkeeping(self) -> None:
        """Close the scheduler's feedback loops on the tick thread:
        an excised preempt target frees its seat (``shrunk``), a gang
        with a member winding down stops being a preemption target
        (``mark_exiting``), and a fully-terminal gang returns all its
        seats (``completed``)."""
        for victim, seat in list(self._preempt_watch.items()):
            sup = self.supervisors.get(seat)
            if sup is None:
                continue
            if (sup.quarantined or "").startswith("excised:"):
                self.scheduler.shrunk(
                    victim, by=self.specs[seat].slots)
                self._preempt_watch.pop(victim, None)
                self._plane_event("sched_slot_freed", run=victim,
                                  seat=seat, reason=sup.quarantined)
        for gang, meta in self._gangs.items():
            if gang in self._gang_completed:
                continue
            members = meta["members"]
            if not all(m in self.supervisors for m in members):
                continue    # not granted yet (or grow seat mid-boot)
            if gang in self._preempt_watch:
                continue    # shrink in flight; judge after it lands
            def terminal(m: str) -> bool:
                t = self._threads.get(m)
                return (self._rcs.get(m) is not None
                        and (t is None or not t.is_alive()))
            if all(terminal(m) for m in members):
                self.scheduler.completed(gang)
                self._gang_completed.add(gang)
            elif any(terminal(m) for m in members):
                self.scheduler.mark_exiting(gang)

    def _sched_snap(self, name: str, sched_state: Dict) -> Optional[Dict]:
        """The per-run scheduler view injected as ``snap["sched"]`` for
        the autoscale detector (rules.detect_autoscale)."""
        gang = self._gang_of.get(name)
        meta = self._gangs.get(gang) if gang else None
        if meta is None:
            return None
        holding = self.scheduler.holding(gang) or {}
        return {"gang": gang, "slots": int(holding.get("slots", 0)),
                "slots_max": meta["slots_max"],
                "free": sched_state.get("free", 0),
                "pending": self.scheduler.pending()}

    # ------------------------------------------------------------------ #
    # observe -> decide -> act                                           #
    # ------------------------------------------------------------------ #

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One control cycle over every live run; returns the
        ``control_action`` records fired this tick."""
        now = time.monotonic() if now is None else now
        self.ticks += 1
        fired: List[Dict] = []
        sched_state: Optional[Dict] = None
        if self.scheduler is not None:
            # execute queued scheduler decisions FIRST (they mutate the
            # supervisor table; the per-run loop below must see a stable
            # view), then close the shrink/exit feedback loops
            fired.extend(self._drain_sched_decisions())
            self._sched_bookkeeping()
            sched_state = self.scheduler.snapshot()
        for name, sup in list(self.supervisors.items()):
            quarantined = sup.quarantined is not None
            if quarantined:
                # ledger: a quarantined run holds its slots until the
                # readmit probe frees them
                self.pool.quarantine(name)
                spec = self.specs[name]
                if (spec.probe_cmd
                        and self.pool.state.get(name) == "quarantined"
                        and name not in self._probe):
                    self._run_probe(name)
            if quarantined and name in self._quarantine_audited:
                # a self-quarantine still got its ONE audited pass; after
                # that only the readmit path may keep reasoning about the
                # run — capacity freed by its probe must flow back
                if not (self._probe.get(name) or {}).get("passed"):
                    continue
            try:
                snap = self._collect(self.specs[name].run_dir)
            except Exception:
                continue    # young/torn/missing run: no evidence yet
            snap = dict(snap, cohort=self._cohort_state(name))
            if sched_state is not None:
                sched_view = self._sched_snap(name, sched_state)
                if sched_view is not None:
                    snap["sched"] = sched_view
            for rule, evidence in self.engine.evaluate(name, snap, now):
                if (quarantined and name in self._quarantine_audited
                        and rule.action != "readmit"):
                    continue
                kw = {}
                if rule.action in ("elastic_relaunch", "excise",
                                   "readmit"):
                    kw["env_updates"] = self._planner(snap, evidence)
                if rule.action == "readmit":
                    kw["relauncher"] = \
                        lambda _n=name: self._relaunch(_n)
                    kw["cohort_restart"] = \
                        lambda _n=name: self._restart_cohort(_n)
                if rule.action == "admit":
                    kw["enqueue"] = \
                        lambda _n=name: self._admit_grow(_n)
                result = _actions.execute(rule.action, sup, evidence, **kw)
                fired.append(self._audit(name, sup.run_id, rule.name,
                                         rule.action, evidence, result))
                if rule.action in ("quarantine", "excise"):
                    if self.supervisors[name].quarantined is not None:
                        self._quarantine_audited.add(name)
                        self.pool.quarantine(name)
                    break   # no further reasoning about this run now
                if rule.action == "readmit":
                    break   # the old supervisor object is gone
        self._write_cohort_files()
        return fired

    def run(self, max_ticks: Optional[int] = None) -> Dict[str, Dict]:
        """Start the fleet and tick until every run ends (or ``max_ticks``
        control cycles pass — then the fleet is stopped). Returns the
        final :meth:`poll` view."""
        self.start()
        while self.alive() or self._sched_live():
            if max_ticks is not None and self.ticks >= max_ticks:
                self.stop()
                break
            self._sleep.wait(self.interval)
            self._sleep.clear()
            self.tick()
        for t in list(self._threads.values()):
            t.join(timeout=max(30.0, 2 * self.interval))
        self.tick()     # final pass: audit anything the exits revealed
        if self._sched_thread is not None:
            self._sched_stop.set()
            self._sched_thread.join(timeout=max(30.0, 2 * self.interval))
        final = self.poll()
        self._plane_event("plane_stop", ticks=self.ticks,
                          actions=len(self.actions), runs=final)
        return final
