"""Restart supervisor as a library (host-side code; counterpart of
``dgc_tpu/control/supervisor.py``, with its flag surface and event
schema).

The launch / backoff / progress-watch loop for one training run, so the
control plane (:mod:`dgc_tpu_torch.control.plane`) can own N of them
concurrently, one thread each. ``python -m
dgc_tpu_torch.control.supervisor [options] -- <training command>`` is
the single-run CLI over this class. The cohort keys keep the reference's
``JAX_*`` names: the port's launcher reads them
(:func:`dgc_tpu_torch.parallel.multihost.initialize_multihost`).

Mechanics (shared by CLI and control plane):

* ``env_file`` is re-read before EVERY launch and its ``KEY=VALUE`` lines
  override the child environment — the cluster manager's (and the control
  plane's) hook for publishing a new cohort spec
  (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``) after a slice comes back with a different shape.
* a child exit code in ``success_codes`` (default ``0``) ends the loop
  successfully; a code in ``quarantine_codes`` (default ``70``,
  EX_SOFTWARE — the trainer's nonfinite-streak abort) quarantines the
  run: no relaunch, artifacts kept for post-mortem. Exit code 75
  (EX_TEMPFAIL) is the convention for "preempted after a clean emergency
  save — relaunch me"; a code in ``surgery_codes`` (default ``76``,
  cohort surgery, :mod:`dgc_tpu_torch.resilience.surgery`) applies the
  workers' ``surgery_exit.json`` record (publish the shrunk cohort spec,
  remap this survivor's ``JAX_PROCESS_ID`` around the excised slot, or
  self-quarantine when THIS worker is the one cut out) and relaunches
  immediately with the retry budget reset; anything else relaunches
  against the retry budget.
* retries are budgeted against *progress*: when ``watch`` names the
  checkpoint directory and its ``latest.json`` changed since the last
  launch (an emergency save counts), the failure counter resets.
* every event is stamped with a per-supervisor ``run_id`` and the cohort
  spec from the latest env read, flushed per event; the same ``run_id``
  is exported to the child as ``DGC_RUN_ID`` so its telemetry header and
  the supervise stream agree on which run this is.

Library extensions on top of the CLI behavior — all host-only, called
from the control plane's thread:

* ``on_event`` — callback receiving every event record (the plane's
  fleet-wide stream re-stamps and merges them).
* ``request_restart()`` — SIGTERM the child *without* stopping the loop:
  the child takes its emergency-save path, exits 75, and the loop
  relaunches it (with whatever cohort spec the env-file now publishes).
* ``request_stop()`` — SIGTERM the child and stop relaunching (the CLI's
  signal handler routes here).
* ``quarantine(reason)`` — stop relaunching but keep artifacts; also
  entered automatically on a ``quarantine_codes`` exit.
* ``request_kill()`` — SIGKILL the child (the watchdog escalation tier:
  a SIGTERM assumes a responsive process; a hung one gets no courtesy).
* ``hang_timeout``/``heartbeat`` — supervisor-side hang escalation: the
  child's :class:`~dgc_tpu_torch.resilience.preempt.Watchdog` refreshes the
  heartbeat file's mtime each step (the path is exported to the child as
  ``DGC_HEARTBEAT``); a monitor thread SIGKILLs + quarantines the child
  once the mtime goes stale past ``hang_timeout`` seconds. The
  survivors' blocked agreement collective then errors out and they take
  the exit-76 surgery path.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from dgc_tpu_torch.telemetry.sink import JsonlAppender

__all__ = ["parse_env_file", "checkpoint_progress", "COHORT_KEYS",
           "default_events_path", "Supervisor", "main"]


def parse_env_file(path):
    """KEY=VALUE lines (blank lines and ``#`` comments ignored)."""
    out = {}
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def checkpoint_progress(watch_dir):
    """(epoch, mtime) of ``latest.json``; None when absent/unreadable."""
    if not watch_dir:
        return None
    path = os.path.join(watch_dir, "latest.json")
    try:
        with open(path) as f:
            epoch = json.load(f).get("epoch")
        return (epoch, os.path.getmtime(path))
    except (OSError, ValueError):
        return None


#: cohort-spec env keys stamped into every event (the monitor's view of
#: the world shape each launch ran under)
COHORT_KEYS = ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
               "JAX_COORDINATOR_ADDRESS")


def default_events_path(watch):
    """``supervise_events.jsonl`` next to the watched checkpoint dir —
    i.e. under the run dir, where the live monitor looks for it."""
    if not watch:
        return None
    return os.path.join(os.path.dirname(os.path.abspath(watch)),
                        "supervise_events.jsonl")


class Supervisor:
    """Bounded-retry relaunch loop for one training run.

    ``run()`` blocks until the run ends (done / stopped / gave up /
    quarantined) and returns the final child exit code (0 on success) —
    run it on a dedicated thread when supervising a fleet. All the
    ``request_*`` methods are safe to call from another thread.
    """

    def __init__(self, cmd, retries=5, backoff=5.0, backoff_max=300.0,
                 env_file=None, watch=None, events=None,
                 success_codes=(0,), quarantine_codes=(70,),
                 surgery_codes=(76,), hang_timeout=None, heartbeat=None,
                 name=None, extra_env=None, on_event=None):
        self.cmd = list(cmd)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self.env_file = env_file
        self.watch = watch
        self.events_path = events
        self.success_codes = set(success_codes)
        self.quarantine_codes = set(quarantine_codes or ())
        self.surgery_codes = set(surgery_codes or ())
        self.hang_timeout = (float(hang_timeout)
                             if hang_timeout else None)
        self.heartbeat = heartbeat
        if self.hang_timeout and not self.heartbeat and watch:
            self.heartbeat = os.path.join(
                os.path.dirname(os.path.abspath(watch)), "heartbeat")
        self.name = name
        self.extra_env = dict(extra_env or {})
        self.on_event = on_event
        self.child = None
        self.shutting_down = False
        self.quarantined = None     # reason string once quarantined
        self.launches = 0
        self.last_rc = None
        self._surgery_applied_t = None   # dedup: apply each record once
        self.state = "idle"         # running|done|stopped|gave_up|quarantined
        # one id per supervisor lifetime: every relaunch of this run
        # shares it, a fresh supervisor gets a fresh one
        stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        self.run_id = f"{name}-{stamp}" if name else stamp
        self.cohort = {k: os.environ.get(k) for k in COHORT_KEYS
                       if os.environ.get(k) is not None}
        self._events = JsonlAppender(events) if events else None
        # decorrelated-jitter backoff state: the previous delay seeds the
        # next draw's upper bound. Per-instance RNG so tests can seed it
        # and a fleet of supervisors never shares a stream.
        self._last_delay = 0.0
        self._rng = random.Random()
        self._wake = threading.Event()
        # guards child/quarantined/shutting_down/launches/cohort — shared
        # between run(), the hang-watch thread, and cross-thread
        # request_*() callers. Never held across Popen/wait/event I/O.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # events                                                             #
    # ------------------------------------------------------------------ #

    def event(self, kind, **fields):
        with self._lock:
            launches, cohort = self.launches, dict(self.cohort)
        rec = dict(fields, event=kind, t=time.time(),
                   launches=launches, run_id=self.run_id,
                   cohort=cohort)
        tag = f"[supervise:{self.name}]" if self.name else "[supervise]"
        line = json.dumps(rec)
        print(f"{tag} {line}", flush=True)
        if self._events is not None:
            # persistent handle, flushed per event: a tailing monitor
            # sees every launch/relaunch as it happens, and relaunch
            # churn doesn't reopen the file hundreds of times
            self._events.write(rec)
        if self.on_event is not None:
            try:
                self.on_event(dict(rec))
            except Exception as e:  # a broken stream must not kill the run
                print(f"{tag} on_event failed: {e!r}", flush=True)

    # ------------------------------------------------------------------ #
    # cross-thread controls                                              #
    # ------------------------------------------------------------------ #

    def _signal_child(self, signum=signal.SIGTERM):
        with self._lock:
            child = self.child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
                return True
            except OSError:
                pass
        return False

    def request_restart(self, reason=None):
        """SIGTERM the child WITHOUT stopping the loop: it emergency-saves,
        exits 75, and relaunches under the current env-file cohort spec.
        Returns True when the signal was delivered to a live child."""
        delivered = self._signal_child(signal.SIGTERM)
        self.event("restart_request", reason=reason, delivered=delivered)
        return delivered

    def request_kill(self, reason="hang"):
        """SIGKILL the child — the watchdog escalation tier for a hung
        process (SIGTERM would route to a signal handler the process may
        never service again). Quarantines the run first so the loop
        holds the corpse for post-mortem instead of relaunching it."""
        with self._lock:
            if self.quarantined is None:
                self.quarantined = f"hang:{reason}"
        delivered = self._signal_child(signal.SIGKILL)
        self.event("hang_kill", reason=reason, delivered=delivered)
        return delivered

    def request_stop(self, reason="signal"):
        """Stop relaunching and pass SIGTERM through so the child takes
        its emergency-save path (the CLI signal handler routes here)."""
        with self._lock:
            self.shutting_down = True
        self._signal_child(signal.SIGTERM)
        self._wake.set()

    def quarantine(self, reason):
        """Stop relaunching but keep every artifact (telemetry, flight
        dump, checkpoints) for post-mortem. Does NOT kill a live child —
        a run is quarantined for what it did, not executed for it."""
        with self._lock:
            if self.quarantined is None:
                self.quarantined = str(reason)
        self._wake.set()

    def _forward(self, signum, frame):
        # the scheduler is tearing US down: stop relaunching, pass the
        # signal through so the child takes its emergency-save path
        with self._lock:
            self.shutting_down = True
        self._signal_child(signum)
        self._wake.set()

    # ------------------------------------------------------------------ #
    # hang escalation + cohort surgery                                   #
    # ------------------------------------------------------------------ #

    def _watch_hang(self, child, launched_at):
        """Monitor thread, one per launch: SIGKILL + quarantine the
        child once the heartbeat file's mtime goes stale past
        ``hang_timeout`` (startup counts from launch time, so a long
        first compile needs a budget to match)."""
        poll = max(0.05, min(1.0, self.hang_timeout / 4.0))
        while child.poll() is None:
            time.sleep(poll)
            with self._lock:
                current = self.child
            if child.poll() is not None or current is not child:
                return
            try:
                last = os.path.getmtime(self.heartbeat)
            except OSError:
                last = None
            ref = max(launched_at, last) if last is not None else launched_at
            stale = time.time() - ref
            if stale > self.hang_timeout:
                self.request_kill(reason=f"no heartbeat for {stale:.1f}s "
                                         f"(budget {self.hang_timeout}s)")
                return

    def _apply_surgery(self, rc):
        """Exit-76 bookkeeping, applied once per exit record: publish
        the shrunk cohort spec (idempotent — derived from the record's
        FROM-world, so every survivor's supervisor computes the same
        value and racing publishes agree), remap this run's
        ``JAX_PROCESS_ID`` around the excised slot, and detect
        self-excision (this run IS the target → quarantine, the cohort
        spec no longer has a seat for it)."""
        from dgc_tpu_torch.resilience import surgery as _surgery
        info = {}
        rec = None
        if self.watch:
            rec = _surgery.read_exit_record(
                os.path.join(self.watch, _surgery.EXIT_RECORD))
        if not rec or rec.get("t") == self._surgery_applied_t:
            return info
        self._surgery_applied_t = rec.get("t")
        target = int(rec.get("target", -1))
        info.update(verdict=rec.get("verdict"), target=target,
                    lost=bool(rec.get("lost")))
        try:
            world = int(rec.get("world") or 0)
        except (TypeError, ValueError):
            world = 0
        updates = _surgery.shrink_updates(world, target)
        if updates:
            info["world"] = int(updates["JAX_NUM_PROCESSES"])
            if self.env_file:
                from dgc_tpu_torch.control.actions import publish_env
                publish_env(self.env_file, updates)
                info["published"] = updates
        pid = self.extra_env.get("JAX_PROCESS_ID",
                                 os.environ.get("JAX_PROCESS_ID"))
        if pid is not None and target >= 0:
            new_pid = _surgery.remap_process_id(pid, target)
            if new_pid is None:
                info["excised"] = True
            elif new_pid != int(pid):
                self.extra_env["JAX_PROCESS_ID"] = str(new_pid)
                info["process_id"] = new_pid
        return info

    # ------------------------------------------------------------------ #
    # the loop                                                           #
    # ------------------------------------------------------------------ #

    def _next_delay(self, failures):
        """Decorrelated-jitter backoff: the first retry waits exactly
        ``backoff``; each later delay draws uniformly from
        ``[backoff, min(3 * previous, backoff_max)]``. A correlated fleet
        failure (one bad switch kills every child at once) then spreads
        its relaunch storm out instead of hammering the coordinator in
        exponential lockstep — same expected growth as doubling, none of
        the synchronization. Checkpoint progress resets ``failures`` and
        with it the spread."""
        if failures <= 1:
            self._last_delay = 0.0
        lo = min(self.backoff, self.backoff_max)
        hi = min(max(3.0 * self._last_delay, lo), self.backoff_max)
        delay = self._rng.uniform(lo, hi) if hi > lo else lo
        self._last_delay = delay
        return delay

    def run(self, install_signals=None):
        """Supervise until the run ends; returns the final exit code.
        ``install_signals`` defaults to True only on the main thread
        (signal.signal is main-thread-only; plane threads skip it)."""
        if install_signals is None:
            install_signals = (threading.current_thread()
                               is threading.main_thread())
        if install_signals:
            for s in (signal.SIGTERM, signal.SIGINT):
                signal.signal(s, self._forward)
        self.state = "running"
        failures = 0
        while True:
            env = dict(os.environ)
            env.update(self.extra_env)      # the run's baseline env ...
            overrides = parse_env_file(self.env_file)
            env.update(overrides)           # ... under the LIVE cohort spec
            # the child's telemetry header and this event stream must
            # agree on which run this is
            env["DGC_RUN_ID"] = self.run_id
            # latest cohort spec (the env-file may have re-shaped the
            # world since the last launch) rides every event from here on
            cohort = {k: env.get(k) for k in COHORT_KEYS
                      if env.get(k) is not None}
            with self._lock:
                self.cohort = cohort
            if self.heartbeat:
                # the child's Watchdog refreshes this file's mtime; the
                # hang monitor below is its supervisor-side consumer
                env["DGC_HEARTBEAT"] = self.heartbeat
            before = checkpoint_progress(self.watch)
            with self._lock:
                self.launches += 1
            self.event("launch", cmd=self.cmd,
                       world=env.get("JAX_NUM_PROCESSES"),
                       env_overrides=sorted(overrides))
            t0 = time.time()
            child = subprocess.Popen(self.cmd, env=env)
            with self._lock:
                self.child = child
            if self.hang_timeout and self.heartbeat:
                threading.Thread(target=self._watch_hang,
                                 args=(child, t0),
                                 name="dgc-hang-watch", daemon=True).start()
            rc = child.wait()
            with self._lock:
                self.child = None
            self.last_rc = rc
            elapsed = time.time() - t0
            if rc in self.success_codes:
                self.state = "done"
                self.event("done", rc=rc, elapsed=elapsed)
                return 0
            after = checkpoint_progress(self.watch)
            progressed = after is not None and after != before
            if progressed:
                # visible checkpoint progress (a preemption's emergency
                # save included) is not a failure: the retry budget
                # guards against crash loops, not against preemptions
                failures = 0
            else:
                failures += 1
            with self._lock:
                surgery_due = (rc in self.surgery_codes
                               and self.quarantined is None
                               and not self.shutting_down)
            if surgery_due:
                info = self._apply_surgery(rc)
                if info.pop("excised", False):
                    # the shrunk spec has no seat for this worker: it is
                    # the one being cut out — hold it for the readmit
                    # probe instead of relaunching into a dead slot
                    with self._lock:
                        self.quarantined = \
                            f"excised:{info.get('verdict') or rc}"
                else:
                    failures = 0    # a deliberate transition, not a crash
                    self.event("surgery", rc=rc, elapsed=elapsed, **info)
                    continue
            with self._lock:
                if (rc in self.quarantine_codes
                        and self.quarantined is None):
                    self.quarantined = f"exit:{rc}"
                quarantined = self.quarantined
                stopping = self.shutting_down
            if quarantined is not None:
                self.state = "quarantined"
                self.event("quarantined", rc=rc, reason=quarantined)
                return rc
            if stopping:
                self.state = "stopped"
                self.event("stopped", rc=rc, reason="signal")
                return rc
            if failures > self.retries:
                self.state = "gave_up"
                self.event("giveup", rc=rc, failures=failures,
                           retries=self.retries)
                return rc
            delay = self._next_delay(failures)
            self.event("relaunch", rc=rc, elapsed=elapsed,
                       failures=failures, delay=delay,
                       progressed=progressed)
            # interruptible backoff: a stop/quarantine lands immediately
            # instead of after the full delay
            self._wake.wait(delay)
            self._wake.clear()
            with self._lock:
                quarantined = self.quarantined
                stopping = self.shutting_down
            if quarantined is not None:
                self.state = "quarantined"
                self.event("quarantined", rc=rc, reason=quarantined)
                return rc
            if stopping:
                self.state = "stopped"
                self.event("stopped", rc=rc, reason="signal")
                return rc


def main(argv=None):
    """The single-run CLI (the reference's ``scripts/supervise.py``): one
    run, this process's signals."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Restart supervisor for elastic training.",
        usage="python -m dgc_tpu_torch.control.supervisor [options] -- "
              "<training command ...>")
    parser.add_argument("--retries", type=int, default=5,
                        help="consecutive no-progress failures before "
                             "giving up (progress resets the count)")
    parser.add_argument("--backoff", type=float, default=5.0,
                        help="initial relaunch delay, doubled per "
                             "consecutive failure")
    parser.add_argument("--backoff-max", type=float, default=300.0)
    parser.add_argument("--env-file", default=None,
                        help="KEY=VALUE file re-read before every launch; "
                             "overrides the child environment (new cohort "
                             "spec goes here)")
    parser.add_argument("--watch", default=None,
                        help="checkpoint directory; progress in its "
                             "latest.json resets the retry budget")
    parser.add_argument("--events-out", default=None,
                        help="append one JSON line per supervisor event; "
                             "defaults to supervise_events.jsonl next to "
                             "the --watch dir (under the run dir)")
    parser.add_argument("--events", default=None,
                        help="legacy alias for --events-out (takes "
                             "precedence when both are given)")
    parser.add_argument("--success-codes", default="0",
                        help="comma-separated child exit codes that end "
                             "the loop successfully")
    parser.add_argument("--surgery-codes", default="76",
                        help="comma-separated child exit codes treated "
                             "as cohort surgery: apply surgery_exit.json "
                             "(shrunk spec + process-id remap) and "
                             "relaunch immediately; empty disables")
    parser.add_argument("--hang-timeout", type=float, default=None,
                        help="SIGKILL + quarantine the child when its "
                             "heartbeat file goes stale for this many "
                             "seconds (the watchdog escalation tier)")
    parser.add_argument("--heartbeat", default=None,
                        help="heartbeat file path (exported to the child "
                             "as DGC_HEARTBEAT; defaults to 'heartbeat' "
                             "next to the --watch dir)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- then the training command")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no training command given (put it after --)")
    events = (args.events or args.events_out
              or default_events_path(args.watch))
    sup = Supervisor(
        cmd, retries=args.retries, backoff=args.backoff,
        backoff_max=args.backoff_max, env_file=args.env_file,
        watch=args.watch, events=events,
        success_codes={int(c) for c in args.success_codes.split(",")},
        surgery_codes={int(c) for c in args.surgery_codes.split(",")
                       if c.strip()},
        hang_timeout=args.hang_timeout, heartbeat=args.heartbeat)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
