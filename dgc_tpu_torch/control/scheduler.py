"""``GangScheduler`` — pool-wide slot-aware gang scheduling with
preempt-to-grant (counterpart of ``dgc_tpu/control/scheduler.py``).

The control plane's :class:`~dgc_tpu_torch.control.plane.DevicePool`
ledger alone could only readmit an evicted worker into its *own* run, so
slots freed by a quarantine stranded while other queued work starved.
The scheduler closes that gap: it owns the pool-wide slot accounting,
admits queued gangs (a gang = every member RunSpec of one training
cohort, granted together or not at all), honors per-gang priorities with
FIFO tie-breaking by admit time, and — when the head of the queue cannot
be granted from free capacity — shrinks a strictly-lower-priority
running gang through the existing cohort-surgery excise path (atomic
order file, exit 76, elastic merge conserves the excised seat's
error-feedback mass) to free the slots: **preempt-to-grant**. DGC makes
this safe where generic gang scheduling is lossy: shrinking a run loses
zero gradient mass, because the residual the excised worker never
transmitted is folded into a survivor at the elastic merge
(:mod:`dgc_tpu_torch.resilience.elastic`).

State machine per queue entry::

    admit ──► queued ──► grant ──► running ──► (shrunk)* ──► completed
                 │                    ▲
                 │   preempt_to_grant │  (a lower-priority gang shrinks,
                 └────────────────────┘   its freed seat grants the head)

Every transition is persisted twice, under the reference's
"scheduler-ledger" protocol (the same files, so either package's
monitor reads either package's scheduler):

* ``sched_queue.json`` — the current queue + holdings snapshot, written
  atomically (mkstemp + fsync + rename) on every mutation; a torn file
  reads as "no snapshot", never garbage.
* ``sched_grants.jsonl`` — the append-only grant ledger, one record per
  transition, flushed per record; a crash may tear the last line, so
  readers are tolerant (skip-and-count). Each intact record carries the
  full slot accounting (``total``/``held``/``free``) so a reader can
  assert conservation at every crash point.

The scheduler is host-only and fake-clock friendly: construct with
``clock=`` and/or pass ``now=`` to any mutator, and the unit tests drive
starvation/fairness edges in milliseconds. All cross-thread state (the
plane runs ``tick()`` on a dedicated scheduler loop thread) is guarded
by one lock.
"""

import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from dgc_tpu_torch.telemetry.sink import JsonlAppender

__all__ = ["QueueEntry", "GangScheduler", "SCHED_QUEUE", "SCHED_GRANTS",
           "read_queue", "read_grant_ledger", "grant_latency_summary"]

#: atomic queue + holdings snapshot under the fleet root
SCHED_QUEUE = "sched_queue.json"
#: append-only grant ledger under the fleet root
SCHED_GRANTS = "sched_grants.jsonl"


class QueueEntry(NamedTuple):
    """One queued admission: a whole gang (``kind="launch"``) or one
    extra seat for a running gang (``kind="grow"``)."""
    name: str
    slots: int
    priority: int
    admit_t: float
    kind: str = "launch"
    seq: int = 0

    def to_dict(self) -> Dict:
        return dict(self._asdict())


class GangScheduler:
    """Slot ledger + admission queue + grant policy for one device pool.

    ``total_slots`` is the pool's capacity in seats. ``root`` (optional)
    is where the queue snapshot and grant ledger persist — pass the
    control plane's fleet root so the monitor's SCHED lane can read
    them; ``None`` keeps the scheduler purely in
    memory (fast unit tests). ``clock`` injects a fake clock.
    """

    def __init__(self, total_slots: int, root: Optional[str] = None,
                 clock: Callable[[], float] = time.time):
        if int(total_slots) <= 0:
            raise ValueError(f"total_slots must be > 0, got {total_slots}")
        self.total = int(total_slots)
        self.root = os.path.abspath(root) if root else None
        # one lock guards every piece of cross-thread state below: the
        # plane's scheduler loop thread ticks while submit()/shrunk()/
        # completed() arrive from the plane's tick thread
        self._lock = threading.Lock()
        self._clock = clock
        self._seq = 0
        self._queue: List[QueueEntry] = []
        #: name -> {"slots", "priority", "state": active|exiting}
        self._holdings: Dict[str, Dict] = {}
        #: victim gang -> beneficiary entry name (preempt in flight; the
        #: victim is shrinking and must not be targeted again)
        self._preempt_inflight: Dict[str, str] = {}
        self._unschedulable: set = set()
        if self.root is not None:
            # crash recovery: resume the transition sequence past
            # everything durable (queue snapshot AND ledger — whichever
            # ran ahead when the last incarnation died), so seq stays
            # strictly monotonic across scheduler restarts and the
            # ledger's surviving prefix remains the true history
            snap = read_queue(self.root)
            if snap is not None and isinstance(snap.get("seq"), int):
                self._seq = max(self._seq, snap["seq"])
            for rec in read_grant_ledger(self.root)[0]:
                if isinstance(rec.get("seq"), int):
                    self._seq = max(self._seq, rec["seq"])
        self._ledger = (JsonlAppender(os.path.join(self.root, SCHED_GRANTS))
                        if self.root else None)

    # ------------------------------------------------------------------ #
    # persistence (the "scheduler-ledger" protocol)                      #
    # ------------------------------------------------------------------ #

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else float(now)

    def _held_locked(self) -> int:
        return sum(h["slots"] for h in self._holdings.values())

    def _free_locked(self) -> int:
        return self.total - self._held_locked()

    def _record_locked(self, event: str, name: str, now: float,
                       **fields) -> Dict:
        """Append one transition to the grant ledger (torn-tail-tolerant
        stream) with the full slot accounting, so every intact record is
        a conservation check: held + free == total."""
        self._seq += 1
        rec = dict(fields, event=event, name=name, seq=self._seq,
                   t=round(now, 6), total=self.total,
                   held=self._held_locked(), free=self._free_locked())
        if self._ledger is not None:
            try:
                self._ledger.write(rec)
            except OSError:
                pass    # a full disk must not wedge the scheduler
        return rec

    def _write_queue_locked(self, now: float) -> None:
        """Atomic queue + holdings snapshot — the monitor's SCHED lane
        and a recovering scheduler read this; it must never be torn."""
        if self.root is None:
            return
        # lazy import: the control package imports nothing of the
        # serving package until it writes
        from dgc_tpu_torch.serving import protocol as _sproto
        snap = {"t": round(now, 6), "total": self.total,
                "free": self._free_locked(), "seq": self._seq,
                "queue": [e.to_dict() for e in self._queue],
                "holdings": {n: dict(h)
                             for n, h in sorted(self._holdings.items())},
                "unschedulable": sorted(self._unschedulable)}
        try:
            _sproto.write_json_atomic(
                os.path.join(self.root, SCHED_QUEUE), snap)
        except OSError:
            pass    # a full disk must not wedge the scheduler

    # ------------------------------------------------------------------ #
    # admission                                                          #
    # ------------------------------------------------------------------ #

    def admit(self, name: str, slots: int, priority: int = 0,
              kind: str = "launch", now: Optional[float] = None) -> Dict:
        """Queue a gang (or a grow request). Returns the admit ledger
        record; a duplicate pending (name, kind) is rejected with
        ``{"duplicate": True}`` so a flapping autoscale rule cannot
        stack requests."""
        if kind not in ("launch", "grow"):
            raise ValueError(f"unknown admission kind {kind!r}")
        now = self._now(now)
        with self._lock:
            if any(e.name == name and e.kind == kind for e in self._queue):
                return {"duplicate": True, "name": name, "kind": kind}
            entry = QueueEntry(name=str(name), slots=int(slots),
                               priority=int(priority), admit_t=now,
                               kind=kind, seq=self._seq + 1)
            self._queue.append(entry)
            rec = self._record_locked("admit", name, now, kind=kind,
                                      slots=int(slots),
                                      priority=int(priority),
                                      queue_depth=len(self._queue))
            self._write_queue_locked(now)
        return rec

    def cancel(self, name: str, kind: Optional[str] = None,
               now: Optional[float] = None) -> bool:
        """Drop pending admissions for ``name`` (both kinds unless one
        is named) — e.g. the gang's owner gave up waiting."""
        now = self._now(now)
        with self._lock:
            before = len(self._queue)
            self._queue = [e for e in self._queue
                           if not (e.name == name
                                   and (kind is None or e.kind == kind))]
            dropped = before - len(self._queue)
            if dropped:
                self._record_locked("cancel", name, now, dropped=dropped)
                self._write_queue_locked(now)
        return bool(dropped)

    # ------------------------------------------------------------------ #
    # holdings bookkeeping (driven by the control plane)                 #
    # ------------------------------------------------------------------ #

    def shrunk(self, name: str, by: int = 1,
               now: Optional[float] = None) -> None:
        """A running gang completed an excise: ``by`` seats came back to
        the pool (the surgery path conserved their error-feedback mass
        into the survivors). Clears any preempt in flight against it."""
        now = self._now(now)
        with self._lock:
            h = self._holdings.get(name)
            if h is None:
                return
            h["slots"] = max(0, h["slots"] - int(by))
            beneficiary = self._preempt_inflight.pop(name, None)
            if h["slots"] == 0:
                self._holdings.pop(name)
            self._record_locked("shrunk", name, now, by=int(by),
                                beneficiary=beneficiary)
            self._write_queue_locked(now)

    def grown(self, name: str, by: int = 1,
              now: Optional[float] = None) -> None:
        """Accounting for a grow executed outside a grant (operator
        action): the gang now holds ``by`` more seats."""
        now = self._now(now)
        with self._lock:
            h = self._holdings.get(name)
            if h is None:
                return
            h["slots"] += int(by)
            self._record_locked("grown", name, now, by=int(by))
            self._write_queue_locked(now)

    def mark_exiting(self, name: str, now: Optional[float] = None) -> None:
        """The gang is already winding down (done / excise in progress /
        stop requested): its seats will free on their own, so it is not
        a preemption target — shrinking a dying run buys nothing and
        races its exit."""
        now = self._now(now)
        with self._lock:
            h = self._holdings.get(name)
            if h is not None and h["state"] != "exiting":
                h["state"] = "exiting"
                self._record_locked("exiting", name, now)
                self._write_queue_locked(now)

    def completed(self, name: str, now: Optional[float] = None) -> None:
        """The gang ended (done, gave up, or fully quarantined): all its
        seats return to the pool."""
        now = self._now(now)
        with self._lock:
            h = self._holdings.pop(name, None)
            if h is None:
                return
            self._preempt_inflight.pop(name, None)
            self._record_locked("completed", name, now,
                                released=h["slots"])
            self._write_queue_locked(now)

    # ------------------------------------------------------------------ #
    # the grant policy                                                   #
    # ------------------------------------------------------------------ #

    def _order_locked(self) -> List[QueueEntry]:
        """Grant order: priority first, then FIFO by admit time (the
        pinned tie-break), then admission sequence for same-instant
        fake-clock admissions."""
        return sorted(self._queue,
                      key=lambda e: (-e.priority, e.admit_t, e.seq))

    def _pick_victim_locked(self, entry: QueueEntry) -> Optional[str]:
        """Lowest-priority running gang strictly below the starved
        entry's priority, not already shrinking, not exiting, and with a
        seat to spare (the elastic merge needs a survivor, so a gang is
        never preempted below one seat)."""
        candidates = [
            (h["priority"], n) for n, h in self._holdings.items()
            if h["state"] == "active" and h["priority"] < entry.priority
            and h["slots"] >= 2 and n not in self._preempt_inflight
            and n != entry.name]
        if not candidates:
            return None
        return min(candidates)[1]

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One scheduling pass: grant whatever fits, and when the head
        of the queue is starved, issue at most one preempt-to-grant
        decision against the best victim. Returns decision dicts for the
        control plane to execute (``{"decision": "grant" | "preempt_to_"
        "grant", ...}``); the scheduler itself only moves ledger state.
        """
        now = self._now(now)
        decisions: List[Dict] = []
        with self._lock:
            changed = False
            for entry in self._order_locked():
                if entry.slots > self.total:
                    if entry.name not in self._unschedulable:
                        # permanently starved: demand exceeds the whole
                        # pool — surfaced once, then skipped so smaller
                        # work behind it is never head-of-line blocked
                        self._unschedulable.add(entry.name)
                        self._record_locked(
                            "unschedulable", entry.name, now,
                            slots=entry.slots, pool_total=self.total)
                        changed = True
                    continue
                free = self._free_locked()
                if entry.slots <= free:
                    self._queue.remove(entry)
                    h = self._holdings.setdefault(
                        entry.name, {"slots": 0, "priority": entry.priority,
                                     "state": "active"})
                    h["slots"] += entry.slots
                    h["priority"] = max(h["priority"], entry.priority)
                    wait_s = max(0.0, now - entry.admit_t)
                    rec = self._record_locked(
                        "grant", entry.name, now, kind=entry.kind,
                        slots=entry.slots, priority=entry.priority,
                        wait_s=round(wait_s, 6),
                        queue_depth=len(self._queue))
                    decisions.append({
                        "decision": "grant", "name": entry.name,
                        "kind": entry.kind, "slots": entry.slots,
                        "priority": entry.priority,
                        "wait_s": rec["wait_s"], "free": rec["free"]})
                    changed = True
                    continue
                # head of the schedulable queue is starved: preempt the
                # best victim (one seat per decision — the excise path
                # cuts one worker at a time), then stop; lower-priority
                # entries must not jump it
                if entry.name in self._preempt_inflight.values():
                    break   # a shrink is already freeing seats for this
                            # head: wait for it, don't stack victims
                victim = self._pick_victim_locked(entry)
                if victim is not None:
                    self._preempt_inflight[victim] = entry.name
                    self._record_locked(
                        "preempt", victim, now, beneficiary=entry.name,
                        beneficiary_priority=entry.priority,
                        victim_priority=self._holdings[victim]["priority"],
                        short=entry.slots - free)
                    decisions.append({
                        "decision": "preempt_to_grant",
                        "name": entry.name, "kind": entry.kind,
                        "victim": victim,
                        "victim_priority":
                            self._holdings[victim]["priority"],
                        "priority": entry.priority,
                        "slots": entry.slots, "free": free,
                        "short": entry.slots - free})
                    changed = True
                break
            if changed:
                self._write_queue_locked(now)
        return decisions

    # ------------------------------------------------------------------ #
    # views                                                              #
    # ------------------------------------------------------------------ #

    def pending(self) -> int:
        """Schedulable queue depth (permanently-starved entries are
        excluded — they will never grant, and must not keep a control
        loop spinning)."""
        with self._lock:
            return sum(1 for e in self._queue
                       if e.slots <= self.total)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"total": self.total, "free": self._free_locked(),
                    "held": self._held_locked(), "seq": self._seq,
                    "queue": [e.to_dict() for e in self._order_locked()],
                    "holdings": {n: dict(h)
                                 for n, h in sorted(self._holdings.items())},
                    "unschedulable": sorted(self._unschedulable),
                    "preempt_inflight": dict(self._preempt_inflight)}

    def holding(self, name: str) -> Optional[Dict]:
        with self._lock:
            h = self._holdings.get(name)
            return dict(h) if h is not None else None

    def close(self) -> None:
        if self._ledger is not None:
            self._ledger.close()


# ---------------------------------------------------------------------- #
# readers (blessed tolerant readers of the scheduler-ledger protocol)    #
# ---------------------------------------------------------------------- #

def read_queue(root: str) -> Optional[Dict]:
    """The queue snapshot, or ``None`` when absent/torn/not-a-snapshot —
    the RENAME_ATOMIC writer means a torn file can only be a crashed
    temp, never the published path, so None is always safe."""
    path = os.path.join(root, SCHED_QUEUE)
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(obj, dict) or "total" not in obj \
            or "queue" not in obj:
        return None
    return obj


def read_grant_ledger(root: str):
    """``(records, skipped)`` from the append-only grant ledger. A live
    writer (or a crash) may tear the final line — torn lines are skipped
    and counted, matching the APPEND_TAIL_TORN atomicity class."""
    path = os.path.join(root, SCHED_GRANTS)
    records: List[Dict] = []
    skipped = 0
    try:
        with open(path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                try:
                    obj = json.loads(ln)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(obj, dict):
                    records.append(obj)
                else:
                    skipped += 1
    except OSError:
        return [], 0
    return records, skipped


def grant_latency_summary(records: List[Dict]) -> Optional[Dict]:
    """Grant-latency stats over ledger records: median/max/n of
    ``wait_s`` across ``grant`` transitions (the regress-gated
    ``grant_latency_s`` metric reads the median)."""
    waits = sorted(float(r["wait_s"]) for r in records
                   if r.get("event") == "grant"
                   and isinstance(r.get("wait_s"), (int, float)))
    if not waits:
        return None
    n = len(waits)
    mid = n // 2
    median = waits[mid] if n % 2 else 0.5 * (waits[mid - 1] + waits[mid])
    return {"median_s": median, "max_s": waits[-1], "n": n}
