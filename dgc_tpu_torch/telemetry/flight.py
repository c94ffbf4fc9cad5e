"""Crash flight recorder: a fixed-size ring of recent step records.

A copy of ``dgc_tpu/telemetry/flight.py`` (JAX-free there too), reading
torch tensors as well at dump time.

The train loop calls :meth:`FlightRecorder.record` once per step with
whatever it has on hand — step number, loss (a *device* array is fine
and expected: the ring stores values raw, so recording never forces a
host sync), guard counters, the tracer's span-timing summary, the last
checkpoint epoch. Nothing is written in the happy path; the ring just
wraps. On the exceptional paths — the resilience ``Watchdog`` stall
handler, the SIGTERM/preemption exit, the nonfinite-streak breaker —
:meth:`dump` converts the surviving records (best-effort, per-field
guarded: a wedged device buffer can't take the postmortem down with it)
and atomically writes ``flight.json`` (schema ``dgc-flight`` v1, the reference's), so
every stall or kill leaves a parseable record of the steps leading up
to it (docs/TELEMETRY.md §Flight recorder).
"""

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FLIGHT_SCHEMA", "FLIGHT_VERSION", "FlightRecorder",
           "NonfiniteStreak", "load_dump"]

FLIGHT_SCHEMA = "dgc-flight"
FLIGHT_VERSION = 1


def _to_jsonable(v: Any) -> Any:
    """Best-effort host conversion at DUMP time. np.asarray blocks until
    the device buffer is computed — acceptable here (the run is already
    dying) and each field is guarded by the caller."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    import numpy as np
    if hasattr(v, "detach"):            # a torch tensor, on any device
        v = v.detach().float().cpu().numpy()
    a = np.asarray(v)
    if a.ndim == 0:
        f = float(a)
        return f if math.isfinite(f) else repr(f)
    return [_to_jsonable(float(x)) for x in a.reshape(-1)[:64]]


class FlightRecorder:
    """Fixed-capacity ring buffer of per-step records.

    ``capacity`` — steps retained (oldest evicted); ``static`` — run
    geometry stamped into every dump header. Thread-safe: the train loop
    records while the watchdog thread or a signal handler dumps."""

    def __init__(self, capacity: int = 256,
                 static: Optional[Dict] = None):
        self.capacity = max(int(capacity), 1)
        self._static = dict(static or {})
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        self._dumps = 0

    def record(self, step: int, **fields) -> None:
        """Append one step record. Values are stored RAW (device arrays
        stay device arrays) — zero host syncs on the happy path."""
        with self._lock:
            self._ring.append({"step": int(step), "t_host": time.time(),
                               **fields})
            self._recorded += 1

    def records(self) -> List[Dict]:
        """Snapshot of the ring, oldest first (values still raw)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, path: str, reason: str = "",
             extra: Optional[Dict] = None) -> Optional[str]:
        """Convert + atomically write the ring to ``path``. Never raises
        (the callers are a watchdog thread, a signal-exit path, and an
        abort — a failed dump must not mask the original failure);
        returns the path, or None if even opening the file failed."""
        try:
            snap = self.records()
            out_records = []
            for r in snap:
                row = {}
                for k, v in r.items():
                    try:
                        row[k] = _to_jsonable(v)
                    except Exception as e:  # wedged buffer, odd type
                        row[k] = f"<unconvertible: {type(e).__name__}>"
                out_records.append(row)
            obj = {
                "schema": FLIGHT_SCHEMA, "version": FLIGHT_VERSION,
                "reason": str(reason), "t_dump": round(time.time(), 3),
                "capacity": self.capacity, "recorded": self._recorded,
                "static": self._static,
                "extra": _to_jsonable(extra or {}),
                "records": out_records,
            }
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(obj, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            self._dumps += 1
            return path
        except Exception:
            return None


class NonfiniteStreak:
    """Breaker: trips after ``threshold`` CONSECUTIVE nonfinite losses.

    Fed from the loss-log drain (the loop's existing per-epoch sync
    point — no new host syncs). One finite value resets the streak; a
    tripped breaker stays tripped so the caller can dump + abort."""

    def __init__(self, threshold: int = 3):
        self.threshold = max(int(threshold), 1)
        self.streak = 0
        self.tripped = False

    def update(self, value: float) -> bool:
        """Feed one host-side loss; returns True iff tripped."""
        if math.isfinite(float(value)):
            self.streak = 0
        else:
            self.streak += 1
            if self.streak >= self.threshold:
                self.tripped = True
        return self.tripped


def load_dump(path: str) -> Dict:
    """Read + schema-check a flight dump (postmortem tooling, tests)."""
    with open(path) as fh:
        obj = json.load(fh)
    if obj.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(f"{path}: not a {FLIGHT_SCHEMA} file "
                         f"(schema={obj.get('schema')!r})")
    if obj.get("version") != FLIGHT_VERSION:
        raise ValueError(f"{path}: flight version {obj.get('version')} "
                         f"(reader supports {FLIGHT_VERSION})")
    return obj
