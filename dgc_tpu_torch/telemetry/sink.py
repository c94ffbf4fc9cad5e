"""Host-side async telemetry drain + JSONL readers.

Counterpart of ``dgc_tpu/telemetry/sink.py``; the readers, the CLI and
:class:`JsonlAppender` are copies of it. ``TelemetrySink`` owns one
background thread. The train loop hands it the step's stats — a dict of
*device* tensors, typically not yet computed — and returns at once: the
main thread packs them into one flat f32 tensor on the device, starts ONE
non-blocking copy of it into a pinned host buffer and records a
``torch.cuda.Event`` behind the copy. It never calls ``.item()``,
``.cpu()`` or ``.tolist()`` on a stats tensor. The drain thread waits on
that event (``event.synchronize()``, on its own thread), formats the
record from the host buffer and appends one JSON line. So the main thread
adds no host sync: by the time the drain thread waits, the step that
produced the buffer has long been queued, and draining overlaps the
steps after it. The pinned buffers form a small ring: a buffer goes back
to the ring only after its record is written, so no copy overwrites one
that is not drained; when every buffer is in flight (the drain thread
fell behind) the record is dropped and counted, as the reference drops
one on a full queue. On the CPU the stats are copied into the buffer
directly and no event is recorded.

File format (schema-versioned, see :mod:`dgc_tpu_torch.telemetry.registry`):

* line 1 — header: ``{"schema": "dgc-telemetry", "version": 1,
  "metrics": [...], "static": {...}}``
* then one record per line: ``{"step": n, **scalars, per_bucket: [...]}``.
  Free-form event records (``sink.write_record``) carry an ``"event"`` key.

Rotation: when the current file exceeds ``rotate_bytes`` the sink closes it
and opens ``<base>.N.jsonl`` (N = 1, 2, ...), re-writing the header so every
file is self-describing.

CLI summary / CSV view::

    python -m dgc_tpu_torch.telemetry.sink runs/telemetry.jsonl [--csv out.csv]
"""

import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dgc_tpu_torch.telemetry import registry

__all__ = ["TelemetrySink", "JsonlAppender", "SchemaMismatchError",
           "read_run", "read_run_tolerant", "summarize", "to_csv"]

_CLOSE = object()

#: pinned host buffers in the ring (records in flight at once): a step's
#: record is a few KB, and a drain that falls this many records behind
#: drops the newest rather than stall the train loop
RING = 64


class JsonlAppender:
    """Append-only JSONL event stream, flushed per record.

    The supervisor and control-plane event streams share this writer: a
    tailing reader (the live monitor, the control plane's audit trail)
    must see every event the moment it is written, relaunch churn must
    not reopen the file hundreds of times, and writers on several
    threads (one supervisor thread per run) must not interleave lines.
    The file is opened lazily on the first write and appended to, so a
    relaunched supervisor extends the same stream."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._fh = None
        self._lock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> str:
        line = json.dumps(record)
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
        return line

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SchemaMismatchError(ValueError):
    """A sink file whose schema VERSION this reader doesn't support —
    distinct from "not a sink file at all" (plain ValueError) so callers
    like regress can fall back on the latter but must surface the
    former (silently re-parsing a future-versioned file as bench JSON
    would compare garbage)."""


def _jsonable(v: Any) -> Any:
    """A host value (numpy array or number) as the reference writes it:
    a whole-valued scalar as an int, another scalar as a float, an array
    as a list of floats."""
    a = np.asarray(v)
    if a.ndim == 0:
        f = float(a)
        return int(f) if float(f).is_integer() and abs(f) < 2**53 else f
    return [float(x) for x in a.reshape(-1)]


class _Packed:
    """One step's tensors, flattened into a host buffer of the ring:
    ``names`` and ``shapes`` in packing order, ``n`` floats in ``buf``,
    ``ready`` the event behind the copy (None on the CPU), ``slot`` the
    buffer's place in the ring."""

    __slots__ = ("names", "shapes", "n", "buf", "ready", "slot")

    def __init__(self, names, shapes, n, buf, ready, slot):
        self.names, self.shapes, self.n = names, shapes, n
        self.buf, self.ready, self.slot = buf, ready, slot

    def unpack(self) -> Dict[str, np.ndarray]:
        """Wait for the copy (drain thread only) and split the buffer."""
        if self.ready is not None:
            self.ready.synchronize()
        flat = self.buf[:self.n].numpy().copy()
        out, off = {}, 0
        for name, shape in zip(self.names, self.shapes):
            size = int(np.prod(shape, dtype=np.int64))
            out[name] = flat[off:off + size].reshape(shape)
            off += size
        return out


class TelemetrySink:
    """Async JSONL sink for per-step telemetry stats.

    ``path`` — a ``.jsonl`` file path, or a directory (the sink then writes
    ``<path>/telemetry.jsonl``). ``static`` goes into the header verbatim
    (engine geometry, run config). ``enabled=False`` turns every method into
    a no-op — the processes that write no file. :data:`RING` pinned host
    buffers are in flight at once.
    """

    def __init__(self, path: str, static: Optional[Dict] = None,
                 rotate_bytes: int = 64 << 20, enabled: bool = True,
                 guards: bool = False, fleet: bool = False):
        self.enabled = bool(enabled)
        self._static = dict(static or {})
        self._guards = bool(guards)
        self._fleet = bool(fleet)
        self._rotate_bytes = int(rotate_bytes)
        self._rotations = 0
        # dropped-record counter is bumped from both the caller thread
        # (_put on queue-full, no free buffer) and the drain thread (bad
        # record) — a bare += loses updates between them
        self._drop_lock = threading.Lock()
        self._dropped = 0
        self._fh = None
        if not self.enabled:
            return
        if path.endswith(".jsonl"):
            base = path
        else:
            base = os.path.join(path, "telemetry.jsonl")
        os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
        self._base = base
        self._open_file(base)
        # the ring: a buffer and its event a slot, the free slots queued
        self._bufs: List[Optional[torch.Tensor]] = [None] * RING
        self._events: List[Optional[object]] = [None] * RING
        self._free: "queue.Queue" = queue.Queue()
        for s in range(RING):
            self._free.put(s)
        self._q: "queue.Queue" = queue.Queue(maxsize=4096)
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="dgc-telemetry-sink")
        self._thread.start()

    # ------------------------------------------------------------------ #

    @property
    def path(self) -> Optional[str]:
        return getattr(self, "_base", None) if self.enabled else None

    @property
    def dropped(self) -> int:
        with self._drop_lock:
            return self._dropped

    def write(self, step: int, stats: Dict[str, Any]) -> None:
        """Enqueue one step's stats (device tensors: one packed copy into
        a pinned buffer, no wait; host numbers as they are). Never blocks
        the caller: without a free buffer or room in the queue the record
        is dropped and counted rather than stalling the train loop."""
        if not self.enabled:
            return
        item: Dict[str, Any] = {"step": int(step)}
        tens = {k: v for k, v in stats.items() if torch.is_tensor(v)}
        item.update({k: v for k, v in stats.items() if k not in tens})
        if tens:
            packed = self._pack(tens)
            if packed is None:
                self._count_drop()
                return
            item["_stats"] = packed
        self._put(item)

    def write_record(self, record: Dict[str, Any]) -> None:
        """Enqueue a free-form event record (engine rebuilds, run summary
        rows for the regression gate, ...) of host values."""
        if not self.enabled:
            return
        self._put(dict(record))

    def flush(self) -> None:
        if not self.enabled or self._fh is None:
            return
        self._q.join()
        self._fh.flush()

    def close(self) -> None:
        if not self.enabled or self._fh is None:
            return
        self._q.put(_CLOSE)
        self._thread.join(timeout=60)
        with self._drop_lock:
            dropped = self._dropped
        if dropped:
            self._fh.write(json.dumps(
                {"event": "sink_dropped", "count": dropped}) + "\n")
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #

    def _count_drop(self) -> None:
        with self._drop_lock:
            self._dropped += 1

    def _pack(self, tens: Dict[str, torch.Tensor]) -> Optional[_Packed]:
        """One flat f32 tensor of every stat on their device, copied
        without a wait into a free buffer of the ring; None when every
        buffer is in flight."""
        try:
            slot = self._free.get_nowait()
        except queue.Empty:
            return None
        names = list(tens)
        dev = next(iter(tens.values())).device
        flat = torch.cat([tens[k].detach().reshape(-1).to(dev, torch.float32)
                          for k in names])
        n = flat.numel()
        cuda = dev.type == "cuda"
        buf = self._bufs[slot]
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 64), dtype=torch.float32,
                              pin_memory=cuda)
            self._bufs[slot] = buf
        ready = None
        if cuda:
            buf[:n].copy_(flat, non_blocking=True)
            ready = self._events[slot]
            if ready is None:
                ready = self._events[slot] = torch.cuda.Event()
            ready.record()
        else:
            buf[:n].copy_(flat)
        return _Packed(names, [tuple(tens[k].shape) for k in names], n, buf,
                       ready, slot)

    def _put(self, item: Dict) -> None:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            packed = item.get("_stats")
            if packed is not None:
                self._free.put(packed.slot)
            self._count_drop()

    def _open_file(self, path: str) -> None:
        self._fh = open(path, "w")
        self._fh.write(json.dumps(
            registry.make_header(self._static, guards=self._guards,
                                 fleet=self._fleet)) + "\n")
        self._fh.flush()

    def _maybe_rotate(self) -> None:
        if self._fh.tell() < self._rotate_bytes:
            return
        self._fh.close()
        self._rotations += 1
        root, ext = os.path.splitext(self._base)
        self._open_file(f"{root}.{self._rotations}{ext}")

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _CLOSE:
                    return
                packed = item.pop("_stats", None)
                if packed is not None:
                    try:
                        host = packed.unpack()
                    finally:
                        self._free.put(packed.slot)
                    item.update({k: _jsonable(v) for k, v in host.items()})
                item = {k: _jsonable(v) if isinstance(v, (np.ndarray,
                                                          np.generic))
                        else v for k, v in item.items()}
                item.setdefault("t_host", round(time.time(), 3))
                self._maybe_rotate()
                self._fh.write(json.dumps(item) + "\n")
            except Exception:
                self._count_drop()
            finally:
                self._q.task_done()


# ---------------------------------------------------------------------- #
# readers                                                                #
# ---------------------------------------------------------------------- #

def read_run(path: str) -> Tuple[Dict, List[Dict]]:
    """Read one sink file -> (header, records). Raises on an unknown
    schema version rather than misparsing."""
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty telemetry file")
    header, records = lines[0], lines[1:]
    return _check_header(path, header), records


def read_run_tolerant(path: str) -> Tuple[Dict, List[Dict], int]:
    """``read_run`` for files a live writer may still be appending to:
    torn (partially-written) lines are skipped and counted instead of
    raising -> ``(header, records, skipped)``.

    Only the line CONTENT is forgiven — a readable header with the wrong
    schema/version still raises exactly like :func:`read_run` (a torn tail
    is a liveness artifact; a foreign header is a misconfiguration the
    monitor must surface, not average over). A torn HEADER line counts as
    an unreadable file (ValueError), since nothing after it can be
    trusted to be this schema."""
    records: List[Dict] = []
    header = None
    skipped = 0
    with open(path) as fh:
        for ln in fh:
            if not ln.strip():
                continue
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                if header is None:
                    raise ValueError(f"{path}: unreadable telemetry header")
                skipped += 1
                continue
            if header is None:
                header = _check_header(path, obj)
            else:
                records.append(obj)
    if header is None:
        raise ValueError(f"{path}: empty telemetry file")
    return header, records, skipped


def _check_header(path: str, header: Dict) -> Dict:
    if not isinstance(header, dict) or header.get("schema") != registry.SCHEMA:
        # not a sink file — let callers decide (regress handles bench JSON)
        schema = header.get("schema") if isinstance(header, dict) else None
        raise ValueError(f"{path}: not a {registry.SCHEMA} file "
                         f"(schema={schema!r})")
    if header.get("version") != registry.SCHEMA_VERSION:
        raise SchemaMismatchError(
            f"{path}: schema version {header.get('version')} "
            f"(reader supports {registry.SCHEMA_VERSION})")
    return header


def summarize(records: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-metric summary over step/event records: median, mean, min, max,
    last, n. Per-bucket lists summarize their sum (the whole-model view);
    non-numeric fields are skipped."""
    cols: Dict[str, List[float]] = {}
    for r in records:
        for k, v in r.items():
            if k in ("step", "t_host", "event"):
                continue
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                cols.setdefault(k, []).append(float(v))
            elif (isinstance(v, list) and v
                  and all(isinstance(x, (int, float)) for x in v)):
                cols.setdefault(k, []).append(float(np.sum(v)))
    return {
        k: {"median": float(np.median(v)), "mean": float(np.mean(v)),
            "min": float(np.min(v)), "max": float(np.max(v)),
            "last": v[-1], "n": len(v)}
        for k, v in cols.items()
    }


def to_csv(path: str, out: str) -> None:
    """Flatten a sink file to CSV (per-bucket columns suffixed _0.._n)."""
    _, records = read_run(path)
    rows = []
    for r in records:
        if "event" in r:
            continue
        flat: Dict[str, float] = {}
        for k, v in r.items():
            if isinstance(v, list):
                for i, x in enumerate(v):
                    flat[f"{k}_{i}"] = x
            else:
                flat[k] = v
        rows.append(flat)
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(out, "w") as fh:
        fh.write(",".join(keys) + "\n")
        for r in rows:
            fh.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m dgc_tpu_torch.telemetry.sink",
        description="summarize a telemetry JSONL run")
    ap.add_argument("run", help="telemetry .jsonl file")
    ap.add_argument("--csv", help="also write a flattened CSV view")
    args = ap.parse_args(argv)
    header, records = read_run(args.run)
    print(f"# {args.run}: schema {header['schema']}/v{header['version']}, "
          f"{len(records)} records")
    for k, s in sorted(summarize(records).items()):
        print(f"{k:>16}: median={s['median']:.6g} mean={s['mean']:.6g} "
              f"min={s['min']:.6g} max={s['max']:.6g} n={s['n']}")
    if args.csv:
        to_csv(args.run, args.csv)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
