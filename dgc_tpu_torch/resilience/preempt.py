"""Preemption handling, the watchdog and the clean shutdown (host code).

Counterpart of ``dgc_tpu/resilience/preempt.py``:

* :class:`PreemptionHandler` installs SIGTERM / SIGINT handlers that only
  set a flag; the training loop polls it at step boundaries and saves
  itself.
* :class:`Watchdog` is a daemon thread fed one ``beat()`` a step; after
  ``timeout`` seconds without one it prints every thread's stack and
  dumps the flight recorder's ring (diagnostics only: it never kills the
  run). The reference also flushes its telemetry sink (ROADMAP.md queue 1
  item 9) and refreshes a heartbeat file for its supervisor (item 11).
* :func:`agree_preempt` turns the local flag into an all-process verdict
  (a one-element all-reduce over the ``torch.distributed`` group), so
  every process enters the emergency save at the same step boundary; one
  process short-circuits.
* :func:`emergency_save` is the preemption save with the ``_topology``
  record always stamped, so an elastic restart can reshard it.
"""

import faulthandler
import signal
import sys
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["PreemptionHandler", "Watchdog", "agree_preempt",
           "clean_shutdown", "emergency_save", "EXIT_PREEMPTED",
           "EXIT_NONFINITE"]

#: EX_TEMPFAIL: preempted with the emergency checkpoint on disk; relaunch
EXIT_PREEMPTED = 75
#: EX_SOFTWARE: a non-finite streak the guards cannot skip; do not relaunch
EXIT_NONFINITE = 70


class PreemptionHandler:
    """SIGTERM/SIGINT -> ``requested``; ``uninstall()`` (or leaving the
    ``with`` block) restores the previous handlers. Build it on the main
    thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self.signum: Optional[int] = None
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._on_signal)

    def _on_signal(self, signum, frame):
        self.requested = True
        self.signum = signum

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False


class Watchdog:
    """A daemon thread that dumps the stacks (and the flight ring to
    ``flight_path``) once a step stalls past ``timeout`` seconds, then
    rearms. ``beat()`` once a step."""

    def __init__(self, timeout: float,
                 on_stall: Optional[Callable[[], None]] = None,
                 interval: Optional[float] = None, stream=None,
                 flight=None, flight_path: Optional[str] = None):
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self.stalls = 0
        self._on_stall = on_stall
        self._stream = stream
        self._flight = flight
        self._flight_path = flight_path
        self._interval = interval if interval is not None else max(
            0.1, timeout / 4.0)
        # _last and stalls are shared by beat() and the watchdog thread
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="dgc-watchdog", daemon=True)
        self._thread.start()

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def _run(self):
        while not self._stop.wait(self._interval):
            with self._lock:
                idle = time.monotonic() - self._last
            if idle <= self.timeout:
                continue
            with self._lock:
                self.stalls += 1
            stream = self._stream or sys.stderr
            try:
                print(f"[watchdog] no step progress for >{self.timeout}s "
                      "— thread stacks follow", file=stream, flush=True)
                faulthandler.dump_traceback(file=stream, all_threads=True)
            except Exception:
                pass
            if self._flight is not None and self._flight_path:
                try:
                    p = self._flight.dump(
                        self._flight_path,
                        reason=f"watchdog stall >{self.timeout}s")
                    if p:
                        print(f"[watchdog] flight recorder dumped to {p}",
                              file=stream, flush=True)
                except Exception:
                    pass
            if self._on_stall is not None:
                try:
                    self._on_stall()
                except Exception:
                    pass
            with self._lock:
                self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def agree_preempt(local_flag: bool, device=None) -> bool:
    """The all-process OR of a local preemption flag: call it at a step
    boundary on every process of the group. Without a group (or with one
    process) it returns the flag and communicates nothing. ``device`` —
    where the one-element tensor lives (the card under NCCL)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(local_flag)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1.0 if local_flag else 0.0], device=device)
    dist.all_reduce(flag)
    return bool(flag.item() > 0)


def emergency_save(save, topology: dict) -> str:
    """The preemption save: ``save(topology=...)`` (e.g. a bound
    ``Trainer.save_checkpoint``) with the ``_topology`` record always
    stamped. Returns what ``save`` returns (the epoch's directory)."""
    if not topology:
        raise ValueError("an emergency checkpoint needs its topology record")
    return save(topology=dict(topology))


def clean_shutdown() -> None:
    """Best-effort teardown of the process group."""
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception as e:
        print(f"[preempt] distributed shutdown skipped: {e}",
              file=sys.stderr)
