"""Crash-consistency model checker over the host file protocols.

Counterpart of ``dgc_tpu/analysis/mc.py``, driving this package's
writers. Layer 4 of the analysis stack (``python -m
dgc_tpu_torch.analysis --mc``; the specs live in
:mod:`dgc_tpu_torch.analysis.protospec`). In the spirit of
FiSC/eXplode-style exhaustive small-scope exploration, the checker
drives the REAL protocol functions — ``protocol.write_json_atomic``,
``CheckpointManager.save``/restore-fallback, ``surgery.publish_order``/
``read_order``, ``actions.publish_env``, ``Autotuner.write_fabric``,
``Exporter.publish``/``Replica.poll``, ``DevicePool`` transitions —
against a syscall-instrumented filesystem and asserts every protocol
invariant in every reachable state:

* **crash points** — the writer is killed (a :class:`Crash`, which is a
  ``BaseException`` so no ``except Exception`` recovery path in the code
  under test can swallow it) immediately before every instrumented
  syscall (create/write/fsync/replace/unlink); the post-crash tree then
  models power loss: bytes written but never fsynced are truncated away
  (half of the unsynced suffix survives, so mid-record tears are
  exercised too), after which a FRESH reader must still satisfy the
  invariants and a retried writer must converge.
* **reader interleaving** — in the uncrashed trace, the protocol's
  readers run between every pair of writer syscalls, so any
  non-atomic intermediate state (a half-written in-place file, a
  missing-then-present pointer) is observed.
* **write-once ledger** — every ``os.replace`` onto a path matching the
  scenario's write-once patterns is checked against the first published
  content for that name.

Seeded mutations (``DGC_MC_MUTATE`` / ``run_mc_suite(mutate=...)``)
re-introduce the classic bugs and must turn the checker red naming the
protocol and step — the checker's own red test, mirroring the verifier's
``DGC_VERIFY_MUTATE``:

* ``drop_replace``   — the publish rename never happens,
* ``drop_fsync``     — data is replaced into place before it is durable
  (the "reorder write-before-fsync" bug),
* ``write_once_rewrite`` — a write-once artifact is republished with
  different bytes,
* ``torn_tail``      — the append-tail protocol is read with the STRICT
  reader, i.e. torn tails are "accepted" as fatal instead of skipped.

Scope and honesty: the sandbox instruments Python-level syscalls issued
by the driving thread under the scenario root only. ``torch.save``
writes through its own C++ writer, which the instrumented ``open`` never
sees, so the checkpoint scenario explores the coarse op trace (its
staging directory, ``meters.json``, the publish rename and the
``latest.json`` pointer), not the tensor files' bytes. Crash-point caps
are logged, never silent.
"""

import builtins
import contextlib
import fnmatch
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Crash", "Sandbox", "Scenario", "explore", "scenarios",
           "run_mc_suite", "MUTATIONS"]

MUTATIONS = ("drop_replace", "drop_fsync", "write_once_rewrite",
             "torn_tail")

#: per-scenario crash-point cap; above it, points are evenly sampled and
#: the cap is logged (never silently)
MAX_CRASH_POINTS = 64


class Crash(BaseException):
    """Simulated process death at a syscall boundary. A BaseException on
    purpose: the code under test may catch ``Exception`` for legitimate
    recovery (checkpoint restore fallback), and a kill must not be
    recoverable from inside the dying process."""


class _TrackedFile:
    """Write-mode file wrapper: counts write ops and models mid-write
    tears (a crash AT a write op leaves half of that write on disk)."""

    def __init__(self, sandbox, real, path):
        self._sb = sandbox
        self._real = real
        self._path = path

    def write(self, data):
        crashing = self._sb.op("write", self._path)
        if crashing:
            half = data[:max(1, len(data) // 2)] if data else data
            self._real.write(half)
            self._real.flush()
            raise Crash(f"mid-write tear in {self._path}")
        return self._real.write(data)

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._real.close()
        return False


class Sandbox:
    """Syscall instrumentation confined to (paths under ``root``) AND
    (the thread that activated the sandbox). Everything else — other
    threads, other paths — passes through to the real OS untouched.

    ``track_writes=False`` keeps the op trace coarse (create/fsync/
    replace/unlink only, no per-write tear model) for scenarios whose
    writer's bytes go through a library's own writer (``torch.save``).
    """

    def __init__(self, root: str, crash_at: Optional[int] = None,
                 mutate: Optional[str] = None, track_writes: bool = True,
                 write_once: Tuple[str, ...] = (),
                 on_op: Optional[Callable[[int, str, str], None]] = None):
        self.root = os.path.abspath(root)
        self.crash_at = crash_at
        self.mutate = mutate
        self.track_writes = track_writes
        self.write_once = tuple(write_once)
        self.on_op = on_op
        self.count = 0
        self.ops: List[Tuple[str, str]] = []     # (kind, relpath) trace
        self.notes: List[str] = []               # mutation effects, caps
        self.violations: List[str] = []          # write-once breaches
        self._synced: Dict[str, int] = {}        # path -> durable bytes
        self._once: Dict[str, bytes] = {}        # write-once ledger
        self._fd_paths: Dict[int, str] = {}
        self._thread: Optional[threading.Thread] = None
        self._in_check = False
        self._saved: Dict[str, object] = {}

    # -- op accounting ----------------------------------------------- #

    def _rel(self, path: str) -> str:
        return os.path.relpath(os.path.abspath(path), self.root)

    def _mine(self, path) -> bool:
        if self._in_check or self._thread is not threading.current_thread():
            return False
        try:
            p = os.path.abspath(os.fspath(path))
        except TypeError:
            return False
        return p == self.root or p.startswith(self.root + os.sep)

    def op(self, kind: str, path: str) -> bool:
        """Count one syscall; True when the crash fires AT this op (the
        caller performs the torn half-effect, then raises), raising
        directly for ops with no partial effect."""
        k = self.count
        self.count += 1
        rel = self._rel(path)
        self.ops.append((kind, rel))
        if self.crash_at is not None and k == self.crash_at:
            if kind == "write":
                return True
            raise Crash(f"crash before op {k}: {kind} {rel}")
        if self.on_op is not None:
            self._in_check = True
            try:
                self.on_op(k, kind, rel)
            finally:
                self._in_check = False
        return False

    # -- instrumented syscalls ---------------------------------------- #

    def _open(self, file, mode="r", *a, **kw):
        real_open = self._saved["open"]
        if not (isinstance(mode, str) and set(mode) & set("wxa")
                and self._mine(file)):
            return real_open(file, mode, *a, **kw)
        self.op("create" if set(mode) & set("wx") else "append", file)
        p = os.path.abspath(os.fspath(file))
        if set(mode) & set("wx"):
            self._synced[p] = 0
        else:
            self._synced.setdefault(
                p, os.path.getsize(p) if os.path.exists(p) else 0)
        f = real_open(file, mode, *a, **kw)
        return _TrackedFile(self, f, p) if self.track_writes else f

    def _mkstemp(self, *a, **kw):
        d = kw.get("dir") or (a[2] if len(a) > 2 else None)
        fd, path = self._saved["mkstemp"](*a, **kw)
        if d is not None and self._mine(os.path.join(d, "x")):
            self.op("create", path)
            self._synced[os.path.abspath(path)] = 0
            self._fd_paths[fd] = os.path.abspath(path)
        return fd, path

    def _fdopen(self, fd, *a, **kw):
        f = self._saved["fdopen"](fd, *a, **kw)
        path = self._fd_paths.get(fd)
        if path is not None and self.track_writes:
            return _TrackedFile(self, f, path)
        return f

    def _fsync(self, fd):
        path = self._fd_paths.get(fd)
        if path is None or not self._mine(path):
            return self._saved["fsync"](fd)
        self.op("fsync", path)
        if self.mutate == "drop_fsync":
            self.notes.append(f"fsync of {self._rel(path)} dropped "
                              "(mutation drop_fsync)")
            return None
        self._saved["fsync"](fd)
        self._synced[path] = os.fstat(fd).st_size
        return None

    def _replace(self, src, dst, **kw):
        if not self._mine(dst):
            return self._saved["replace"](src, dst, **kw)
        k = self.count
        self.op("replace", dst)
        if self.mutate == "drop_replace":
            self.notes.append(f"step {k}: os.replace -> "
                              f"{self._rel(dst)} dropped "
                              "(mutation drop_replace)")
            return None
        self._check_write_once(src, dst, k)
        self._saved["replace"](src, dst)
        s = os.path.abspath(os.fspath(src))
        d = os.path.abspath(os.fspath(dst))
        # durability travels with the bytes: a replace of unsynced data
        # publishes a file whose content is still at risk
        self._synced[d] = self._synced.pop(
            s, os.path.getsize(d) if os.path.exists(d) else 0)
        return None

    def _rename(self, src, dst, **kw):
        if not self._mine(dst):
            return self._saved["rename"](src, dst, **kw)
        return self._replace(src, dst, **kw)

    def _unlink(self, path, **kw):
        if not self._mine(path):
            return self._saved["unlink"](path, **kw)
        self.op("unlink", path)
        self._saved["unlink"](path, **kw)
        self._synced.pop(os.path.abspath(os.fspath(path)), None)
        return None

    def _check_write_once(self, src, dst, step: int) -> None:
        name = os.path.basename(os.fspath(dst))
        if not any(fnmatch.fnmatch(name, pat) for pat in self.write_once):
            return
        with self._saved["open"](src, "rb") as f:
            content = f.read()
        first = self._once.setdefault(name, content)
        if first != content:
            self.violations.append(
                f"step {step}: write-once artifact {name} republished "
                f"with different content ({len(first)} -> "
                f"{len(content)} bytes)")

    # -- activation ---------------------------------------------------- #

    def __enter__(self):
        self._thread = threading.current_thread()
        self._saved = {"open": builtins.open, "mkstemp": tempfile.mkstemp,
                       "fdopen": os.fdopen, "fsync": os.fsync,
                       "replace": os.replace, "rename": os.rename,
                       "unlink": os.unlink}
        builtins.open = self._open
        tempfile.mkstemp = self._mkstemp
        os.fdopen = self._fdopen
        os.fsync = self._fsync
        os.replace = self._replace
        os.rename = self._rename
        os.unlink = self._unlink
        return self

    def __exit__(self, *exc):
        builtins.open = self._saved["open"]
        tempfile.mkstemp = self._saved["mkstemp"]
        os.fdopen = self._saved["fdopen"]
        os.fsync = self._saved["fsync"]
        os.replace = self._saved["replace"]
        os.rename = self._saved["rename"]
        os.unlink = self._saved["unlink"]
        self._thread = None
        return False

    def apply_crash_effects(self) -> List[str]:
        """Power-loss model, applied AFTER the crash: every file whose
        bytes were never fsynced keeps only half of the unsynced suffix
        (so published-but-not-durable data tears, append tails tear
        mid-record, and fully fsynced files survive intact)."""
        torn = []
        if not self.track_writes:
            return torn
        for path, synced in sorted(self._synced.items()):
            if not os.path.exists(path) or os.path.isdir(path):
                continue
            size = os.path.getsize(path)
            if size <= synced:
                continue
            keep = synced + (size - synced + 1) // 2
            with open(path, "rb+") as f:
                f.truncate(keep)
            torn.append(f"{self._rel(path)}: {size} -> {keep} bytes "
                        f"({synced} durable)")
        return torn


# --------------------------------------------------------------------- #
# scenarios: one per ProtocolSpec                                        #
# --------------------------------------------------------------------- #

class Scenario:
    """One protocol bound to executable setup/writer/checks.

    ``setup`` runs per replay OUTSIDE the sandbox (pristine prior
    state); ``writer`` runs INSIDE it (crash points explored);
    ``check_live`` runs between every writer syscall of the uncrashed
    trace; ``check_crash`` runs on each post-crash (torn) tree with
    fresh readers; ``retry`` re-runs the writer uncrashed (the
    crashed-writer-then-second-writer interleaving) and ``check_final``
    asserts convergence. Every check returns violation strings."""

    name = "abstract"
    track_writes = True
    write_once: Tuple[str, ...] = ()
    max_points = MAX_CRASH_POINTS

    def setup(self, root: str) -> None:
        raise NotImplementedError

    def writer(self, root: str) -> None:
        raise NotImplementedError

    def sabotage(self, root: str) -> None:
        """Extra writer step for the write_once_rewrite mutation; only
        protocols with write-once files implement it."""

    def check_live(self, root: str) -> List[str]:
        return self.check_crash(root)

    def check_crash(self, root: str) -> List[str]:
        raise NotImplementedError

    def retry(self, root: str) -> None:
        pass

    def check_final(self, root: str) -> List[str]:
        raise NotImplementedError

    def pre_explore(self) -> List[str]:
        """Sandbox-free model checks (in-memory state machines)."""
        return []


class ServingScenario(Scenario):
    """serving-manifest: Exporter.publish vs read_manifest/Replica.poll.

    The base_v*.npz family is rename-atomic but NOT write-once by
    contract: a restarted exporter rewrites base_v1 with fresh live
    params by design and the manifest digest trail heals the divergence,
    so the write-once ledger pins the delta family only."""

    name = "serving-manifest"
    write_once = ("delta_v*.npz",)

    def setup(self, root: str) -> None:
        import numpy as np
        from dgc_tpu_torch.serving.exporter import Exporter
        params0 = {"w": np.linspace(0.0, 1.0, 16, dtype=np.float32)}
        self._params1 = {"w": params0["w"] + np.float32(0.5)}
        self._exporter = Exporter(root, params0, ratio=0.5,
                                  lineage={"epoch": 0}, device="cpu")

    def writer(self, root: str) -> None:
        self._exporter.publish(self._params1, step=1)

    def sabotage(self, root: str) -> None:
        import numpy as np
        from dgc_tpu_torch.serving import protocol
        protocol.save_npz_atomic(protocol.delta_path(root, 1, 1),
                                 {"values": np.zeros(3, np.float32)})

    def _common(self, root: str) -> List[str]:
        from dgc_tpu_torch.serving import protocol
        from dgc_tpu_torch.serving.replica import Replica
        out = []
        man = protocol.read_manifest(root)
        if man is None:
            # setup always publishes a complete head before the writer
            # runs, so an unreadable manifest means the head was LOST
            out.append("MANIFEST-COMPLETE: manifest unreadable although "
                       "a complete head existed before the publish")
            return out
        for key in ("spec", "base_version", "latest_seq", "digests"):
            if key not in man:
                out.append(f"MANIFEST-COMPLETE: manifest missing {key!r}")
        head = (man.get("base_version"), man.get("latest_seq"))
        if head not in ((1, 0), (1, 1)):
            out.append(f"HEAD-MONOTONIC: observed head {head}, legal "
                       "heads are (1,0) and (1,1)")
        try:
            # fresh reader every time — the restarted-replica view
            rep = Replica(root, name="mc", auto_resync=False,
                          device="cpu")
            rep.poll()
        except Exception as e:   # noqa: BLE001 - the invariant is "never raises"
            out.append(f"REPLICA-TOTAL: Replica.poll raised {e!r}")
        return out

    def check_crash(self, root: str) -> List[str]:
        return self._common(root)

    def retry(self, root: str) -> None:
        from dgc_tpu_torch.serving.exporter import Exporter
        # the restarted trainer re-creates its exporter over the LIVE
        # params; __init__ takes the rebase path (fresh base_v*, fresh
        # digest trail) and the stream heals past any torn delta
        self._exporter = Exporter(root, self._params1, ratio=0.5,
                                  lineage={"epoch": 0,
                                           "reason": "mc-restart"},
                                  device="cpu")

    def check_final(self, root: str) -> List[str]:
        import numpy as np
        from dgc_tpu_torch.serving import protocol
        from dgc_tpu_torch.serving.replica import Replica
        out = self._common(root)
        head = (self._exporter.base_version, self._exporter.delta_seq)
        man = protocol.read_manifest(root)
        if man and (man.get("base_version"),
                    man.get("latest_seq")) != head:
            out.append("HEAD-MONOTONIC: completed publish lost — head is "
                       f"({man.get('base_version')}, "
                       f"{man.get('latest_seq')}), expected {head}")
        rep = Replica(root, name="mc-final", auto_resync=False,
                      device="cpu")
        try:
            rep.poll()
        except Exception as e:   # noqa: BLE001 - the invariant is "never raises"
            out.append(f"REPLICA-TOTAL: Replica.poll raised {e!r} on "
                       "the final state")
            return out
        if rep.flat is None or not np.allclose(
                rep.flat.numpy(), self._exporter.published.numpy()):
            out.append("REPLICA-TOTAL: replica did not converge to the "
                       "exporter's published state after a completed "
                       "publish")
        return out


class CheckpointScenario(Scenario):
    """checkpoint-epoch: CheckpointManager.save / restore fallback.

    Coarse op trace (``track_writes=False``): ``torch.save`` writes the
    tensor files through its own C++ writer, which the sandbox's
    instrumented ``open`` never sees; the crash points of interest are
    the manager's staging, ``meters.json``, publish-rename and
    ``latest.json`` syscalls."""

    name = "checkpoint-epoch"
    track_writes = False
    max_points = 10

    def __init__(self):
        self._stash = None

    def _mgr(self, root):
        from dgc_tpu_torch.training.checkpoint import CheckpointManager
        return CheckpointManager(root)

    def _state(self, epoch: int):
        import torch
        return ({"w": torch.arange(4, dtype=torch.float32) + epoch},
                {0: {"m": torch.full((3,), float(epoch))}})

    def _save(self, root, epoch: int, loss: float) -> None:
        rep, workers = self._state(epoch)
        self._mgr(root).save(epoch, rep, workers, {"loss": loss})

    def setup(self, root: str) -> None:
        # save e0 once, stash the tree, and copy it back for every replay
        if self._stash is None or not os.path.isdir(self._stash):
            self._stash = tempfile.mkdtemp(prefix="dgcmc-ckpt-stash-")
            self._save(os.path.join(self._stash, "ckpt"), 0, 1.0)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(self._stash, "ckpt"), root)

    def writer(self, root: str) -> None:
        self._save(root, 1, 0.5)

    def check_crash(self, root: str) -> List[str]:
        import contextlib
        import io

        import torch
        out = []
        mgr = self._mgr(root)                     # reader restart
        le = mgr.latest_epoch()
        if le not in (None, 0, 1):
            out.append(f"LATEST-TOLERATED: latest_epoch() == {le!r}")
        rep0, workers0 = self._state(0)
        try:
            # restore() logs each torn epoch it falls back from
            with contextlib.redirect_stdout(io.StringIO()):
                res = mgr.restore(rep0, workers0)
        except Exception as e:   # noqa: BLE001 - the invariant is "never raises"
            return out + [f"RESTORE-FALLBACK: restore raised {e!r}"]
        if res is None:
            out.append("RESTORE-FALLBACK: restore found nothing although "
                       "epoch 0 was completely saved before the crash")
            return out
        rep, workers, ep, _meters = res
        if ep not in (0, 1):
            out.append(f"RESTORE-FALLBACK: restored epoch {ep}")
            return out
        want_rep, want_workers = self._state(ep)
        got = {("rep", k): v for k, v in rep.items()}
        got.update({(r, k): v for r, d in workers.items()
                    for k, v in d.items()})
        want = {("rep", k): v for k, v in want_rep.items()}
        want.update({(r, k): v for r, d in want_workers.items()
                     for k, v in d.items()})
        for k, v in want.items():
            if k not in got or not torch.equal(got[k], v):
                out.append(f"CKPT-COMPLETE-OR-ABSENT: restored e{ep} "
                           f"leaf {k!r} differs from what save() wrote")
        return out

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        out = self.check_crash(root)
        mgr = self._mgr(root)
        if mgr.latest_epoch() != 1:
            out.append("RESTORE-FALLBACK: completed save(1) but "
                       f"latest_epoch() == {mgr.latest_epoch()!r}")
        return out


class SurgeryScenario(Scenario):
    """surgery-order: publish_order / write_exit_record vs the tolerant
    readers, plus the double-shrink invariant on every complete record."""

    name = "surgery-order"

    def setup(self, root: str) -> None:
        os.makedirs(root, exist_ok=True)

    def writer(self, root: str) -> None:
        from dgc_tpu_torch.resilience import surgery
        surgery.publish_order(os.path.join(root, surgery.ORDER_FILE),
                              "straggler", 1, step=7)
        agreement = surgery.Agreement(excise=True, target=1,
                                      verdict="straggler")
        surgery.write_exit_record(
            os.path.join(root, surgery.EXIT_RECORD), agreement,
            world=3, process_index=0, step=7)

    def check_crash(self, root: str) -> List[str]:
        from dgc_tpu_torch.resilience import surgery
        out = []
        try:
            order = surgery.read_order(
                os.path.join(root, surgery.ORDER_FILE))
        except Exception as e:   # noqa: BLE001
            return [f"ORDER-COMPLETE: read_order raised {e!r}"]
        if order is not None and (order.get("verdict") != "straggler"
                                  or order.get("target") != 1):
            out.append(f"ORDER-COMPLETE: partial order observed: {order}")
        try:
            rec = surgery.read_exit_record(
                os.path.join(root, surgery.EXIT_RECORD))
        except Exception as e:   # noqa: BLE001
            return out + [f"EXIT-COMPLETE: read_exit_record raised {e!r}"]
        if rec is not None:
            if rec.get("world") != 3 or rec.get("target") != 1:
                out.append(f"EXIT-COMPLETE: partial record: {rec}")
            else:
                once = surgery.shrink_updates(rec["world"], rec["target"])
                again = surgery.shrink_updates(rec["world"], rec["target"])
                if once != again or once != {"JAX_NUM_PROCESSES": "2"}:
                    out.append("DOUBLE-SHRINK: shrink_updates is not "
                               f"idempotent-by-value: {once} vs {again}")
        return out

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        from dgc_tpu_torch.resilience import surgery
        out = self.check_crash(root)
        if surgery.read_order(
                os.path.join(root, surgery.ORDER_FILE)) is None:
            out.append("ORDER-COMPLETE: completed publish_order left no "
                       "readable order")
        if surgery.read_exit_record(
                os.path.join(root, surgery.EXIT_RECORD)) is None:
            out.append("EXIT-COMPLETE: completed write_exit_record left "
                       "no readable record")
        return out


class EnvFileScenario(Scenario):
    """supervisor-env: actions.publish_env vs parse_env_file. The torn
    state is UNDETECTABLE by the reader (a truncated value still
    parses), so the invariant is exact-dict equality with some
    completed publish."""

    name = "supervisor-env"

    OLD = {"JAX_NUM_PROCESSES": "32", "JAX_COORDINATOR_ADDRESS": "h0:1"}
    NEW = {"JAX_NUM_PROCESSES": "31", "JAX_COORDINATOR_ADDRESS": "h0:1"}
    FINAL = {"JAX_NUM_PROCESSES": "30", "JAX_COORDINATOR_ADDRESS": "h0:1"}

    def _path(self, root):
        return os.path.join(root, "cohort.env")

    def setup(self, root: str) -> None:
        from dgc_tpu_torch.control.actions import publish_env
        os.makedirs(root, exist_ok=True)
        publish_env(self._path(root), self.OLD)
        # the spec check_final expects: the uncrashed pass ends at NEW;
        # retry() (a second publisher) moves the goalpost to FINAL
        self._expect = self.NEW

    def writer(self, root: str) -> None:
        from dgc_tpu_torch.control.actions import publish_env
        publish_env(self._path(root), {"JAX_NUM_PROCESSES": "31"})

    def check_crash(self, root: str) -> List[str]:
        from dgc_tpu_torch.control.supervisor import parse_env_file
        spec = parse_env_file(self._path(root))
        if spec not in (self.OLD, self.NEW):
            return ["SPEC-COMPLETE: supervisor would relaunch under "
                    f"torn/partial cohort spec {spec} (legal: "
                    f"{self.OLD} or {self.NEW})"]
        return []

    def retry(self, root: str) -> None:
        from dgc_tpu_torch.control.actions import publish_env
        # the crashed publisher is followed by a SECOND publisher (a
        # racing survivor supervisor) — convergence must still hold
        publish_env(self._path(root), {"JAX_NUM_PROCESSES": "30"})
        self._expect = self.FINAL

    def check_final(self, root: str) -> List[str]:
        from dgc_tpu_torch.control.supervisor import parse_env_file
        spec = parse_env_file(self._path(root))
        if spec != self._expect:
            return ["MERGE-IDEMPOTENT: after the last completed publish "
                    f"the spec is {spec}, expected {self._expect}"]
        return []


class CohortLedgerScenario(Scenario):
    """cohort-ledger: the plane's cohort.json snapshots on disk plus an
    exhaustive small-scope sweep of the in-memory DevicePool machine
    against a reference model (POOL-ONE-WAY)."""

    name = "cohort-ledger"

    def _paths(self, root):
        return (os.path.join(root, "run_a", "cohort.json"),
                os.path.join(root, "cohort.json"))

    def _payloads(self):
        from dgc_tpu_torch.control.plane import DevicePool
        pool = DevicePool({"run_a": 2, "run_b": 1})
        pool.quarantine("run_b")
        snap = pool.snapshot()
        return dict(snap, t=1.0), dict(snap, t=1.0, runs=dict(pool.state))

    def setup(self, root: str) -> None:
        from dgc_tpu_torch.serving import protocol
        for payload, path in zip(self._payloads(), self._paths(root)):
            protocol.write_json_atomic(path, payload)

    def writer(self, root: str) -> None:
        from dgc_tpu_torch.serving import protocol
        for payload, path in zip(self._payloads(), self._paths(root)):
            protocol.write_json_atomic(path, payload)

    def check_crash(self, root: str) -> List[str]:
        from dgc_tpu_torch.serving import protocol
        out = []
        for path in self._paths(root):
            snap = protocol.read_json(path)
            if snap is None:
                out.append("LEDGER-COMPLETE: cohort.json unreadable "
                           "although a complete snapshot existed "
                           f"({os.path.relpath(path, root)})")
                continue
            missing = [k for k in ("total", "active", "free",
                                   "quarantined") if k not in snap]
            if missing:
                out.append(f"LEDGER-COMPLETE: snapshot missing {missing}")
                continue
            q_slots = 2 * len(snap["quarantined"]) - sum(
                1 for n in snap["quarantined"] if n == "run_b")
            if snap["active"] + snap["free"] + q_slots != snap["total"]:
                out.append("LEDGER-COMPLETE: slot totals inconsistent: "
                           f"{snap}")
        return out

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        return self.check_crash(root)

    def pre_explore(self) -> List[str]:
        from dgc_tpu_torch.control.plane import DevicePool
        out = []
        ops = [("quarantine", "a"), ("quarantine", "b"),
               ("release", "a"), ("release", "b"),
               ("activate", "a"), ("activate", "b")]
        legal = {("active", "quarantine"): "quarantined",
                 ("quarantined", "release"): "freed"}

        def ref_apply(state, op, name):
            nxt = legal.get((state[name], op))
            if op == "activate":
                nxt = "active"
            return dict(state, **{name: nxt}) if nxt else state

        def sweep(pool, ref, depth, trail):
            snap = pool.snapshot()
            q = sum(pool.slots[n] for n, s in pool.state.items()
                    if s == "quarantined")
            if pool.state != ref:
                out.append(f"POOL-ONE-WAY: pool {pool.state} diverged "
                           f"from the reference {ref} after {trail}")
                return
            if snap["active"] + snap["free"] + q != snap["total"]:
                out.append(f"POOL-ONE-WAY: slot totals inconsistent "
                           f"after {trail}: {snap}")
                return
            if depth == 0:
                return
            for op, name in ops:
                import copy
                p2 = copy.deepcopy(pool)
                getattr(p2, op)(name)
                # idempotence: replaying the op must be a no-op
                p3 = copy.deepcopy(p2)
                getattr(p3, op)(name)
                if p3.state != p2.state:
                    out.append(f"POOL-ONE-WAY: {op}({name}) is not "
                               f"idempotent after {trail}")
                    continue
                sweep(p2, ref_apply(ref, op, name), depth - 1,
                      trail + [f"{op}({name})"])

        pool = DevicePool({"a": 2, "b": 1})
        sweep(pool, {"a": "active", "b": "active"}, 4, [])
        return out


class FabricScenario(Scenario):
    """fabric-autotune: Autotuner.write_fabric vs resolve_fabric's
    default chain (training startup must survive any crash state)."""

    name = "fabric-autotune"

    def _fabric_path(self, root):
        return os.path.join(root, "fabric.json")

    def _tuner(self, root, refit):
        from dgc_tpu_torch.compression.autotune import Autotuner
        at = Autotuner(fabric="32x25GbE", world=8, runs_dir=root)
        at.points = [(1.0e6, 2.0 + refit), (2.0e6, 3.5 + refit)]
        at.refit_count = refit
        return at

    def setup(self, root: str) -> None:
        os.makedirs(root, exist_ok=True)
        self._tuner(root, 0).write_fabric(self._fabric_path(root), epoch=0)

    def writer(self, root: str) -> None:
        self._tuner(root, 1).write_fabric(self._fabric_path(root), epoch=1)

    def check_crash(self, root: str) -> List[str]:
        import contextlib
        import io
        from dgc_tpu_torch.compression import planner
        out = []
        try:
            # resolve_fabric logs its source chain; the checker probes it
            # hundreds of times, so swallow the chatter
            with contextlib.redirect_stdout(io.StringIO()):
                fab = planner.resolve_fabric(None, runs_dir=root)
        except Exception as e:   # noqa: BLE001 - startup must not crash
            return ["FABRIC-COMPLETE: resolve_fabric raised "
                    f"{e!r} — training startup would crash on last "
                    "epoch's interrupted autotuner"]
        if fab.workers != 8:
            out.append(f"FIT-PAIRED: fabric workers {fab.workers}, "
                       "expected the written 8-worker fit")
        return out

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        from dgc_tpu_torch.compression import planner
        out = self.check_crash(root)
        obj = None
        try:
            with open(self._fabric_path(root)) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            out.append("FABRIC-COMPLETE: completed write_fabric left no "
                       "readable fabric.json")
        if obj is not None and obj.get("provenance", {}).get("refit") != 1:
            out.append("FIT-PAIRED: completed refit lost — provenance "
                       f"{obj.get('provenance', {}).get('refit')!r}")
        return out


class TelemetryStreamScenario(Scenario):
    """telemetry-stream: JsonlAppender (flushed, unsynced appends) vs
    read_run_tolerant — the append-tail-torn class. Under the
    ``torn_tail`` mutation the STRICT reader substitutes, modeling a
    consumer that "accepts" torn tails as fatal."""

    name = "telemetry-stream"

    def __init__(self, mutate: Optional[str] = None):
        self._mutate = mutate

    def _path(self, root):
        return os.path.join(root, "telemetry.jsonl")

    def _header(self):
        from dgc_tpu_torch.telemetry import registry
        return {"schema": registry.SCHEMA,
                "version": registry.SCHEMA_VERSION, "run": "mc"}

    def setup(self, root: str) -> None:
        from dgc_tpu_torch.telemetry.sink import JsonlAppender
        os.makedirs(root, exist_ok=True)
        app = JsonlAppender(self._path(root))
        app.write(self._header())
        app.close()
        # the header was written outside the sandbox: model it as
        # already durable (a stream that predates this session)

    def writer(self, root: str) -> None:
        from dgc_tpu_torch.telemetry.sink import JsonlAppender
        app = JsonlAppender(self._path(root))
        for i in (1, 2):
            app.write({"kind": "step", "i": i,
                       "pad": "x" * 64})   # wide enough to tear mid-record
        app.close()

    def check_crash(self, root: str) -> List[str]:
        from dgc_tpu_torch.telemetry import sink
        try:
            if self._mutate == "torn_tail":
                header, records = sink.read_run(self._path(root))
            else:
                header, records, _skipped = sink.read_run_tolerant(
                    self._path(root))
        except Exception as e:   # noqa: BLE001
            return ["TAIL-PREFIX: reader raised on a torn tail past a "
                    f"durable header: {e!r}"]
        seen = [r.get("i") for r in records if r.get("kind") == "step"]
        if seen not in ([], [1], [1, 2]):
            return [f"TAIL-PREFIX: records {seen} are not a prefix of "
                    "the written [1, 2]"]
        return []

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        # post-retry contract for the append-tail-torn class: a torn
        # mid-stream line (the crashed append glued onto the restarted
        # appender's first record) is LOST, never resurrected — so the
        # reader must not raise, must not invent ids, and must see the
        # restart's final record (written entirely after the crash)
        from dgc_tpu_torch.telemetry import sink
        try:
            if self._mutate == "torn_tail":
                header, records = sink.read_run(self._path(root))
            else:
                header, records, _skipped = sink.read_run_tolerant(
                    self._path(root))
        except Exception as e:   # noqa: BLE001
            return ["TAIL-PREFIX: reader raised after a restarted "
                    f"appender resumed the stream: {e!r}"]
        seen = [r.get("i") for r in records if r.get("kind") == "step"]
        if (not seen or seen[-1] != 2
                or any(i not in (1, 2) for i in seen)):
            return [f"TAIL-PREFIX: post-restart records {seen} — "
                    "expected only written ids with the restart's "
                    "final record (2) surviving"]
        return []


class SchedulerLedgerScenario(Scenario):
    """scheduler-ledger: GangScheduler's atomic queue snapshot + append-
    only grant ledger vs read_queue / read_grant_ledger. The writer
    drives a real scheduler (fake clock) through admit → grant → shrunk →
    completed, so every crash point lands between a ledger append and
    its queue-snapshot publish; the retry models a restarted scheduler,
    whose ctor must resume the durable seq (SEQ-MONOTONIC across
    incarnations). Under ``torn_tail`` a strict line reader substitutes,
    modeling a consumer that treats a torn ledger tail as fatal."""

    name = "scheduler-ledger"

    def __init__(self, mutate: Optional[str] = None):
        self._mutate = mutate

    def setup(self, root: str) -> None:
        # a prior scheduler session's durable head: one admit, already
        # on disk before the sandboxed writer runs
        from dgc_tpu_torch.control.scheduler import GangScheduler
        os.makedirs(root, exist_ok=True)
        s = GangScheduler(4, root=root, clock=lambda: 100.0)
        s.admit("warm", 1, priority=0, now=100.0)
        s.close()

    def writer(self, root: str) -> None:
        from dgc_tpu_torch.control.scheduler import GangScheduler
        s = GangScheduler(4, root=root, clock=lambda: 101.0)
        s.admit("alpha", 2, priority=0, now=101.0)
        s.admit("beta", 1, priority=1, now=102.0)
        s.tick(now=103.0)               # grants beta, then alpha
        s.shrunk("alpha", by=1, now=104.0)
        s.completed("beta", now=105.0)
        s.close()

    def _read_ledger(self, root: str):
        from dgc_tpu_torch.control import scheduler as sched
        if self._mutate == "torn_tail":
            # strict substitute: json.loads every line, torn tail raises
            records = []
            with open(os.path.join(root, sched.SCHED_GRANTS)) as f:
                for ln in f:
                    if ln.strip():
                        records.append(json.loads(ln))
            return records
        return sched.read_grant_ledger(root)[0]

    def check_crash(self, root: str) -> List[str]:
        from dgc_tpu_torch.control import scheduler as sched
        out: List[str] = []
        try:
            snap = sched.read_queue(root)
        except Exception as e:   # noqa: BLE001 - the invariant is "never raises"
            out.append(f"QUEUE-COMPLETE: read_queue raised {e!r}")
            snap = None
        if snap is None:
            # setup published a complete durable snapshot before the
            # writer ran; an unreadable one means the head was LOST
            # (exactly the drop_fsync hazard: replace of unsynced bytes)
            out.append("QUEUE-COMPLETE: snapshot unreadable although a "
                       "complete one existed before the publish")
        else:
            if (not isinstance(snap.get("total"), int)
                    or not isinstance(snap.get("queue"), list)
                    or not isinstance(snap.get("holdings"), dict)):
                out.append(f"QUEUE-COMPLETE: partial snapshot {snap}")
            elif not 0 <= snap.get("free", -1) <= snap["total"]:
                out.append("QUEUE-COMPLETE: free outside [0, total]: "
                           f"{snap}")
        try:
            records = self._read_ledger(root)
        except Exception as e:   # noqa: BLE001 - strict reader models the hazard
            out.append("LEDGER-TAIL-PREFIX: ledger reader raised on a "
                       f"torn tail past a durable head: {e!r}")
            return out
        prev_seq = 0
        for rec in records:
            seq = rec.get("seq")
            if not isinstance(seq, int) or seq <= prev_seq:
                out.append(f"SEQ-MONOTONIC: seq {seq} after {prev_seq} "
                           "— the surviving prefix is not the true "
                           "transition history")
                break
            prev_seq = seq
            if rec.get("held", -1) + rec.get("free", -1) \
                    != rec.get("total", -2):
                out.append("SLOT-CONSERVATION: held + free != total in "
                           f"intact record {rec}")
                break
        return out

    def retry(self, root: str) -> None:
        self.writer(root)

    def check_final(self, root: str) -> List[str]:
        from dgc_tpu_torch.control import scheduler as sched
        out = self.check_crash(root)
        # a completed (uncrashed) writer pass always leaves a readable
        # snapshot and its full transition trail on the ledger
        if sched.read_queue(root) is None:
            out.append("QUEUE-COMPLETE: no readable snapshot after a "
                       "completed writer pass")
        try:
            events = [r.get("event") for r in self._read_ledger(root)]
        except Exception:   # noqa: BLE001 - already reported by check_crash
            return out
        for needed in ("admit", "grant", "shrunk", "completed"):
            if needed not in events:
                out.append(f"SEQ-MONOTONIC: completed transition "
                           f"{needed!r} missing from the ledger trail")
        return out


def scenarios(mutate: Optional[str] = None,
              fast: bool = False) -> List[Scenario]:
    """All protocol scenarios, in protospec order. ``fast`` drops the
    checkpoint scenario (the gate runs full)."""
    out: List[Scenario] = [
        ServingScenario(),
        SurgeryScenario(),
        EnvFileScenario(),
        CohortLedgerScenario(),
        FabricScenario(),
        TelemetryStreamScenario(mutate=mutate),
        SchedulerLedgerScenario(mutate=mutate),
    ]
    if not fast:
        out.insert(1, CheckpointScenario())
    return out


# --------------------------------------------------------------------- #
# driver                                                                 #
# --------------------------------------------------------------------- #

def _fresh_root(base: str, scn: Scenario) -> str:
    root = os.path.join(base, "fs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    scn.setup(root)
    return root


@contextlib.contextmanager
def _quiet_unraisable():
    """Silence GC-time ``Exception ignored in ZipFile.__del__`` noise: a
    :class:`Crash` injected mid-``np.savez`` orphans a write-mode
    ZipFile whose finalizer later seeks a closed fp. Deliberate fallout
    of crash injection, not a finding — everything else still surfaces."""
    old = sys.unraisablehook

    def hook(unr):
        if isinstance(unr.exc_value, ValueError):
            return
        old(unr)

    sys.unraisablehook = hook
    try:
        yield
    finally:
        gc.collect()   # reap the orphans while the hook is active
        sys.unraisablehook = old


def explore(scn: Scenario, log: Callable[[str], None] = print,
            mutate: Optional[str] = None) -> List[str]:
    """Run one scenario: the live interleaved trace, then every crash
    point with torn-state effects, reader restart, and writer retry.
    Returns violation strings (each names the protocol and step)."""
    with _quiet_unraisable():
        return _explore(scn, log=log, mutate=mutate)


def _explore(scn: Scenario, log: Callable[[str], None],
             mutate: Optional[str]) -> List[str]:
    violations: List[str] = []

    def record(ctx: str, msgs: List[str], notes: List[str]) -> None:
        for m in msgs:
            suffix = f" [{'; '.join(notes)}]" if notes else ""
            violations.append(f"{scn.name} @ {ctx}: {m}{suffix}")

    record("model", scn.pre_explore(), [])

    with tempfile.TemporaryDirectory(prefix=f"dgcmc-{scn.name}-") as base:
        # pass 1: uncrashed, readers interleaved at every syscall
        root = _fresh_root(base, scn)

        def live_check(k, kind, rel):
            record(f"step {k} ({kind} {rel})", scn.check_live(root), [])

        sb = Sandbox(root, mutate=mutate, track_writes=scn.track_writes,
                     write_once=scn.write_once, on_op=live_check)
        with sb:
            scn.writer(root)
            if mutate == "write_once_rewrite":
                scn.sabotage(root)
        record("live", sb.violations, sb.notes)
        record("final", scn.check_final(root), sb.notes)
        n_ops = sb.count

        # pass 2: crash immediately before (or mid-) every syscall
        points = list(range(n_ops))
        if len(points) > scn.max_points:
            stride = len(points) / float(scn.max_points)
            points = sorted({int(i * stride) for i in range(scn.max_points)})
            log(f"{scn.name}: {n_ops} ops, sampling {len(points)} "
                f"crash points (cap {scn.max_points})")
        for k in points:
            root = _fresh_root(base, scn)
            sb = Sandbox(root, crash_at=k, mutate=mutate,
                         track_writes=scn.track_writes,
                         write_once=scn.write_once)
            crashed = False
            with sb:
                try:
                    scn.writer(root)
                    if mutate == "write_once_rewrite":
                        scn.sabotage(root)
                except Crash:
                    crashed = True
            kind, rel = sb.ops[k] if k < len(sb.ops) else ("?", "?")
            ctx = f"crash at step {k} ({kind} {rel})"
            torn = sb.apply_crash_effects()
            notes = sb.notes + ([f"torn: {t}" for t in torn])
            record(ctx, sb.violations, notes)
            record(ctx, scn.check_crash(root), notes)
            if crashed:
                # the crashed writer is relaunched and retries; the
                # protocol must converge (second-writer interleaving)
                scn.retry(root)
                record(f"{ctx} + retry", scn.check_final(root), notes)
    return violations


def run_mc_suite(log: Callable[[str], None] = print,
                 mutate: Optional[str] = None, fast: bool = False
                 ) -> List[Tuple[str, List[str]]]:
    """Explore every protocol scenario; returns ``(name, violations)``
    pairs, violation-free at HEAD. ``mutate`` (or ``DGC_MC_MUTATE``)
    seeds one of :data:`MUTATIONS` and must turn at least one protocol
    red naming the step — the checker's own red test."""
    if mutate is None:
        mutate = os.environ.get("DGC_MC_MUTATE") or None
    if mutate is not None and mutate not in MUTATIONS:
        raise ValueError(f"unknown mc mutation {mutate!r} "
                         f"(expected one of {MUTATIONS})")
    from dgc_tpu_torch.analysis.protospec import PROTOCOLS_BY_NAME
    results: List[Tuple[str, List[str]]] = []
    for scn in scenarios(mutate=mutate, fast=fast):
        assert scn.name in PROTOCOLS_BY_NAME, scn.name
        viols = explore(scn, log=log, mutate=mutate)
        state = "RED" if viols else "ok"
        log(f"{scn.name}: {state}"
            + (f" ({len(viols)} violation(s))" if viols else ""))
        results.append((scn.name, viols))
    return results
