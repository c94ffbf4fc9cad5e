"""Cohort surgery: worker-granular excise/readmit (host-side code;
counterpart of ``dgc_tpu/resilience/surgery.py``).

DGC's error-feedback invariant means every worker carries irreplaceable
local state (residual + momentum mass), so the only whole-run remediations
— restart, elastic relaunch — are blunt when ONE worker is the problem.
This module is the scalpel:

* **Excise**: a verdict (desync / flight-dump / straggler past budget on
  process *k*) publishes an excise order file; at the next step boundary
  every process folds the order into the step-boundary agreement — the
  :func:`~dgc_tpu_torch.resilience.preempt.agree_preempt` payload widens
  from one flag to ``(preempt, verdict, target)``, one gather over the
  ``torch.distributed`` group — takes one atomic emergency checkpoint
  (everyone is still alive on the orderly path), and exits with
  :data:`EXIT_SURGERY` (76): a supervisor relaunches the survivors under
  the shrunk cohort (:func:`shrink_updates`, :func:`remap_process_id`),
  and the elastic reshard absorbs the evicted worker's residual/momentum
  mass.
* **Hang safety**: when process *k* never reaches the boundary, the
  agreement itself would deadlock. :meth:`SurgeryCoordinator.agree` runs
  the gather on a side thread with a boundary deadline plus bounded
  retry/backoff; a killed member surfaces as a collective error, a silent
  hang as a deadline, and both collapse to ``Agreement(lost=True)`` → the
  same exit-76 path. Survivors roll back to the last atomic checkpoint.
* **Readmit**: a quarantined worker re-earns its slot through a re-init
  probe whose pass criterion is :func:`probe_checksum` matching across
  probe runs.

The target is a *process* (the group's rank), as the reference's is
``jax.process_index()``, even where one process simulates several
workers. Everything here is host-only: order files, the agreement's
payload, deadline threads. Nothing enters the step.
"""

import json
import os
import threading
import time
from typing import NamedTuple, Optional

__all__ = ["EXIT_SURGERY", "ORDER_FILE", "EXIT_RECORD", "VERDICTS",
           "Agreement", "CohortLost", "publish_order", "read_order",
           "clear_order", "encode_lanes", "decode_lanes",
           "SurgeryCoordinator", "write_exit_record", "read_exit_record",
           "shrink_updates", "remap_process_id", "probe_checksum"]

#: child exit code for "cohort surgery agreed — relaunch me under the
#: published shrunk/grown cohort spec" (76; sibling of 75 = clean
#: preemption and 70 = nonfinite abort/quarantine)
EXIT_SURGERY = 76

#: excise-order file name, published under the run's checkpoint dir by
#: the control plane (``act_excise``) or an operator
ORDER_FILE = "surgery.json"

#: exit-record file name written by the workers next to ``latest.json``
#: as they take the exit-76 path; the supervisor reads it to compute the
#: shrunk spec + per-survivor process-id remap
EXIT_RECORD = "surgery_exit.json"

#: agreement verdict kinds, in escalation order — the allgather lane
#: carries the index, and on disagreement the highest code wins
VERDICTS = ("none", "desync", "flight_dump", "straggler", "hang", "manual")

_VERDICT_CODE = {v: i for i, v in enumerate(VERDICTS)}


class CohortLost(RuntimeError):
    """The boundary agreement could not complete: a member is hung or
    dead and the bounded retry/backoff budget is spent."""


class Agreement(NamedTuple):
    """All-process verdict of one step-boundary agreement."""
    preempt: bool = False      #: any member saw SIGTERM/SIGINT
    excise: bool = False       #: an excise order was agreed
    target: int = -1           #: process index to excise (-1: none)
    verdict: str = "none"      #: entry of :data:`VERDICTS`
    lost: bool = False         #: agreement never completed (hang tier)


# ------------------------------------------------------------------ #
# order / exit-record files (atomic tmp+rename, tolerant reads)       #
# ------------------------------------------------------------------ #

def _atomic_write_json(path, payload):
    # one publish idiom tree-wide (mkstemp+fsync+replace); the serving
    # package loads its codecs lazily, so this pulls in the protocol only
    from dgc_tpu_torch.serving import protocol as _sproto
    _sproto.write_json_atomic(path, payload)
    return path


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def publish_order(path, verdict, target, *, step=None, extra=None):
    """Publish an excise order for ``target`` (atomic). Every worker
    reads the same shared path at its next step boundary; the agreement
    lane spreads the order even to workers that raced the write."""
    if verdict not in _VERDICT_CODE or verdict == "none":
        raise ValueError(f"unknown surgery verdict {verdict!r} "
                         f"(expected one of {VERDICTS[1:]})")
    rec = {"verdict": verdict, "target": int(target), "t": time.time()}
    if step is not None:
        rec["step"] = int(step)
    if extra:
        rec.update(extra)
    return _atomic_write_json(path, rec)


def read_order(path):
    """The published excise order, or None (absent / torn / malformed —
    a bad order file must degrade to "no order", never crash a step)."""
    rec = _read_json(path)
    if not isinstance(rec, dict):
        return None
    if rec.get("verdict") not in _VERDICT_CODE or "target" not in rec:
        return None
    return rec


def clear_order(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def write_exit_record(path, agreement, *, world, process_index,
                      step=None):
    """The exit-76 breadcrumb: which verdict fired, who is excised, and
    the world size the cohort was running at — everything a supervisor
    needs to compute the shrunk spec and the survivor id remap."""
    rec = {"verdict": agreement.verdict, "target": int(agreement.target),
           "lost": bool(agreement.lost), "world": int(world),
           "process_index": int(process_index), "t": time.time()}
    if step is not None:
        rec["step"] = int(step)
    return _atomic_write_json(path, rec)


def read_exit_record(path):
    rec = _read_json(path)
    if not isinstance(rec, dict) or "target" not in rec:
        return None
    return rec


# ------------------------------------------------------------------ #
# agreement payload: (preempt, verdict, target) on ONE allgather      #
# ------------------------------------------------------------------ #

def encode_lanes(local_preempt, order):
    """One f32 row per process: ``[preempt, verdict_code, target+1]``.
    The single ``agree_preempt`` gather widens from 1 to 3 lanes — the
    verdict rides the existing lane, no new collective."""
    import numpy as np
    code, target = 0, -1
    if order is not None:
        code = _VERDICT_CODE.get(order.get("verdict"), 0)
        target = int(order.get("target", -1))
    return np.asarray([1.0 if local_preempt else 0.0,
                       float(code), float(target + 1)], np.float32)


def decode_lanes(rows):
    """Reduce the gathered ``[P, 3]`` rows to one :class:`Agreement`:
    OR over preempt, max over verdict/target (the escalation order of
    :data:`VERDICTS` makes "highest wins" deterministic when members
    raced the order file)."""
    import numpy as np
    rows = np.asarray(rows, np.float32).reshape(-1, 3)
    preempt = bool(np.max(rows[:, 0]) > 0.0)
    code = int(np.max(rows[:, 1]))
    target = int(np.max(rows[:, 2])) - 1
    code = min(code, len(VERDICTS) - 1)
    excise = code > 0 and target >= 0
    return Agreement(preempt=preempt, excise=excise,
                     target=target if excise else -1,
                     verdict=VERDICTS[code] if excise else "none")


def _group_device():
    """Where the gather's lanes live: the caller's current card under
    NCCL, else the CPU. Read on the caller's thread — the current CUDA
    device is per thread, and the gather runs on a side thread."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _default_allgather(payload, device):
    """The ``[P, 3]`` rows of every process over the ``torch.distributed``
    group, with the lanes on ``device`` (the process's card under NCCL,
    as :func:`~dgc_tpu_torch.resilience.preempt.agree_preempt` reduces)."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist
    device = torch.device(device)
    scope = (torch.cuda.device(device) if device.type == "cuda"
             else contextlib.nullcontext())
    with scope:
        mine = torch.from_numpy(np.asarray(payload, np.float32)).to(device)
        rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, mine)
        return torch.stack(rows).cpu().numpy()


def _topology_of_group():
    """``(process index, process count)``: the group's rank and size, or
    one process without a group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SurgeryCoordinator:
    """Step-boundary agreement with a hang-safe deadline.

    Drop-in widening of
    :func:`~dgc_tpu_torch.resilience.preempt.agree_preempt`:
    :meth:`agree` returns an :class:`Agreement` instead of a bare bool,
    folding in the published excise order (if any) and surviving a member
    that never reaches the boundary. Single-process runs short-circuit
    with no communication, like ``agree_preempt``.

    ``boundary_timeout`` — seconds a member may trail the boundary before
    the deadline tier engages. ``retries``/``backoff`` — bounded extra
    waits on the same in-flight gather (a late worker may still arrive; a
    SIGKILLed one surfaces as a collective error); exponential, so the
    total hang budget is ``timeout + backoff * (2^retries - 1)``. Budget
    spent → ``Agreement(lost=True)``, never an unbounded block.

    ``allgather`` — test hook; defaults to one ``all_gather`` of the
    three lanes over the ``torch.distributed`` group, on the caller's
    current card under NCCL (read on the caller's thread at each
    agreement: the gather runs on a side thread, whose current device is
    card 0).
    ``process_index`` / ``process_count`` default to the group's rank and
    size (0 and 1 without a group).
    """

    def __init__(self, order_path, *, boundary_timeout=60.0, retries=3,
                 backoff=5.0, process_index=None, process_count=None,
                 allgather=None, log=None):
        self.order_path = order_path
        self.boundary_timeout = float(boundary_timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._pidx = process_index
        self._pcount = process_count
        self._allgather = allgather
        self._log = log or (lambda msg: print(f"[surgery] {msg}",
                                              flush=True))

    def _topology(self):
        if self._pidx is None or self._pcount is None:
            self._pidx, self._pcount = _topology_of_group()
        return self._pidx, self._pcount

    def _gather_bounded(self, payload):
        """The one collective, on a side thread with a deadline. The
        thread may outlive a lost agreement (a blocked gather is not
        cancellable) — it is a daemon, and the caller is about to
        exit 76 anyway."""
        box = {}
        done = threading.Event()
        if self._allgather is not None:
            gather = self._allgather
        else:
            device = _group_device()
            gather = lambda p: _default_allgather(p, device)  # noqa: E731

        def run():
            try:
                box["out"] = gather(payload)
            except Exception as e:      # broken cohort surfaces here
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, name="dgc-surgery-agree",
                             daemon=True)
        t.start()
        if not done.wait(self.boundary_timeout):
            self._log(f"boundary agreement missed the "
                      f"{self.boundary_timeout:.1f}s deadline — a member "
                      "is trailing; entering bounded retry/backoff")
            for attempt in range(self.retries):
                if done.wait(self.backoff * (2 ** attempt)):
                    break
        if not done.is_set():
            raise CohortLost(
                f"agreement still pending after deadline + {self.retries} "
                f"backoff waits (member hung past the budget)")
        if "err" in box:
            raise CohortLost(f"collective failed: {box['err']!r}")
        return box["out"]

    def agree(self, local_preempt):
        """Collective: call at a step boundary on EVERY process."""
        order = read_order(self.order_path) if self.order_path else None
        pidx, pcount = self._topology()
        if pcount == 1:
            # no communication — mirrors agree_preempt's short circuit
            if order is not None:
                return Agreement(preempt=bool(local_preempt), excise=True,
                                 target=int(order["target"]),
                                 verdict=order["verdict"])
            return Agreement(preempt=bool(local_preempt))
        try:
            rows = self._gather_bounded(encode_lanes(local_preempt, order))
        except CohortLost as e:
            self._log(f"cohort lost: {e}")
            return Agreement(lost=True, verdict="hang")
        return decode_lanes(rows)

    def excised(self, agreement):
        """True when THIS process is the one being cut out."""
        pidx, _ = self._topology()
        return bool(agreement.excise) and int(agreement.target) == pidx


# ------------------------------------------------------------------ #
# supervisor-side spec arithmetic                                     #
# ------------------------------------------------------------------ #

def shrink_updates(world, target):
    """Env-file updates for a survivors-only relaunch. Derived from the
    exit record's FROM-world, so every survivor's supervisor computes
    the same value — the racing publishes are idempotent."""
    world, target = int(world), int(target)
    if world <= 1 or target < 0 or target >= world:
        return None
    return {"JAX_NUM_PROCESSES": str(world - 1)}


def remap_process_id(process_id, target):
    """Survivor rank after slot ``target`` is excised: ranks above the
    hole shift down one; the target itself maps to None (excised)."""
    process_id, target = int(process_id), int(target)
    if process_id == target:
        return None
    return process_id - 1 if process_id > target else process_id


# ------------------------------------------------------------------ #
# readmit probe                                                       #
# ------------------------------------------------------------------ #

def _probe_parts(a):
    """A tensor's or an array's (shape string, dtype name, bytes) as numpy
    spells them: ``(48, 32)``, ``float32``, C-order bytes."""
    import numpy as np
    import torch
    if not torch.is_tensor(a):
        a = np.asarray(a)
        return str(a.shape), str(a.dtype), a.tobytes()
    t = a.detach().to("cpu").contiguous()
    dtype = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return str(tuple(t.shape)), dtype, t.numpy().tobytes()


def probe_checksum(arrays):
    """Deterministic checksum over a held-out batch's activations (tensors
    on any device, or arrays): the readmit probe's pass criterion is this
    checksum matching across probe runs — a worker whose device produces
    drifting math has no business rejoining the cohort. Each entry hashes
    its shape, its dtype's name and its bytes as numpy writes them, so the
    hex is the reference's for the same values."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        shape, dtype, data = _probe_parts(a)
        h.update(shape.encode())
        h.update(dtype.encode())
        h.update(data)
    return h.hexdigest()
