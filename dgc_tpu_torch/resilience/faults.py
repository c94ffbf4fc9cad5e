"""Deterministic, environment-driven fault injection.

Counterpart of ``dgc_tpu/resilience/faults.py``: the same ``DGC_FAULTS``
grammar, parsed by the same rules, so one plan string arms the same
faults in both packages:

    DGC_FAULTS="nan@2,bitflip:elem=0:bit=18,kill@5,init_fail@2"

Comma-separated tokens, each ``kind[@step][:key=val]*``:

* ``nan@K`` — every gradient of every local worker is NaN at train step K
  (the step counter ``TrainState.step``, a host int in the port).
* ``bitflip[:elem=I][:bit=B]`` — XOR bit B of gathered wire-value element
  I (of the flattened ``[W, payload]`` values, post-gather): the
  corruption the payload checksum counts.
* ``badidx[:elem=I][:set=V]`` — overwrite gathered payload index I with V
  (before the clamp): the corruption the clamp routes to the sentinel.
* ``kill@K`` — ``SIGTERM`` to the own process after step K (the
  preemption drill).
* ``init_fail@N`` — the first N process-group initialisations raise.
* ``slow[:ms=M][@K-L]``, ``hang[:secs=S]@K``, ``exit:code=N@K`` — host
  stalls, a stop without exit, an ``os._exit`` (windowed as in the JAX
  package).
* ``droplink:peer=P[@K-L]`` — parsed, but arming it raises: the gossip
  exchange it drops a link of is not ported (ROADMAP.md queue 1 item 8).

The plan is read once, where the engine and the trainer are built
(:func:`plan`), never per call: with ``DGC_FAULTS`` unset the engine and
the step hold ``None`` and run exactly what they run without this module
(the same kernels, the same launches). The injectors return copies:
``LocalComm``'s gathered tensors are shared by every local worker.
Unknown tokens raise.
"""

import os
import signal
import time
from typing import Dict, NamedTuple, Optional

import torch

__all__ = ["ENV", "FaultPlan", "plan", "armed", "active_plan",
           "inject_nan_grads", "corrupt_wire", "corrupt_indices",
           "maybe_kill", "maybe_slow", "maybe_hang", "maybe_exit",
           "should_fail_init"]

ENV = "DGC_FAULTS"


class FaultPlan(NamedTuple):
    nan_step: Optional[int] = None
    kill_step: Optional[int] = None
    init_failures: int = 0
    bitflip: Optional[Dict[str, int]] = None
    badidx: Optional[Dict[str, int]] = None
    slow_ms: Optional[int] = None
    #: inclusive (first, last) step window for ``slow``; None = every step
    slow_window: Optional[tuple] = None
    #: inclusive (first, last) step window for ``hang``; None = unarmed
    hang_window: Optional[tuple] = None
    #: per-step stall seconds for ``hang``; None = block forever
    hang_secs: Optional[int] = None
    #: ``os._exit`` code for ``exit``; None = unarmed
    exit_code: Optional[int] = None
    #: inclusive (first, last) step window for ``exit``
    exit_window: Optional[tuple] = None
    #: worker whose gossip contribution is suppressed; None = unarmed
    droplink_peer: Optional[int] = None
    #: inclusive (first, last) gossip-round window for ``droplink``
    droplink_window: Optional[tuple] = None


def plan(spec: Optional[str] = None) -> FaultPlan:
    """Parse the fault plan from ``spec`` or the ``DGC_FAULTS`` variable."""
    if spec is None:
        spec = os.environ.get(ENV, "")
    nan_step = kill_step = slow_ms = slow_window = None
    hang_window = hang_secs = exit_code = exit_window = None
    droplink_peer = droplink_window = None
    init_failures = 0
    bitflip = badidx = None

    def window(at):
        lo, _, hi = at.partition("-")
        return (int(lo), int(hi) if hi else None)

    for tok in filter(None, (t.strip() for t in spec.split(","))):
        parts = tok.split(":")
        head, _, at = parts[0].partition("@")
        params = {}
        for p in parts[1:]:
            k, _, v = p.partition("=")
            # a step window may trail the last param (``slow:ms=M@K-L``)
            v, _, vat = v.partition("@")
            if vat:
                at = vat
            params[k] = int(v)
        if head == "nan":
            nan_step = int(at)
        elif head == "kill":
            kill_step = int(at)
        elif head == "init_fail":
            init_failures = int(at)
        elif head == "bitflip":
            bitflip = {"elem": params.get("elem", 0),
                       "bit": params.get("bit", 0)}
        elif head == "badidx":
            badidx = {"elem": params.get("elem", 0),
                      "set": params.get("set", -1)}
        elif head == "slow":
            slow_ms = params.get("ms", 100)
            if at:
                slow_window = window(at)
        elif head == "hang":
            hang_secs = params.get("secs")
            hang_window = window(at) if at else (0, None)
        elif head == "exit":
            exit_code = params.get("code", 1)
            exit_window = window(at) if at else (0, None)
        elif head == "droplink":
            if "peer" not in params:
                raise ValueError(
                    f"droplink needs :peer=P (got {tok!r} in {ENV})")
            droplink_peer = params["peer"]
            droplink_window = window(at) if at else (0, None)
        else:
            raise ValueError(f"unknown fault token {tok!r} in {ENV}")
    return FaultPlan(nan_step, kill_step, init_failures, bitflip, badidx,
                     slow_ms, slow_window, hang_window, hang_secs,
                     exit_code, exit_window, droplink_peer, droplink_window)


def armed() -> bool:
    return bool(os.environ.get(ENV))


def active_plan() -> Optional[FaultPlan]:
    """The armed plan, or None when ``DGC_FAULTS`` is unset: what the
    engine and the trainer read once when they are built. A ``droplink``
    token raises here, as the gossip exchange is not ported."""
    if not armed():
        return None
    p = plan()
    if p.droplink_peer is not None:
        raise ValueError("droplink drops a link of the gossip exchange, "
                         "which the port does not run (ROADMAP.md queue 1 "
                         "item 8)")
    return p


# ------------------------------------------------------------------ #
# injectors on device tensors (the armed plan passed in)             #
# ------------------------------------------------------------------ #

def inject_nan_grads(p: Optional[FaultPlan], grads, step: int):
    """Every gradient NaN when ``step`` is the plan's ``nan_step``; the
    list unchanged otherwise."""
    if p is None or p.nan_step is None or int(step) != p.nan_step:
        return grads
    return [torch.full_like(g, float("nan")) for g in grads]


def _flip_bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    """One element with bit ``bit`` XORed, as the reference flips it: an
    f32 as its int32 bits, an f16 (and bf16) as its 16 bits at ``bit %
    16``, an integer directly."""
    def signed(m, width):
        return m - (1 << width) if m >= 1 << (width - 1) else m
    if x.dtype == torch.float32:
        return (x.view(torch.int32) ^ signed(1 << bit, 32)).view(x.dtype)
    if x.dtype in (torch.float16, torch.bfloat16):
        return (x.view(torch.int16)
                ^ signed(1 << (bit % 16), 16)).view(x.dtype)
    return x ^ (1 << bit)


def corrupt_wire(p: Optional[FaultPlan], g_values: torch.Tensor
                 ) -> torch.Tensor:
    """A copy of the gathered ``[W, payload]`` wire values with one bit of
    element ``elem % numel`` flipped (the input itself when unarmed)."""
    if p is None or p.bitflip is None or not g_values.numel():
        return g_values
    out = g_values.clone()
    flat = out.view(-1)
    e = p.bitflip["elem"] % flat.shape[0]
    flat[e:e + 1] = _flip_bit(flat[e:e + 1], p.bitflip["bit"])
    return out


def corrupt_indices(p: Optional[FaultPlan], g_indices: torch.Tensor
                    ) -> torch.Tensor:
    """A copy of the gathered ``[W, payload]`` indices with element ``elem
    % numel`` set to ``set`` (the input itself when unarmed)."""
    if p is None or p.badidx is None or not g_indices.numel():
        return g_indices
    out = g_indices.clone()
    flat = out.view(-1)
    e = p.badidx["elem"] % flat.shape[0]
    v = p.badidx["set"]
    if g_indices.dtype == torch.int32:
        v = (v + 2 ** 31) % 2 ** 32 - 2 ** 31      # the reference's wrap
    flat[e] = v
    return out


# ------------------------------------------------------------------ #
# host-side injectors                                                #
# ------------------------------------------------------------------ #

def _in_window(step, win):
    if win is None:
        return False
    lo, hi = win
    if step is None or int(step) < lo:
        return False
    return hi is None or int(step) <= hi


def maybe_kill(p: Optional[FaultPlan], step: int) -> None:
    """SIGTERM the own process at the armed step (preemption drill)."""
    if p is not None and p.kill_step is not None and int(step) == p.kill_step:
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_slow(p: Optional[FaultPlan], step: Optional[int] = None) -> None:
    """Sleep before a step on the armed process; a windowed plan sleeps
    only inside its window (never without a ``step``)."""
    if p is None or p.slow_ms is None:
        return
    if p.slow_window is not None and not _in_window(step, p.slow_window):
        return
    time.sleep(p.slow_ms / 1000.0)


def maybe_hang(p: Optional[FaultPlan], step: Optional[int] = None) -> None:
    """Stop at the armed step without exiting: ``secs`` bounds each
    stall, else it blocks for good (that is the fault)."""
    if p is None or not _in_window(step, p.hang_window):
        return
    if p.hang_secs is not None:
        time.sleep(float(p.hang_secs))
        return
    while True:
        time.sleep(3600.0)


def maybe_exit(p: Optional[FaultPlan], step: Optional[int] = None) -> None:
    """``os._exit(code)`` at the first armed step: a crash past every
    handler."""
    if p is not None and p.exit_code is not None and _in_window(
            step, p.exit_window):
        os._exit(int(p.exit_code))


def should_fail_init(attempt: int) -> bool:
    """True while ``attempt`` (0-based) is within the armed failure count."""
    return armed() and attempt < plan().init_failures
