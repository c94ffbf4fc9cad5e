"""Gossip sparse exchange with bounded staleness: the schedule algebra.

Counterpart of ``dgc_tpu/compression/gossip.py``, a copy of that
numpy-only module with torch forms of its traced functions. The flat
engine (:mod:`~dgc_tpu_torch.compression.flat`) realizes it on the wire.

DGC's error feedback keeps the gradient mass a worker has not sent in its
velocity, so an exchange without a global barrier loses nothing, it only
defers it. The gossip exchange keeps the one all-gather of every step (the
same lanes, shapes and collectives each round) and decides per round what
the gathered payload feeds:

* **Rotating neighborhoods.** Each gossip round worker ``w`` takes the
  payloads of a small neighborhood, a pure function of ``(round, world,
  topology)``:

  - ``ring``: partners ``{w - s, w + s} mod W`` with the stride
    ``s = 1 + round mod (W // 2)``; at ``2s == W`` (even worlds) the two
    coincide and the round is a perfect matching of antipodes.
  - ``hcube``: the partner ``w XOR m`` with ``m = 1 + round mod (W - 1)``
    (a perfect matching every round; power-of-two worlds only).

  Each sender's payload is divided by its out-degree, so the mixing
  matrix's columns sum to exactly 1: the global signed mass is conserved
  every round.

* **Gossip accumulation.** The parameters stay replicated: a gossip
  round scatters the received payloads into a per-worker ``gossip_inbox``
  that the NEXT round folds into the velocity (after the deferred
  transmit mask, so the receiver's own record never wipes received mass).
  Parameters move only on **full-sync rounds** (the ordinary all-gather
  apply): on the cadence ``sync_every`` and whenever the staleness bound
  forces one.

* **Bounded staleness.** ``gossip_age[p]`` counts the rounds since
  worker ``p``'s contribution last reached the parameters. Every worker
  computes the same ``[W]`` vector from replicated inputs (no collective).
  When a predicted age would exceed ``max_staleness`` the round becomes a
  full sync; ages are clamped at ``max_staleness``, so the bound holds by
  construction. A persistently unreachable peer (the ``droplink`` fault)
  keeps the breach asserted and every round is then a full sync.

Every schedule function has a numpy twin (``*_np``), so an oracle never
shares code with the engine's path. The torch forms (:func:`round_state`,
:func:`row_weights`) take the clock and ages as tensors on one device and
return tensors there: the engine never reads them on the host.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "GossipConfig", "TOPOLOGIES", "make_config",
    "default_sync_every", "default_max_staleness",
    "ring_stride", "hcube_mask", "out_neighbors",
    "recv_weights_np", "row_weights_np", "round_state_np",
    "round_state", "row_weights", "neighbors_per_round",
]

#: supported topologies, in planner-regime order (gossip_ring /
#: gossip_hcube)
TOPOLOGIES = ("ring", "hcube")


class GossipConfig(NamedTuple):
    """Static gossip schedule knobs, part of ``Plan.key()``."""

    #: "ring" (stride-rotating 2-neighborhood) or "hcube" (XOR-mask
    #: pairwise matching; power-of-two worlds only)
    topology: str
    #: sparse exchange group size (the engine's world)
    world: int
    #: scheduled full-sync cadence: round ``t`` is a global all-gather
    #: apply when ``t % sync_every == 0`` (round 0 is always full)
    sync_every: int
    #: staleness bound (rounds): when any worker's predicted age would
    #: exceed it, the round is a forced full sync
    max_staleness: int


def default_sync_every(world: int) -> int:
    """Half the ring's diameter: every chord rotates through at least
    once between scheduled syncs, and a world of 2 still alternates."""
    return max(2, world // 2)


def default_max_staleness(world: int) -> int:
    """One full neighborhood rotation, never tighter than the scheduled
    cadence (a bound below ``sync_every`` would force a sync every
    round)."""
    return max(world, default_sync_every(world))


def make_config(topology: str, world: int,
                sync_every: Optional[int] = None,
                max_staleness: Optional[int] = None) -> GossipConfig:
    """Build and validate a :class:`GossipConfig`."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown gossip topology {topology!r}; "
                         f"expected one of {TOPOLOGIES}")
    if world < 2:
        raise ValueError(f"gossip needs world >= 2, got {world}")
    if topology == "hcube" and (world & (world - 1)):
        raise ValueError(
            f"gossip_hcube needs a power-of-two world (XOR matching), "
            f"got {world} — use gossip_ring on this cohort")
    se = default_sync_every(world) if sync_every is None else int(sync_every)
    ms = (default_max_staleness(world) if max_staleness is None
          else int(max_staleness))
    if se < 1:
        raise ValueError(f"sync_every must be >= 1, got {se}")
    if ms < se:
        raise ValueError(
            f"max_staleness ({ms}) below sync_every ({se}) would force a "
            "full sync every round — raise the bound or tighten the "
            "cadence")
    return GossipConfig(topology, int(world), se, ms)


def neighbors_per_round(topology: str) -> int:
    """Out-neighbors the planner charges a round (the ring's antipode
    round is charged at 2, the conservative bound)."""
    return 2 if topology == "ring" else 1


# --------------------------------------------------------------------- #
# schedules: pure functions of (round, world), for python ints, numpy   #
# and tensors alike                                                     #
# --------------------------------------------------------------------- #

def ring_stride(clock, world: int):
    """Ring chord length for this round: rotates 1..W//2."""
    return 1 + clock % (world // 2)


def hcube_mask(clock, world: int):
    """Hypercube XOR mask for this round: rotates 1..W-1."""
    return 1 + clock % (world - 1)


def out_neighbors(cfg: GossipConfig, clock: int, w: int) -> Tuple[int, ...]:
    """Host-side out-neighborhood of worker ``w`` at round ``clock`` (the
    in-neighborhood too: both topologies are symmetric)."""
    if cfg.topology == "ring":
        s = int(ring_stride(clock, cfg.world))
        lo, hi = (w - s) % cfg.world, (w + s) % cfg.world
        return (lo,) if lo == hi else (lo, hi)
    return (w ^ int(hcube_mask(clock, cfg.world)),)


def recv_weights_np(cfg: GossipConfig, clock: int,
                    receiver: int) -> np.ndarray:
    """The receive weights ``[W]`` f32: ``1/outdeg(p)`` for each
    in-neighbor ``p`` of ``receiver``, else 0. Column sums over receivers
    are exactly 1."""
    w = np.zeros((cfg.world,), np.float32)
    for p in out_neighbors(cfg, clock, receiver):
        w[p] = 1.0 / len(out_neighbors(cfg, clock, p))
    return w


def row_weights_np(cfg: GossipConfig, clock: int, receiver: int,
                   full: bool,
                   dropped: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy twin of :func:`row_weights` (before the division by W)."""
    if full:
        w = np.ones((cfg.world,), np.float32)
    else:
        w = recv_weights_np(cfg, clock, receiver) * cfg.world
    if dropped is not None:
        w = w * (1.0 - np.asarray(dropped, np.float32))
    return w


def round_state_np(cfg: GossipConfig, clock: int, age: np.ndarray,
                   dropped: Optional[np.ndarray] = None):
    """Numpy twin of :func:`round_state`: ``(full, forced, new_age)``."""
    age = np.asarray(age, np.int64)
    live = (np.ones((cfg.world,), bool) if dropped is None
            else ~np.asarray(dropped, bool))
    is_sched = (clock % cfg.sync_every) == 0
    tent = age + 1
    pred = np.where(is_sched & live, 0, tent)
    breach = bool(np.any(pred > cfg.max_staleness))
    full = is_sched or breach
    forced = breach and not is_sched
    new_age = np.where(full & live, 0,
                       np.minimum(tent, cfg.max_staleness))
    return full, forced, new_age.astype(np.int32)


# --------------------------------------------------------------------- #
# torch forms: what the engine runs, on the memory's device             #
# --------------------------------------------------------------------- #

def _recv_weights(cfg: GossipConfig, clock: torch.Tensor,
                  widx: int) -> torch.Tensor:
    """``[W]`` f32 receive weights of worker ``widx`` at the round in the
    int32 scalar tensor ``clock``: 1/outdeg for each in-neighbor, else
    0."""
    ids = torch.arange(cfg.world, dtype=torch.int32, device=clock.device)
    if cfg.topology == "ring":
        s = ring_stride(clock.to(torch.int32), cfg.world)
        lo = torch.remainder(widx - s, cfg.world)
        hi = torch.remainder(widx + s, cfg.world)
        mask = (ids == lo) | (ids == hi)
        # the antipode round (2s == W) is a single-partner matching:
        # dividing by the out-degree keeps the columns summing to 1
        deg = torch.where(2 * s == cfg.world, 1.0, 2.0).to(torch.float32)
        return mask.to(torch.float32) / deg
    partner = torch.bitwise_xor(
        torch.tensor(widx, dtype=torch.int32, device=clock.device),
        hcube_mask(clock.to(torch.int32), cfg.world))
    return (ids == partner).to(torch.float32)


def round_state(cfg: GossipConfig, clock: torch.Tensor, age: torch.Tensor,
                dropped: Optional[torch.Tensor] = None):
    """The round's classification, on the device: ``(full, forced,
    new_age)``. ``full`` — bool scalar: a global all-gather apply
    (scheduled by the cadence, or forced by a predicted breach);
    ``forced`` — bool scalar: the breach alone forced it; ``new_age`` —
    the post-round ``[W]`` int32 ages, clamped at ``max_staleness``. A
    ``dropped`` peer never resets (its mass stayed in its residual)."""
    live = (torch.ones((cfg.world,), dtype=torch.bool, device=age.device)
            if dropped is None else torch.logical_not(dropped))
    is_sched = torch.remainder(clock, cfg.sync_every) == 0
    tent = age + 1
    pred = torch.where(is_sched & live, torch.zeros_like(tent), tent)
    breach = torch.any(pred > cfg.max_staleness)
    full = is_sched | breach
    forced = breach & torch.logical_not(is_sched)
    new_age = torch.where(full & live, torch.zeros_like(tent),
                          torch.clamp(tent, max=cfg.max_staleness))
    return full, forced, new_age.to(torch.int32)


def row_weights(cfg: GossipConfig, clock: torch.Tensor, widx: int,
                full: torch.Tensor,
                dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[W]`` f32 per-sender weights of worker ``widx`` on the gathered
    payload rows, before the exchange's division by W: on a full round 1
    for each live sender (1/W after the division: the all-gather
    average); on a gossip round ``W / outdeg`` for this worker's
    in-neighbors (1/outdeg after it) and 0 for the rest. A dropped sender
    weighs 0 either way."""
    ones = torch.ones((cfg.world,), dtype=torch.float32, device=clock.device)
    w = torch.where(full, ones, _recv_weights(cfg, clock, widx) * cfg.world)
    if dropped is not None:
        w = w * (1.0 - dropped.to(torch.float32))
    return w
