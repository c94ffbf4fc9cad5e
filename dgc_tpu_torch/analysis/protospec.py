"""Declarative specs of the host file protocols (layer 4).

Counterpart of ``dgc_tpu/analysis/protospec.py``, the same data with
each file's writer and readers named in this package
(``dgc_tpu_torch.<module>.<function>``).

Every coordination mechanism in this tree ultimately rendezvouses on a
small set of files: the checkpoint ``e<N>`` directories and their
``latest.json`` pointer, the surgery order/exit records, the serving
``manifest.json`` + versioned npz artifacts, the supervisor's
``KEY=VALUE`` env-file, the ``cohort.json`` pool ledger, the autotuned
``fabric.json``, and the JSONL telemetry/event streams. DGC's
error-feedback mass-conservation guarantee is only as strong as these
protocols: a torn cohort spec relaunches the world at the wrong size, a
half-written manifest desyncs every replica, a lost ``latest.json``
silently restarts training from scratch while good checkpoints sit on
disk.

This module is the *spec* side of the crash-consistency model checker
(:mod:`dgc_tpu_torch.analysis.mc` is the *driver*): one
:class:`ProtocolSpec` per protocol, naming each file's writers, readers,
atomicity class, and the invariants every reachable filesystem state
must satisfy. The specs are data — ``mc.py`` binds each one to an
executable scenario over the REAL protocol functions. A test
pins that every spec here has a scenario in the checker (no spec may be
documentation-only).

Atomicity classes
-----------------

* :data:`RENAME_ATOMIC` — published via ``tempfile.mkstemp`` + write +
  ``fsync`` + ``os.replace`` in the destination directory (the one
  blessed idiom, ``serving.protocol.write_json_atomic``). A reader sees
  the old complete file or the new complete file, never a tear; a
  crashed writer leaves only ``*.tmp`` litter. The fsync matters: an
  ``os.replace`` of unsynced data publishes a file whose CONTENT may
  still be lost by the crash ("write-before-fsync"), which is exactly
  the hazard the ``drop_fsync`` seeded mutation re-introduces.
* :data:`WRITE_ONCE` — the path encodes a version (``delta_v{V}_{S}``,
  ``e<N>``); once published under a name, the bytes under that name
  never change. Readers may cache by name forever; the checker's
  write-once ledger flags any same-name republish with different
  content.
* :data:`APPEND_TAIL_TORN` — append-only JSONL whose tail may be torn
  by a crash (appends are flushed, not fsynced, by design — a sink
  fsync per step would serialize training on the disk). The contract
  moves to the READER: it must skip a torn tail and return a prefix of
  the written records (``telemetry.sink.read_run_tolerant``), never
  raise on mid-record truncation past the header.
"""

from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = ["RENAME_ATOMIC", "WRITE_ONCE", "APPEND_TAIL_TORN",
           "FileSpec", "ProtocolSpec", "PROTOCOLS", "PROTOCOLS_BY_NAME"]

RENAME_ATOMIC = "rename-atomic"
WRITE_ONCE = "write-once"
APPEND_TAIL_TORN = "append-tail-torn"


@dataclass(frozen=True)
class FileSpec:
    """One file (or file family) of a protocol."""
    pattern: str          #: basename or glob (``delta_v*.npz``)
    atomicity: str        #: one of the three atomicity classes above
    writer: str           #: the one function allowed to publish it
    readers: Tuple[str, ...]  #: tolerant readers (None-on-torn contract)


@dataclass(frozen=True)
class ProtocolSpec:
    """One coordination protocol = its files + machine-checked invariants.

    ``invariants`` maps a stable id to the prose statement; the mc
    scenario for this protocol asserts each one in every explored state
    (every crash point, every reader interleaving). ``legal_orders``
    states the version/sequence ordering a reader may observe.
    """
    name: str
    files: Tuple[FileSpec, ...]
    invariants: Dict[str, str] = field(default_factory=dict)
    legal_orders: str = ""


PROTOCOLS: Tuple[ProtocolSpec, ...] = (
    ProtocolSpec(
        name="serving-manifest",
        files=(
            FileSpec("manifest.json", RENAME_ATOMIC,
                     "serving.protocol.write_json_atomic",
                     ("serving.protocol.read_manifest",)),
            FileSpec("base_v*.npz", RENAME_ATOMIC,
                     "serving.protocol.save_npz_atomic",
                     ("serving.protocol.load_npz",)),
            FileSpec("delta_v*.npz", WRITE_ONCE,
                     "serving.protocol.save_npz_atomic",
                     ("serving.protocol.load_npz",)),
        ),
        invariants={
            "MANIFEST-COMPLETE": "a reader never observes a torn or "
                                 "partial manifest.json: read_manifest "
                                 "returns the previous complete head or "
                                 "the new one, never raises",
            "HEAD-MONOTONIC": "the (base_version, latest_seq) head a "
                              "reader observes never regresses and never "
                              "skips: after a crashed publish it is the "
                              "old head or the new head",
            "DELTA-WRITE-ONCE": "delta_v{V}_{S}.npz bytes never change "
                                "once published (replica digest trail "
                                "depends on it)",
            "REPLICA-TOTAL": "Replica.poll() never raises in any "
                             "reachable state — gaps/staleness degrade "
                             "to a resync request, not a crash",
        },
        legal_orders="(V, S) -> (V, S+1) per delta publish; "
                     "(V, *) -> (V+1, 0) per rebase",
    ),
    ProtocolSpec(
        name="checkpoint-epoch",
        files=(
            FileSpec("e<N>/", RENAME_ATOMIC,
                     "training.checkpoint.CheckpointManager.save "
                     "(e<N>.tmp staged with torch.save, one os.replace)",
                     ("CheckpointManager.restore",)),
            FileSpec("latest.json", RENAME_ATOMIC,
                     "serving.protocol.write_json_atomic",
                     ("CheckpointManager.latest_epoch",
                      "supervisor.checkpoint_progress")),
        ),
        invariants={
            "CKPT-COMPLETE-OR-ABSENT": "an e<N> directory either holds a "
                                       "complete restorable checkpoint "
                                       "(meters.json included) or does "
                                       "not exist; crashes leave only "
                                       ".tmp litter",
            "RESTORE-FALLBACK": "restore() after any crash returns a "
                                "previously saved epoch exactly "
                                "(bit-equal arrays), never raises, never "
                                "silently restarts from scratch while a "
                                "good epoch exists",
            "LATEST-TOLERATED": "a torn/missing latest.json degrades to "
                                "the kept-epoch scan, not a crash",
        },
        legal_orders="epoch pointer only ever moves to an epoch whose "
                     "directory is already complete",
    ),
    ProtocolSpec(
        name="surgery-order",
        files=(
            FileSpec("surgery.json", RENAME_ATOMIC,
                     "resilience.surgery.publish_order",
                     ("resilience.surgery.read_order",)),
            FileSpec("surgery_exit.json", RENAME_ATOMIC,
                     "resilience.surgery.write_exit_record",
                     ("resilience.surgery.read_exit_record",)),
        ),
        invariants={
            "ORDER-COMPLETE": "read_order returns a complete order "
                              "(verdict + target) or None — a torn or "
                              "malformed order degrades to 'no order', "
                              "it must never crash a step boundary",
            "EXIT-COMPLETE": "read_exit_record returns a complete record "
                             "or None in every reachable state",
            "DOUBLE-SHRINK": "applying an exit record twice cannot "
                             "shrink the cohort twice: shrink_updates is "
                             "a pure function of the record's FROM-world, "
                             "so every survivor (and every retry) "
                             "publishes the same spec",
        },
        legal_orders="order precedes exit record; both derive the same "
                     "(verdict, target)",
    ),
    ProtocolSpec(
        name="supervisor-env",
        files=(
            FileSpec("<env-file>", RENAME_ATOMIC,
                     "control.actions.publish_env "
                     "(serving.protocol.write_text_atomic)",
                     ("control.supervisor.parse_env_file",)),
        ),
        invariants={
            "SPEC-COMPLETE": "a relaunching supervisor reads the old "
                             "complete cohort spec or the new complete "
                             "one — never a truncated KEY=VALUE set (a "
                             "torn spec is UNDETECTABLE by the reader: "
                             "'JAX_NUM_PROCESSES=3' truncated from "
                             "'...=32' parses fine and relaunches the "
                             "wrong world, so writer atomicity+fsync is "
                             "the only defense)",
            "MERGE-IDEMPOTENT": "a crashed publish retried (or raced by "
                                "a second publisher) converges to the "
                                "merged spec",
        },
        legal_orders="last completed publish wins; every intermediate "
                     "observable state is some completed publish",
    ),
    ProtocolSpec(
        name="cohort-ledger",
        files=(
            FileSpec("cohort.json", RENAME_ATOMIC,
                     "control.plane.ControlPlane._write_cohort_files "
                     "(serving.protocol.write_json_atomic)",
                     ("telemetry.monitor (COHORT line)",)),
        ),
        invariants={
            "LEDGER-COMPLETE": "cohort.json is always a complete "
                               "snapshot: totals present and consistent "
                               "(active + free + quarantined slots == "
                               "total)",
            "POOL-ONE-WAY": "DevicePool transitions are one-way per call "
                            "and idempotent: quarantine only moves "
                            "active->quarantined, release only "
                            "quarantined->freed, and replaying any "
                            "transition is a no-op — racing ticks cannot "
                            "double-count a slot",
        },
        legal_orders="active -> quarantined -> freed -> active "
                     "(readmit); no other edges",
    ),
    ProtocolSpec(
        name="fabric-autotune",
        files=(
            FileSpec("fabric.json", RENAME_ATOMIC,
                     "compression.autotune.Autotuner.write_fabric "
                     "(serving.protocol.write_json_atomic)",
                     ("compression.planner.load_fabric",
                      "compression.planner.resolve_fabric")),
        ),
        invariants={
            "FABRIC-COMPLETE": "resolve_fabric(None, runs_dir=...) never "
                               "raises in any reachable state: after a "
                               "crashed refit the reader sees the old "
                               "complete fabric or the new one (training "
                               "startup must not crash on last epoch's "
                               "interrupted autotuner)",
            "FIT-PAIRED": "alpha_ms and gbps are observed together — "
                          "both from the old fit or both from the new, "
                          "never mixed",
        },
        legal_orders="refit N -> refit N+1; readers see a complete fit "
                     "from some single refit",
    ),
    ProtocolSpec(
        name="telemetry-stream",
        files=(
            FileSpec("*.jsonl", APPEND_TAIL_TORN,
                     "telemetry.sink.JsonlAppender.write",
                     ("telemetry.sink.read_run_tolerant",)),
        ),
        invariants={
            "TAIL-PREFIX": "after any crash the tolerant reader returns "
                           "a PREFIX of the written records — a torn "
                           "tail is skipped, never surfaced as a "
                           "partial/garbage record, and the reader "
                           "never raises past a durable header",
            "STRICT-IS-WRONG": "the strict reader (read_run) is NOT "
                               "crash-safe on this class by design — "
                               "the torn_tail seeded mutation pins that "
                               "substituting it turns the checker red",
        },
        legal_orders="records are observed in append order; only the "
                     "unsynced tail may be lost",
    ),
    ProtocolSpec(
        name="scheduler-ledger",
        files=(
            FileSpec("sched_queue.json", RENAME_ATOMIC,
                     "control.scheduler.GangScheduler._write_queue_locked "
                     "(serving.protocol.write_json_atomic)",
                     ("control.scheduler.read_queue",)),
            FileSpec("sched_grants.jsonl", APPEND_TAIL_TORN,
                     "control.scheduler.GangScheduler._record_locked "
                     "(telemetry.sink.JsonlAppender.write)",
                     ("control.scheduler.read_grant_ledger",)),
        ),
        invariants={
            "QUEUE-COMPLETE": "read_queue returns a complete queue + "
                              "holdings snapshot or None — a torn or "
                              "crashed-mid-publish snapshot degrades to "
                              "'no snapshot', never garbage (a garbled "
                              "queue could double-grant a slot)",
            "SLOT-CONSERVATION": "every intact grant-ledger record "
                                 "carries held + free == total — at "
                                 "every crash point the slot accounting "
                                 "balances (an admit, grant, shrink, or "
                                 "completion can move seats but never "
                                 "mint or leak one)",
            "SEQ-MONOTONIC": "ledger records are observed in strictly "
                             "increasing seq order — the tolerant "
                             "reader's surviving prefix is the true "
                             "transition history, so grant latency and "
                             "preempt audits replay faithfully",
            "LEDGER-TAIL-PREFIX": "a crash may tear only the final "
                                  "ledger line; read_grant_ledger skips "
                                  "and counts it, never raises, never "
                                  "yields a partial record",
        },
        legal_orders="admit precedes grant for a name; preempt precedes "
                     "shrunk for a victim; only the unsynced ledger tail "
                     "may be lost",
    ),
)

PROTOCOLS_BY_NAME: Dict[str, ProtocolSpec] = {p.name: p for p in PROTOCOLS}
