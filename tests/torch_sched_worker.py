"""Fake gang member for the port's scheduler drill
(tests/test_torch_scheduler.py): ``tests/sched_worker.py`` plus an end
that waits on an event instead of a step count (``--until-world``,
below).

Gang members form a W-wide cohort under one ControlPlane + GangScheduler,
lock-stepped through a file barrier in a shared ``--cohort`` dir — no
jax, millisecond steps — so the full priority-inversion cycle of
docs/RESILIENCE.md §Scheduler runs in seconds:

* every step each member accumulates a deterministic per-(step, seat)
  residual contribution into an f32 accumulator (``res.<seat>.json``),
  mirroring DGC error feedback, alongside an exact f64 oracle trail
  (``mass_in``) of everything ever added — the drill's conservation
  check is |Σ res − Σ mass_in| ≤ 1e-6 across the cohort. Contributions
  are dyadic rationals (exact in f32) so a lost seat shows up as ~1e-1,
  never as accumulated rounding;
* a published surgery order (the scheduler's preempt-to-grant) is
  consumed at the step boundary: EVERY member writes its residual state
  (the excised seat marks it ``final``), writes a ``surgery_exit.json``
  record naming the target, and exits 76 — the supervisors apply the
  shrunk spec, quarantine the excised seat, and relaunch survivors;
* a stale order (``target >= W`` after the shrink already applied) is
  ignored, so survivors self-stabilize without a cleanup pass;
* seat 0 folds the final residual of any seat outside the current world
  into its own accumulator (f32 add — the drill's stand-in for the
  elastic merge) and zeroes the orphan, so the excised seat's mass
  survives the shrink;
* SIGTERM (the grow-path cohort restart) is deferred to the next
  checkpoint — the handler only sets a flag, so the res/mass_in pair is
  never torn — then takes the emergency-save path: persist state,
  exit 75;
* progress is shared (``progress.json``) and barrier markers persist,
  so members relaunched under a re-published spec (survivors at W-1, a
  grown cohort at W+1) resume at the cohort's step;
* a member waiting at a boundary reads the excise order too, and takes
  the same exit as at the step's top;
* ``--until-world N``: ``--steps`` is then a minimum. The cohort keeps
  stepping until it has run at a world of N or more, and ends
  ``--world-steps`` steps after the first such step (``grown.json`` in the
  cohort dir, written once, so every member ends at the same step), or
  at ``--max-steps`` if that world never comes. A drill paced this way
  waits on the grow landing, not on the host's speed.

Telemetry is the fleet schema so the plane's monitor.collect sees a
real-looking run every tick — the autoscale detector reads its
throughput lane.
"""

import argparse
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# the reference's surgery files and telemetry schema, which the port's
# plane reads unchanged (JAX-free modules that start in a fraction of the
# port's, which import torch, at every member launch), and its member's
# file helpers and residual contributions
from dgc_tpu.resilience import surgery  # noqa: E402
from dgc_tpu.telemetry import registry  # noqa: E402
from sched_worker import (_atomic_json, _read_json, _read_step,  # noqa: E402
                          contrib)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--cohort", required=True,
                    help="shared dir: barriers, progress, residual state")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--step-ms", type=float, default=25.0)
    ap.add_argument("--world", type=int, default=2,
                    help="telemetry lane width (fixed across phases)")
    ap.add_argument("--until-world", type=int, default=0,
                    help="with N > 0: --steps is a minimum; end "
                    "--world-steps steps after the cohort first runs at "
                    "a world of N or more")
    ap.add_argument("--world-steps", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="the end when the world never comes (default "
                    "--steps)")
    args = ap.parse_args(argv)

    run_dir = os.path.abspath(args.run_dir)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    cohort_dir = os.path.abspath(args.cohort)
    bar_dir = os.path.join(cohort_dir, "barriers")
    for d in (ckpt_dir, bar_dir):
        os.makedirs(d, exist_ok=True)
    shard_dir = os.path.join(run_dir, "telemetry", "host0")
    os.makedirs(shard_dir, exist_ok=True)

    W = int(os.environ.get("JAX_NUM_PROCESSES") or 1)
    seat = int(os.environ.get("JAX_PROCESS_ID") or 0)
    hb_path = os.environ.get("DGC_HEARTBEAT")
    boundary_timeout = float(os.environ.get("DGC_BOUNDARY_TIMEOUT") or 10.0)
    progress_path = os.path.join(cohort_dir, "progress.json")
    order_path = os.path.join(ckpt_dir, surgery.ORDER_FILE)
    res_path = os.path.join(cohort_dir, "res.%d.json" % seat)
    grown_path = os.path.join(cohort_dir, "grown.json")

    static = {"world": args.world, "num_params": 1000, "payload_elems": 50,
              "num_processes": W, "process_id": seat}
    run_id = os.environ.get("DGC_RUN_ID")
    if run_id:
        static["run_id"] = run_id

    def beat():
        if not hb_path:
            return
        try:
            with open(hb_path, "a"):
                pass
            os.utime(hb_path, None)
        except OSError:
            pass

    def save(completed):
        _atomic_json(os.path.join(ckpt_dir, "latest.json"),
                     {"epoch": int(completed)})

    fh = open(os.path.join(shard_dir, "telemetry.jsonl"), "w")

    def emit(rec):
        fh.write(json.dumps(rec) + "\n")
        fh.flush()

    emit(registry.make_header(static, guards=True, fleet=True))

    # residual state: f32 accumulator + exact f64 oracle trail, resumed
    # from the seat's own atomic file across relaunches
    st = _read_json(res_path) or {}
    res = np.float32(st.get("res", 0.0))
    mass_in = float(st.get("mass_in", 0.0))
    folded = list(st.get("folded", []))

    # cohort-wide resume point: all members of a (re)formed cohort start
    # at the same shared step
    step = max(_read_step(progress_path),
               _read_step(os.path.join(ckpt_dir, "latest.json"), 0))
    state = {"step": step}

    def save_res(final=False):
        _atomic_json(res_path, {
            "seat": seat, "step": state["step"], "res": float(res),
            "mass_in": mass_in, "folded": folded, "final": bool(final)})

    # SIGTERM/SIGINT are deferred to the next checkpoint: the handler
    # only raises a flag, so res and mass_in (updated as a pair) can
    # never be persisted torn
    term = {"flag": False}

    def on_term(signum, frame):
        term["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    def emergency_exit():
        save(state["step"])
        save_res()
        fh.flush()
        os._exit(75)

    def fold_orphans():
        """Seat 0 folds the final residual of seats outside the current
        world into its own accumulator (the elastic-merge stand-in):
        own state first (crash between the writes double-counts — the
        'folded' list dedups on resume — instead of losing mass)."""
        nonlocal res
        if seat != 0:
            return
        for j in range(W, 16):
            if j in folded:
                continue
            p = os.path.join(cohort_dir, "res.%d.json" % j)
            rec = _read_json(p)
            if not rec or not rec.get("final"):
                continue
            res = np.float32(res + np.float32(rec.get("res", 0.0)))
            folded.append(j)
            save_res()
            _atomic_json(p, dict(rec, res=0.0, folded_into=seat))
            emit({"event": "residual_fold", "t_host": round(time.time(), 3),
                  "from_seat": j, "into_seat": seat,
                  "mass": rec.get("res", 0.0)})

    def barrier(s):
        """Write own marker, wait for all W peers'. Markers persist, so
        a resuming member fast-forwards through past steps. Returns
        ``(missing member ids, order)``: the missing on deadline, or a
        published excise order the member reads while it waits (a peer
        that consumed it first has left the cohort, so waiting out the
        deadline would only delay the same exit)."""
        own = os.path.join(bar_dir, "b%d.%d" % (s, seat))
        with open(own, "w") as f:
            f.write(str(time.time()))
        deadline = time.time() + boundary_timeout
        while True:
            missing = [q for q in range(W)
                       if not os.path.exists(
                           os.path.join(bar_dir, "b%d.%d" % (s, q)))]
            if not missing:
                return [], None
            beat()      # blocked at the boundary is not hung
            if term["flag"]:
                emergency_exit()
            order = surgery.read_order(order_path)
            if order is not None and int(order["target"]) < W:
                return missing, order
            if time.time() > deadline:
                return missing, None
            time.sleep(0.015)

    def surgery_exit(target, verdict, s, lost):
        save(s)
        save_res(final=(seat == target))
        ag = surgery.Agreement(excise=True, target=target,
                               verdict=verdict, lost=lost)
        surgery.write_exit_record(
            os.path.join(ckpt_dir, surgery.EXIT_RECORD), ag,
            world=W, process_index=seat, step=s)
        emit({"event": "surgery_exit", "t_host": round(time.time(), 3),
              "step": s, "target": target, "verdict": verdict})
        fh.flush()
        os._exit(surgery.EXIT_SURGERY)

    def end_step(s):
        """The step the cohort ends at, as far as it is known at step s."""
        if args.until_world <= 0:
            return args.steps
        if W >= args.until_world and not os.path.exists(grown_path):
            # the first member to run at the world marks the step: the
            # barrier keeps every member of this world at the same step
            try:
                fd = os.open(grown_path, os.O_WRONLY | os.O_CREAT
                             | os.O_EXCL)
                with os.fdopen(fd, "w") as f:
                    json.dump({"step": s, "world": W}, f)
            except FileExistsError:
                pass
        grown = _read_json(grown_path)
        if grown is None or "step" not in grown:
            return max(args.steps, args.max_steps)
        return max(args.steps, int(grown["step"]) + args.world_steps)

    while state["step"] < end_step(state["step"]):
        s = state["step"]
        beat()
        if term["flag"]:
            emergency_exit()
        # consume a published excise order at the boundary; a stale one
        # (target outside the already-shrunk world) is ignored
        order = surgery.read_order(order_path)
        if order is not None and int(order["target"]) < W:
            surgery_exit(int(order["target"]), order["verdict"], s,
                         lost=False)
        fold_orphans()
        missing, order = barrier(s)
        if order is not None:
            surgery_exit(int(order["target"]), order["verdict"], s,
                         lost=False)
        if missing:
            # a peer left the cohort at the boundary (its order arrived
            # first): same exit-76 path, naming the missing member
            surgery_exit(max(missing), "hang", s, lost=True)
        res = np.float32(res + np.float32(contrib(s, seat)))
        mass_in += contrib(s, seat)
        time.sleep(args.step_ms / 1000.0)
        state["step"] = s + 1
        save(s + 1)
        save_res()
        _atomic_json(progress_path, {"step": s + 1})
        emit({
            "step": s, "t_host": round(time.time(), 3),
            "loss": round(2.0 - 0.01 * s, 4),
            "grad_norm": 1.0, "payload_elems": 50.0,
            "w_clock": [10.0] * args.world,
            "w_grad_norm": [1.0] * args.world,
            "w_residual_mass": [100.0] * args.world,
            "w_sent_ratio": [0.05] * args.world,
            "straggler": 0.0, "straggler_gap": 0.0, "worker_skew": 0.1,
        })

    fold_orphans()      # catch a late-landing orphan before finishing
    save_res()
    emit({"event": "run_done", "t_host": round(time.time(), 3),
          "steps": state["step"], "world": W})
    fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
