#!/usr/bin/env python3
"""Measurements of the top-k kernel (``topk_rows``) on one card, for
sizing ``kernels.topk_plan``.

    python3 topk_bench.py            # from the repo root, on a CUDA card

At each of the 44 call shapes the DGC paths give the kernel (ResNet-20
across the wm5 warm-up, ResNet-50 at the epoch-0 and epoch-5 ratios;
random |x| rows from a seed), every geometry of the sweep: the sort route
(rows of at most 16,384 columns) at one thread for every two or four
columns; the block route at 256-1,024 threads a row; the cluster route
at 2, 4 and 8 blocks a row of 512 and 1,024 threads (rows of at least
8,192 columns); where k needs at least 256 sort words, each also with
the other sort of the survivors (radix or bitonic). Each is first held bitwise against ``topk_rows_plain``; then
its device time per call, as
``chip_smoke.py`` takes it (20 calls queued behind a spin kernel,
L2-warm), beside the planner's own choice and ``torch.topk``.

The summary goes to stdout, everything to ``chiprun_out/topk_bench.json``.
"""

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

OUT = Path(__file__).resolve().parent / "chiprun_out" / "topk_bench.json"

#: (rows, cols, k) of the paths' calls (tests/test_torch_topk_plan.py)
PATH_SHAPES = [
    (6, 36864, 11658), (6, 384, 121), (16, 9216, 2915), (16, 95, 31),
    (6, 36864, 3687), (6, 384, 38), (16, 9216, 922), (16, 95, 10),
    (6, 36864, 1166), (6, 384, 13), (16, 9216, 292), (16, 512, 17),
    (6, 36864, 369), (6, 384, 4), (16, 9216, 93), (16, 640, 7),
    (6, 36864, 117), (6, 768, 3), (16, 9216, 30), (16, 4608, 15),
    (6, 36864, 37), (6, 2176, 3), (16, 9216, 10),
    (3, 24448, 7692), (2, 21632, 6837), (5, 10880, 3419), (8, 6144, 1923),
    (17, 2816, 855), (11, 768, 214), (8, 16384, 5182), (8, 256, 54),
    (3, 18432, 2360), (3, 24448, 25), (2, 16384, 2098), (2, 21632, 22),
    (5, 8192, 1049), (5, 10880, 11), (8, 5120, 590), (8, 6144, 7),
    (17, 2048, 263), (17, 2816, 3), (11, 512, 66), (11, 3712, 4),
    (8, 16384, 17)]


def _geometries(R, cols, k):
    from dgc_tpu_torch.ops import kernels as K
    out = []
    if cols <= K.TOPK_MAX_K:
        half = min(1024, max(32, K._pow2_ceil(cols) // 2))
        for t in {half, max(32, half // 2)}:
            out.append(K.topk_geometry(R, cols, k, "sort", 1, t))
    for t in (256, 512, 1024):
        out.append(K.topk_geometry(R, cols, k, "block", 1, t))
    if cols >= 8192:
        for c in (2, 4, 8):
            for t in (512, 1024):
                out.append(K.topk_geometry(R, cols, k, "cluster", c, t))
    # the other sort of the survivors, where it would not be the default
    out += [K.topk_geometry(R, cols, k, p.route, p.cluster, p.threads,
                            not p.radix)
            for p in list(out) if p.route != "sort" and p.padded >= 256]
    return [p for p in out if p.smem_bytes <= K._SMEM_MAX]


def _name(p):
    return (f"{p.route} c{p.cluster} t{p.threads}"
            + (" radix" if p.radix else "")
            + ("" if p.staged else " unstaged"))


def main(argv):
    import torch
    from dgc_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        print("topk_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, sums = [], {"plan": 0.0, "best": 0.0, "library": 0.0}
    for R, cols, k in PATH_SHAPES:
        x = torch.randn(R, cols, device="cuda", generator=gen).abs()
        want = K.topk_rows_plain(x, k)
        plan = K.topk_plan(R, cols, k)
        row = {"shape": [R, cols], "k": k, "plan": _name(plan),
               "plan_ms": cs._device_ms(lambda: K.topk_rows(x, k)),
               "library_ms": cs._device_ms(lambda: torch.topk(x, k, dim=1)),
               "sweep": {}}
        for p in _geometries(R, cols, k):
            cs._check_equal(f"topk {_name(p)} [{R}, {cols}] k={k}",
                            K._topk_rows_launch(x, k, p), want)
            row["sweep"][_name(p)] = cs._device_ms(
                lambda: K._topk_rows_launch(x, k, p))
        best = min(row["sweep"], key=row["sweep"].get)
        row["best"], row["best_ms"] = best, row["sweep"][best]
        sums["plan"] += row["plan_ms"]
        sums["best"] += min(row["best_ms"], row["plan_ms"])
        sums["library"] += row["library_ms"]
        rows.append(row)
        print(f"[{R}, {cols}] k={k}: plan {row['plan']} "
              f"{row['plan_ms'] * 1e3:.1f} us, best {best} "
              f"{row['best_ms'] * 1e3:.1f}, torch.topk "
              f"{row['library_ms'] * 1e3:.1f}", flush=True)
    print(f"[sums, ms] {json.dumps(sums)}")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"device": smi, "sums_ms": sums,
                               "shapes": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
