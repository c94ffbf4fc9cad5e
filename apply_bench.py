#!/usr/bin/env python3
"""Measurements of the apply kernel (``apply_rows``) on one card.

    python3 apply_bench.py [--sweep] [--old-src PATH]   # from the repo root

Always: builds ``csrc/apply_rows.cu`` with ``-Xptxas -v`` (registers and
shared memory of each kernel) and runs ``chip_smoke.py``'s apply phase:
the planted cases through both routes and the real W=4 payloads of
ResNet-20 and ResNet-50 at the epoch-0 and epoch-5 ratios, bitwise
against ``apply_rows_plain``, with their times.

Then a ``torch.profiler`` trace of ten calls at each real shape gives
the device time of each kernel the design launches.

``--sweep`` times the two routes of the kernel (``scan``: every block
reads the whole payload; ``list``: count, scan, scatter, chunk pass)
over payload sizes at both models' T, for the crossover in
``kernels.apply_plan``.

``--old-src PATH`` times the parts of the earlier design of the apply
(the source of ``csrc/apply_rows.cu`` as of commit a0a2612, e.g.
``git show a0a2612:dgc_tpu_torch/csrc/apply_rows.cu > build/old.cu``):
the engine's prelude, the staging compare and ``where``, the stable
``torch.sort``, the value gather, the two zero-fills and its kernel,
each alone, and the whole call, at the four real shapes.

Device times per call as ``chip_smoke.py`` takes them (20 calls queued
behind a spin kernel, L2-warm). The summary goes to stdout, everything to
``chiprun_out/apply_bench.json``.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

OUT = Path(__file__).resolve().parent / "chiprun_out" / "apply_bench.json"


def _old_library(src):
    """The earlier apply kernel built from ``src`` (``apply_rows_launch``
    with its own signature)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cs._old_library(src, "apply_rows_launch",
                           [p, p, p, p, i, p, p, i, i, ctypes.c_float, i, p])


def old_breakdown(payloads, src):
    """The earlier design's parts, each timed alone, and its whole call,
    at each real shape; its result bitwise the plain version's."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    lib = _old_library(src)
    rows = []
    for p in payloads:
        vals, idx, flags, T, world = p["args"]
        eng, n = p["eng"], vals.numel()
        S, nw = eng.layout.sentinel, K.num_sent_words(T)
        gi = idx.view(4, -1)

        def prelude():
            g = torch.where((gi >= 0) & (gi < T), gi, S)
            r = torch.arange(g.shape[0], device=g.device)
            return ((r[:, None] == 0) & (g != S)).reshape(-1)

        def stage_where():
            return torch.where((vals != 0) & (idx >= 0) & (idx < T), idx, T)

        key = stage_where()
        skey, order = torch.sort(key, stable=True)
        sval = vals[order]
        acc = torch.zeros(T, device=cs.DEVICE)
        bits = torch.zeros(nw, dtype=torch.int32, device=cs.DEVICE)

        def kernel(acc=acc, bits=bits, skey=skey, sval=sval):
            dev, stream = K._stream_args(vals)
            err = lib.apply_rows_launch(
                idx.data_ptr(), flags.data_ptr(), skey.data_ptr(),
                sval.data_ptr(), n, acc.data_ptr(), bits.data_ptr(), T, 1,
                world, dev, stream)
            assert err == 0, err

        def whole():
            sk, o = torch.sort(stage_where(), stable=True)
            a = torch.zeros(T, device=cs.DEVICE)
            b = torch.zeros(nw, dtype=torch.int32, device=cs.DEVICE)
            kernel(a, b, sk, vals[o])
            return a, b

        cs._check_equal("earlier apply design", whole(),
                        K.apply_rows_plain(*p["args"]))
        rows.append(dict(model=p["model"], epoch=p["epoch"], entries=n,
                         T=T, **cs._timed(
                             prelude=prelude, stage_where=stage_where,
                             sort=lambda: torch.sort(key, stable=True),
                             gather=lambda: vals[order],
                             zeros_acc=lambda: torch.zeros(
                                 T, device=cs.DEVICE),
                             zeros_bits=lambda: torch.zeros(
                                 nw, dtype=torch.int32, device=cs.DEVICE),
                             kernel=kernel, whole=whole,
                             new=lambda: K.apply_rows(*p["args"]))))
    return rows


def route_sweep(T_by_model, sizes=(256, 512, 1024, 2048, 4096, 8192,
                                   16384, 32768)):
    """Both routes' device time over payloads of ``sizes`` random entries
    (4 workers' worth of duplicates: n / 4 distinct indices, each 4 times,
    the first copies flagged) at each model's T; the scan route only where
    its shared memory holds n."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=cs.DEVICE).manual_seed(7)
    rows = []
    for model, T in T_by_model.items():
        for n in sizes:
            idx = torch.randperm(T, device=cs.DEVICE, generator=gen)[
                :n // 4].int().repeat(4)
            vals = torch.randn(n, device=cs.DEVICE, generator=gen)
            flags = torch.zeros(n, dtype=torch.bool, device=cs.DEVICE)
            flags[: n // 4] = True
            args = (vals, idx, flags, T, 4.0)
            want = K.apply_rows_plain(*args)
            row = dict(model=model, T=T, entries=n,
                       planned=K.apply_plan(n, T).route)
            for route in cs._apply_routes(n):
                plan = K.apply_plan(n, T, route)
                cs._check_equal(f"sweep {route}",
                                K._apply_rows_launch(*args, plan), want)
                row[f"{route}_ms"] = cs._device_ms(
                    lambda: K._apply_rows_launch(*args, plan))
            rows.append(row)
    return rows


def kernel_profile(payloads, calls=10):
    """Device time per call of each kernel the new design launches (the
    list route's passes apart), from ``torch.profiler``, at each real
    shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dgc_tpu_torch.ops import kernels as K
    rows = []
    for p in payloads:
        K.apply_rows(*p["args"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                K.apply_rows(*p["args"])
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.replace("void ", "").split("(")[0][-48:]
                by[name] = by.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / calls
        rows.append(dict(model=p["model"], epoch=p["epoch"],
                         entries=p["args"][0].numel(), ms_by_kernel=by))
    return rows


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("apply_bench: no CUDA device", file=sys.stderr)
        return 2
    from dgc_tpu_torch.ops import build
    build.build(["apply_rows.cu"], verbose=True)
    geoms = cs._geometries(epochs=(0, 5))
    geoms50 = cs._geometries("resnet50_wm5", (0, 5))
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
    out = {"apply_rows": cs.phase_apply_kernel(geoms, geoms50, gen)}
    if "--sweep" in argv:
        out["sweep"] = route_sweep({"resnet20": geoms[5][1].T,
                                    "resnet50": geoms50[5][1].T})
        for r in out["sweep"]:
            print("[sweep]", json.dumps(r))
    payloads = cs._apply_payloads(geoms, geoms50, gen)
    out["profile"] = kernel_profile(payloads)
    for r in out["profile"]:
        print("[profile]", json.dumps(r))
    if "--old-src" in argv:
        src = argv[argv.index("--old-src") + 1]
        out["old_design"] = old_breakdown(payloads, src)
        for r in out["old_design"]:
            print("[old]", json.dumps(r))
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
