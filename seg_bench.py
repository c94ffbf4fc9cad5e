#!/usr/bin/env python3
"""Measurements of the segment-candidate kernels (``csrc/seg_top2.cu``) on
one card, for choosing their launch geometry.

    python3 seg_bench.py            # from the repo root, on a CUDA card

Builds a copy of ``seg_top2.cu`` under ``build/kernels/`` for each variant
of its constants (loads per thread in flight per batch, ``kScanUnroll`` for
the standalone kernel and ``kFusedUnroll`` for the fused one, and the
blocks per SM its launch bounds ask for, ``kMinBlocks``), all ``nvcc`` runs
in parallel, with each kernel's registers and spills from ``-Xptxas -v``.
The source itself is not changed. At ResNet-50's shapes (the fused pass
over T = 27,068,416, the standalone pass over the six segment buckets of
one worker's step, random state from a seed), each variant is first held
bitwise against the plain versions, then timed as ``chip_smoke.py`` times
(20 calls queued behind a spin kernel, L2-warm).

The summary goes to stdout, everything to ``chiprun_out/seg_bench.json``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

OUT = Path(__file__).resolve().parent / "chiprun_out" / "seg_bench.json"

#: (scan unroll, scan blocks per SM) of the standalone kernel
SCAN_VARIANTS = ((8, 2), (16, 1), (16, 2), (32, 1), (32, 2))
#: (fused unroll, fused blocks per SM) of the fused kernel
FUSED_VARIANTS = ((2, 2), (4, 1), (4, 2), (4, 3), (8, 1), (8, 2))


def _build_variants(variants):
    """``{tag: (library path, ptxas summary)}``, one ``nvcc`` per variant
    (``{tag: {constant: value}}``) of a patched copy of ``seg_top2.cu``,
    all started together."""
    from dgc_tpu_torch.ops import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "seg_top2.cu").read_text()
    procs = {}
    for tag, consts in variants.items():
        src = text
        for name, value in consts.items():
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise RuntimeError(f"seg_top2.cu: no constant {name}")
        cu = build.BUILD_DIR / f"seg_top2-bench-{tag}.cu"
        cu.write_text(src)
        lib = cu.with_suffix(".so")
        cmd = [build._nvcc(), *build._FLAGS, "-Xptxas", "-v",
               "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for tag, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {tag} failed:\n{log}")
        out[tag] = (lib, cs._ptxas_summary(log))
    return out


def _load(path):
    import ctypes
    from dgc_tpu_torch.ops import kernels as K
    lib = ctypes.CDLL(str(path))
    for fn, types in K._SEG_ARGS.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _fused(lib, g, m, v, bits, cv, cb):
    import torch
    from dgc_tpu_torch.ops import kernels as K
    err = lib.compensate_bits_cands_launch(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), bits.data_ptr(),
        g.shape[0], 0.9, 0, 1, cv.data_ptr(), cb.data_ptr(),
        int(m.dtype == torch.bfloat16), *K._stream_args(g))
    if err:
        raise RuntimeError(f"compensate_bits_cands_launch: CUDA error {err}")
    return m, v, cv, cb


def _alone(lib, vec, base, nseg, cv, cb):
    import torch
    from dgc_tpu_torch.ops import kernels as K
    err = lib.seg_top2_launch(
        vec.data_ptr() + vec.element_size() * base, nseg, cv.data_ptr(),
        cb.data_ptr(), int(vec.dtype == torch.bfloat16), *K._stream_args(vec))
    if err:
        raise RuntimeError(f"seg_top2_launch: CUDA error {err}")
    return cv, cb


def main(argv):
    import torch
    from dgc_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        print("seg_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    variants = {f"scan-u{u}-b{b}": {"kScanUnroll": u, "kMinBlocks": b}
                for u, b in SCAN_VARIANTS}
    variants.update({f"fused-u{u}-b{b}": {"kFusedUnroll": u, "kMinBlocks": b}
                     for u, b in FUSED_VARIANTS})
    libs = _build_variants(variants)
    dev = "cuda"
    eng = cs._geometries("resnet50_wm5", (5,))[5][1]
    T, span = eng.T, K.SEG_SPAN
    gen = torch.Generator(device=dev).manual_seed(7)
    g, m, v = (torch.randn(T, device=dev, generator=gen) for _ in range(3))
    sent = torch.randperm(T, device=dev, generator=gen)[:T // 1000].int()
    bits = K.pack_sent_bits(sent, T)
    want = K.compensate_bits_cands_plain(g, m, v, bits, 0.9)
    vec = want[1]
    buckets = [(b.base, b.rows * b.cols // span)
               for b, seg in zip(eng.buckets, eng._seg) if seg]
    cv = torch.empty((T // span, 2, 128), device=dev)
    cb = torch.empty((T // span, 2, 128), dtype=torch.int32, device=dev)
    results = {"device": smi, "T": T, "buckets": buckets, "variants": {}}
    for tag, (path, ptxas) in libs.items():
        lib = _load(path)
        row = {"ptxas": ptxas}
        if tag.startswith("fused"):
            mm, vv = m.clone(), v.clone()
            cs._check_equal(tag, _fused(lib, g, mm, vv, bits, cv, cb), want)
            row["ms"] = cs._device_ms(lambda: _fused(lib, g, mm, vv, bits,
                                                     cv, cb))
        else:
            ms = 0.0
            for base, nseg in buckets:
                s0 = base // span
                got = _alone(lib, vec, base, nseg, cv[:nseg], cb[:nseg])
                cs._check_equal(tag, got, (want[2][s0:s0 + nseg],
                                           want[3][s0:s0 + nseg]))
                ms += cs._device_ms(lambda: _alone(lib, vec, base, nseg,
                                                   cv[:nseg], cb[:nseg]))
            row["ms"] = ms
        results["variants"][tag] = row
        print(f"[seg_bench] {tag}: {row['ms']:.4f} ms ({'; '.join(ptxas)})")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(results, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
