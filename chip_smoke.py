#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; no phase's failure is caught):

1. Build every CUDA kernel of the main path from ``dgc_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and compile the Triton kernel.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes ResNet-20's DGC path gives it across the wm5 warm-up (bitwise),
   and time kernel, plain version and the PyTorch yardstick call, L2-warm:
   each time is the device time per call, 20 calls queued behind a spin
   kernel so the card runs them back to back (``ms``, also printed as
   ``kernel_ms``, is the kernel's).
3. Check the flat engine's W=4 exchange on the card against the same
   exchange on the CPU (plain versions) on one input: bitwise.
4. The main path: ResNet-20 at full width, batch 128 per worker, W=4
   ``LocalComm`` workers on the card — 3 steps at the epoch-0 ratio, the
   engine rebuild, 3 steps at 0.001. Launch counters are zeroed just
   before and read just after; every kernel must have launched.
5. One step through ``ProcessGroupComm`` on a one-rank NCCL group.

With ``--profile``, ``torch.profiler`` (device activity only) also records
three more main-path steps at ratio 0.001 between phases 4 and 5 and prints
their step times, the device time by kernel and the device's busy share of
the same window.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It trains in full f32:
TF32 is off for cuDNN and matmuls.
"""

import json
import math
import subprocess
import sys
import tempfile
import time

# H100 SXM, NVIDIA data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
DEVICE = "cuda"


def _device_ms(fn, reps=20, warmup=3, hold_cycles=20_000_000):
    """Device time per call over ``reps`` back-to-back calls. A spin
    kernel (``hold_cycles`` clocks, ~10 ms) holds the stream while the
    host queues the calls behind it, so the events measure the card
    running them with no host launch gaps (a call that waits for the
    device on the host, as ``apply_rows_plain`` does, keeps its gap)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(**fns):
    """``{key: device ms}`` for each of ``ms=kernel, plain_ms=plain,
    library_ms=library`` given."""
    return {key: _device_ms(fn) for key, fn in fns.items()}


def _bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the larger of the bytes the call must move
    over the HBM rate and its operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _geometries():
    """The flat engine's bucket geometry for ResNet-20 at every wm5
    ratio: {epoch: (compress ratio, engine)}."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression.dgc import DGCCompressor
    from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
    from dgc_tpu_torch.compression.memory import DGCSGDMemory
    from dgc_tpu_torch.models import resnet_cifar
    cc = configs.resnet20_wm5().train.compression
    comp = DGCCompressor(
        cc.compress_ratio, memory=DGCSGDMemory(cc.memory.momentum),
        sample_ratio=cc.sample_ratio, warmup_epochs=cc.warmup_epochs)
    model = resnet_cifar.resnet20()
    tree = resnet_cifar.param_tree(model)
    comp.initialize((n.replace(".", "/"), tuple(p.shape))
                    for n, p in model.named_parameters() if p.dim() > 1)
    out = {}
    for epoch in range(6):
        comp.warmup_compress_ratio(epoch)
        out[epoch] = (comp.compress_ratio,
                      FlatDGCEngine(comp, ParamLayout.for_compressor(
                          tree, comp)))
    return out


def phase_build():
    import torch
    from dgc_tpu_torch.ops import build, kernels
    t0 = time.perf_counter()
    build.build(verbose=True)
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 8192
    g = torch.zeros(n, device=DEVICE)
    kernels.compensate_bits(g, torch.zeros_like(g), torch.zeros_like(g),
                            torch.zeros(kernels.num_sent_words(n),
                                        dtype=torch.int32, device=DEVICE),
                            0.9)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"[build] nvcc {t_nvcc:.1f} s (parallel), triton {t_triton:.1f} s")


def _check_equal(name, got, want):
    import torch
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"{name}: kernel and plain version differ")
    return max((float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want)
                if a.dtype == torch.float32 and a.numel()), default=0.0)


def phase_kernels(geoms):
    """Bitwise checks and timings at the main path's shapes. Returns
    {kernel: entry} with per-call details under "calls"."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = {}

    # --- K1 compensate at T ---
    engine = geoms[5][1]
    T = engine.T
    nw = K.num_sent_words(T)
    g, m, v = (torch.randn(T, device=dev, generator=gen) for _ in range(3))
    sent = torch.randperm(T, device=dev, generator=gen)[:T // 4].int()
    bits = K.pack_sent_bits(sent, T)
    want = K.compensate_bits_plain(g, m, v, bits, 0.9, False, True)
    got = K.compensate_bits(g, m.clone(), v.clone(), bits, 0.9, False, True)
    err = _check_equal("compensate_bits", got, want)
    mm, vv = m.clone(), v.clone()
    # bytes: g, m, v read, m, v written, the record read; ops: ~5 per element
    bound_ms, bound_by = _bound(20 * T + 4 * nw, 5 * T)
    entries["compensate_bits"] = dict(
        name="compensate_bits", route="triton",
        source="dgc_tpu_torch/ops/kernels.py",
        replaces="dgc_tpu/ops/kernels.py:527",
        check="bitwise vs compensate_bits_plain", max_abs_err=err,
        **_timed(ms=lambda: K.compensate_bits(g, mm, vv, bits, 0.9),
                 plain_ms=lambda: K.compensate_bits_plain(
                     g, m, v, bits, 0.9)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        calls=[{"shape": [T], "per_worker_step": 1}])

    # --- K2 top-k: every selection and threshold call of the warm-up ---
    calls, errs = [], []
    host_gen = torch.Generator().manual_seed(1)
    for epoch, (ratio, eng) in geoms.items():
        consts = eng._bucket_consts(torch.device(dev))
        for b, c in zip(eng.buckets, consts):
            x = torch.randn(b.rows, b.cols, device=dev, generator=gen).abs()
            imp = torch.where(c["in_row"], x, -1.0)
            inputs = [("select", imp, b.max_sel)]
            if not b.exact:
                phases = torch.rand(len(b.stride_groups),
                                    generator=host_gen).tolist()
                smp = eng._sample_rows(b, c, imp, phases).contiguous()
                inputs.append(("threshold", smp, b.max_k))
            for role, inp, k in inputs:
                errs.append(_check_equal("topk_rows", K.topk_rows(inp, k),
                                         K.topk_rows_plain(inp, k)))
                R, cols = inp.shape
                # bytes: the rows read, k (value, column) pairs written;
                # ops: one comparison per element
                bound_ms, bound_by = _bound(4 * R * cols + 8 * R * k,
                                            R * cols)
                calls.append(dict(
                    epoch=epoch, ratio=ratio, role=role, shape=[R, cols],
                    k=k, **_timed(
                        ms=lambda: K.topk_rows(inp, k),
                        plain_ms=lambda: K.topk_rows_plain(inp, k),
                        library_ms=lambda: torch.topk(inp, k, dim=1)),
                    bound_ms=bound_ms, bound_by=bound_by))
    steady = [c for c in calls if c["epoch"] == 5]
    entries["topk_rows"] = dict(
        name="topk_rows", route="cuda",
        source="dgc_tpu_torch/csrc/topk_rows.cu",
        replaces="dgc_tpu/ops/kernels.py:739",
        check="bitwise vs topk_rows_plain (stable sort)",
        max_abs_err=max(errs),
        **{k: sum(c[k] for c in steady)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=steady[0]["bound_by"],
        summed_over="the calls of one worker's step at ratio 0.001",
        calls=calls)

    # --- K3 apply at W=4 on real gathered payloads, with duplicates ---
    from dgc_tpu_torch.parallel.comm import LocalComm
    world, calls, errs = 4, [], []
    for epoch in (0, 5):
        eng = geoms[epoch][1]
        common = torch.randn(eng.layout.total, device=dev, generator=gen)
        sent = []
        for w in range(world):
            # correlated workers: overlapping selections -> duplicates
            grad = common + 0.3 * torch.randn(eng.layout.total, device=dev,
                                              generator=gen)
            mem = eng.init_memory(dev)
            ph = eng.draw_phases(torch.Generator().manual_seed(w))
            sent.append(eng.compress(grad, mem, ph))
        gv = LocalComm(world).all_gather([s[0] for s in sent])[0]
        gi = LocalComm(world).all_gather([s[1] for s in sent])[0]
        S = eng.layout.sentinel
        flags = ((torch.arange(world, device=dev)[:, None] == 0)
                 & (gi != S)).reshape(-1)
        vals, idx = gv.reshape(-1), gi.reshape(-1)
        real = idx[idx != S]
        dups = int(real.numel() - torch.unique(real).numel())
        errs.append(_check_equal(
            "apply_rows", K.apply_rows(vals, idx, flags, eng.T, float(world)),
            K.apply_rows_plain(vals, idx, flags, eng.T, float(world))))
        n, nwords = vals.numel(), K.num_sent_words(eng.T)
        ilong = idx.long()
        # bytes: values, indices, flags read, acc and the record written;
        # ops: a divide and an add per entry
        bound_ms, bound_by = _bound(9 * n + 4 * eng.T + 4 * nwords, 2 * n)
        calls.append(dict(
            epoch=epoch, payload_per_worker=eng.payload_size, entries=n,
            duplicate_entries=dups,
            **_timed(
                ms=lambda: K.apply_rows(vals, idx, flags, eng.T,
                                        float(world)),
                plain_ms=lambda: K.apply_rows_plain(
                    vals, idx, flags, eng.T, float(world)),
                library_ms=lambda: torch.zeros(
                    eng.T, device=dev).index_add_(0, ilong, vals / world)),
            bound_ms=bound_ms, bound_by=bound_by))
    steady = calls[-1]
    entries["apply_rows"] = dict(
        name="apply_rows", route="cuda",
        source="dgc_tpu_torch/csrc/apply_rows.cu",
        replaces="dgc_tpu/ops/kernels.py:1743",
        check="bitwise vs apply_rows_plain (payload-order sums)",
        max_abs_err=max(errs),
        **{k: steady[k] for k in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
        calls=calls)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
        print(f"[kernel] {e['name']}: {e['ms']:.4f} ms on the device "
              f"(plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.5f})")
        print(json.dumps({"calls": e["name"], "detail": e.pop("calls")}))
    return entries


def phase_engine_vs_cpu(geoms):
    """The W=4 exchange on the card and on the CPU, same inputs: every
    output bitwise."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    for epoch in (0, 5):
        eng = geoms[epoch][1]
        outs = {}
        for dev in ("cpu", DEVICE):
            mems = [eng.init_memory(dev) for _ in range(4)]
            res = []
            for step in range(2):
                grads = [torch.randn(eng.layout.total,
                                     generator=torch.Generator().manual_seed(
                                         100 * step + w)).to(dev)
                         for w in range(4)]
                phases = [eng.draw_phases(torch.Generator().manual_seed(
                    10 * step + w)) for w in range(4)]
                res += eng.exchange(grads, mems, phases, LocalComm(4))
            res += [t for m in mems for t in m.values()]
            outs[dev] = [t.cpu() for t in res]
        _check_equal(f"engine exchange (epoch {epoch})", outs[DEVICE],
                     outs["cpu"])
    print("[engine] W=4 exchange: card == CPU bitwise at the epoch-0 and "
          "epoch-5 ratios")


def phase_main_path():
    import torch
    from dgc_tpu_torch.ops import kernels as K
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    trainer = Trainer(comm=LocalComm(4), device=DEVICE)
    K.reset_launches()
    times, losses, ratios = {}, {}, {}
    for epoch in (0, 5):
        t = []
        losses[epoch] = [float(x) for x in trainer.run_epoch(epoch, 3, t)]
        times[epoch] = t
        ratios[epoch] = trainer.compression.compress_ratio
    launches = dict(K.LAUNCHES)
    for epoch, ls in losses.items():
        if not all(math.isfinite(x) for x in ls):
            raise AssertionError(f"non-finite loss at epoch {epoch}: {ls}")
    if not bool(torch.isfinite(trainer.state.params).all()):
        raise AssertionError("non-finite parameters after the main path")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for epoch in (0, 5):
        print(f"[main] epoch {epoch} ratio {ratios[epoch]:.4g} loss "
              f"{losses[epoch]} step_s {times[epoch]}")
    print(f"[main] launches {launches}")
    return trainer, launches


def phase_profile(trainer, steps=3):
    """Over ``steps`` further steps at the last ratio, traced with
    ``torch.profiler`` on the device only (no host-side events, which
    slow the host): the step times, the device time by kernel, and the
    device's busy share (the union of kernel intervals) of the host wall
    time of that same window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    epoch = 5
    trainer.run_epoch(epoch, 1)            # warm, outside the window
    torch.cuda.synchronize()
    step_s = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_epoch(epoch, steps, step_s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    if not spans:
        raise AssertionError("profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for t0_us, t1_us in sorted(spans):
        if t1_us > end:
            busy_us += t1_us - max(t0_us, end)
            end = t1_us
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = {k: v for k, v in by_name.items()
            if any(n in k for n in ("compensate_bits_kernel",
                                    "topk_rows_kernel", "apply_rows_kernel"))}
    print(json.dumps({"profile": {
        "steps": steps, "step_s": step_s, "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / wall_ms,
        "device_kernel_ms": sum(v[0] for v in by_name.values()),
        "ported_kernels": {k[:60]: {"ms": v[0], "count": v[1]}
                           for k, v in ours.items()},
        "top": [{"kernel": k[:90], "ms": v[0], "count": v[1]}
                for k, v in rows[:20]]}}))


def phase_process_group():
    import torch
    import torch.distributed as dist
    from dgc_tpu_torch.parallel.comm import ProcessGroupComm
    from dgc_tpu_torch.train import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                world_size=1, rank=0)
        try:
            trainer = Trainer(comm=ProcessGroupComm(), device=DEVICE)
            loss = [float(x) for x in trainer.run_epoch(5, 1)]
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    if not all(math.isfinite(x) for x in loss):
        raise AssertionError(f"ProcessGroupComm step loss {loss}")
    print(f"[pg] one NCCL rank, one step: loss {loss}")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    geoms = _geometries()
    entries = phase_kernels(geoms)
    phase_engine_vs_cpu(geoms)
    trainer, launches = phase_main_path()
    if "--profile" in argv:
        phase_profile(trainer)
    del trainer
    phase_process_group()
    for name, e in entries.items():
        e["launches"] = launches[name]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
