#!/usr/bin/env python3
"""Run-to-run reproducibility of the port's training on one card, and
what cuDNN's deterministic algorithms cost.

    python3 repro_bench.py            # from the repo root, on a CUDA card

1. Bisect. ResNet-20 (flat engine, default route, W=4 ``LocalComm``
   workers on the card) trains 2 steps at the epoch-0 ratio twice from
   one seed, with ``torch.backends.cudnn.deterministic`` off (PyTorch's
   default) and then twice with it on (``benchmark`` off and TF32 off
   throughout). Each run records, per step: every worker's loss (the
   forward) and flat gradient (the backward), the exchanged gradients
   (the exchange), then the parameters, the optimizer's momentum (the
   update) and every worker's memory. Between two runs it reports the
   first record that differs, and, where that is a gradient, the
   parameters whose gradients differ.
2. Cost. Step times of ResNet-20 (batch 128 per worker) and ResNet-50
   (224x224, batch 32 per worker), W=4 on the card, at the epoch-5 ratio,
   with the switch off and on in turns (off, on, on, off), each after a
   warm step: host clock around each step, which ends in
   ``torch.cuda.synchronize``.

The summary goes to stdout, everything to ``chiprun_out/repro_bench.json``.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent / "chiprun_out" / "repro_bench.json"


def _tensors(obj):
    import torch
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _trainer(recipe, deterministic):
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = deterministic
    return Trainer(configs.RECIPES[recipe](), comm=LocalComm(4),
                   device="cuda")


def record_run(deterministic, recipe="resnet20_wm5", epoch=0, steps=2):
    """One run's records: ``[(step, stage, name, cpu tensor)]``."""
    import torch
    from dgc_tpu_torch.training import step as step_mod
    trainer = _trainer(recipe, deterministic)
    layout = trainer.setup.layout
    out, step = [], [0]
    worker_grad = step_mod.worker_grad
    update_flat = trainer.dist.update_flat

    def recording_grad(*args, **kw):
        g, loss = worker_grad(*args, **kw)
        w = sum(1 for r in out if r[0] == step[0] and r[1] == "forward")
        out.append((step[0], "forward", f"loss w{w}", loss.detach().cpu()))
        out.append((step[0], "backward", f"grad w{w}", g.detach().cpu()))
        return g, loss

    def recording_update(*args, **kw):
        params, opt_state, exchanged = update_flat(*args, **kw)
        out.extend((step[0], "exchange", f"exchanged w{w}", t.cpu())
                   for w, t in enumerate(exchanged))
        out.append((step[0], "update", "params", params.cpu()))
        out.extend((step[0], "update", "momentum", t.cpu())
                   for t in _tensors(opt_state))
        out.extend((step[0], "memory", f"w{w} {k}", t.cpu())
                   for w, m in enumerate(trainer.state.memory)
                   for k, t in m.items())
        step[0] += 1
        return params, opt_state, exchanged

    step_mod.worker_grad = recording_grad
    trainer.dist.update_flat = recording_update
    try:
        trainer.run_epoch(epoch, steps)
        torch.cuda.synchronize()
    finally:
        step_mod.worker_grad = worker_grad
    return out, layout


def compare(a, b, layout):
    """The first record where runs ``a`` and ``b`` differ (bitwise), the
    number of records that differ, and for a gradient the parameters
    whose part differs."""
    import torch
    first, n_diff = None, 0
    for (step, stage, name, x), (_, _, _, y) in zip(a, b):
        same = torch.equal(x.view(torch.int32), y.view(torch.int32)) \
            if x.dtype == torch.float32 else torch.equal(x, y)
        if same:
            continue
        n_diff += 1
        if first is None:
            first = {"step": step, "stage": stage, "record": name,
                     "max_abs_diff": float((x.double() - y.double()).abs()
                                           .max())}
            if x.numel() == layout.total:
                gx, gy = layout.unflatten_named(x), layout.unflatten_named(y)
                first["params_that_differ"] = [
                    n for n in gx if not torch.equal(gx[n], gy[n])]
                first["params_equal"] = len(gx) - len(
                    first["params_that_differ"])
    return {"first_difference": first, "records_that_differ": n_diff,
            "records": len(a)}


def step_times(recipe, deterministic, steps):
    import torch
    trainer = _trainer(recipe, deterministic)
    trainer.run_epoch(5, 1)                 # warm, outside the timing
    t = []
    trainer.run_epoch(5, steps, t)
    del trainer
    torch.cuda.empty_cache()
    return [x * 1e3 for x in t]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("repro_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"device": smi, "bisect": {}, "step_ms": {}}
    for det in (False, True):
        a, layout = record_run(det)
        b, _ = record_run(det)
        res["bisect"][f"deterministic={det}"] = r = compare(a, b, layout)
        print(f"[bisect] cudnn.deterministic={det}: {r['records_that_differ']}"
              f" of {r['records']} records differ; first: "
              f"{json.dumps(r['first_difference'])[:600]}")
    for recipe, steps in (("resnet20_wm5", 6), ("resnet50_wm5", 3)):
        runs = {False: [], True: []}
        for det in (False, True, True, False):
            runs[det] += step_times(recipe, det, steps)
        res["step_ms"][recipe] = {
            f"deterministic={d}": {"median": statistics.median(v),
                                   "steps": v} for d, v in runs.items()}
        med = {d: statistics.median(v) for d, v in runs.items()}
        print(f"[cost] {recipe} W=4 epoch 5: step median "
              f"{med[False]:.2f} ms deterministic off, {med[True]:.2f} ms on "
              f"({med[True] / med[False]:.3f}x; {2 * steps} steps each)")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
