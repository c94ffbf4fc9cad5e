"""Accuracy parity: dense SGD against DGC at ratio 0.001 with the wm5
warm-up, on ResNet-20 and W simulated workers.

Counterpart of ``scripts/accuracy_parity.py``. DGC's claim is top-1 equal
to the dense baseline's; this runs both arms on a task that neither can
saturate: class prototypes in a low-dimensional subspace of pixel space
plus isotropic noise (:func:`protos_from_draws`), so the Bayes-optimal
top-1 lies below 100%, and optionally a fraction of labels drawn anew
(:func:`batch_from_draws`). Every batch is drawn on the device from an
explicit ``torch.Generator`` (a fresh stream a step, nothing read from
disk), and the evaluation reads one fixed held-out stream, the same for
every epoch and arm. The W workers run in one process on one device
(``LocalComm``) through the port's flat engine and ``train_step``.

The arms: ``dense`` (stock ``sgd``, ``Compression.none``) and ``dgc``
(``DGCCompressor`` with ``dgc_sgd``); ``dgc_exact`` is accepted as the
same arm as ``dgc``, because the port's selection is exact at every k
(the JAX script's ``dgc`` runs an approximate top-k on the TPU); and the
JAX script's arms on the narrower wires and state: ``dgc_bf16mem`` (the
bf16 error-feedback state), ``dgc_int8`` (int8 values, error feedback
on), ``dgc_int8nofb`` (without it) and ``dgc_int8pack`` (int8 values and
bit-packed indices). The learning rate warms up over 5 epochs and then
follows a cosine over ``--epochs``, epoch-wise.

    python -m dgc_tpu_torch.accuracy_parity --arms dense,dgc --epochs 150
    python -m dgc_tpu_torch.accuracy_parity --arms dense,dgc --seeds 3 \\
        --json-out runs/parity.json

Progress goes to stderr; the last line of stdout is the JSON result (per
arm: ``final_top1``, ``mean_last3_top1``, the ``curve`` of ``(epoch,
mean loss, top1)`` and ``wall_s``; over several seeds their mean and
spread).
"""

import argparse
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from dgc_tpu_torch.compression.base import Compression
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.models import create
from dgc_tpu_torch.optim.distributed import DistributedOptimizer
from dgc_tpu_torch.optim.sgd import dgc_sgd, sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.training.lr import cosine_schedule, make_lr_schedule
from dgc_tpu_torch.training.step import (eval_step, make_flat_setup,
                                         make_flat_state, train_step)
from dgc_tpu_torch.utils.device import (resolve_device,
                                        set_reproducible_numerics)

__all__ = ["protos_from_draws", "make_protos", "batch_from_draws",
           "sample_batch", "run_arm", "main"]

#: the arms (``dgc_exact`` is ``dgc``)
ARMS = ("dense", "dgc", "dgc_exact", "dgc_bf16mem", "dgc_int8",
        "dgc_int8nofb", "dgc_int8pack")
#: images an evaluation chunk
EVAL_CHUNK = 512


def protos_from_draws(z: torch.Tensor, m: torch.Tensor, image_size: int = 32,
                      proto_scale: float = 1.0) -> torch.Tensor:
    """The class prototypes ``proto_scale * z @ (m / sqrt(d))`` as
    ``[C, image_size, image_size, 3]``, from the standard normal draws
    ``z`` [C, d] and ``m`` [d, 3 image_size**2]: classes differ only
    inside a d-dimensional subspace, so isotropic noise makes the nearest
    prototype an imperfect classifier."""
    d = z.shape[1]
    return proto_scale * (z @ (m / math.sqrt(d))).reshape(
        z.shape[0], image_size, image_size, 3)


def make_protos(gen: torch.Generator, num_classes: int, subspace_dim: int,
                image_size: int = 32, proto_scale: float = 1.0
                ) -> torch.Tensor:
    """:func:`protos_from_draws` over draws from ``gen`` (on its
    device)."""
    dev = gen.device
    z = torch.randn(num_classes, subspace_dim, generator=gen, device=dev)
    m = torch.randn(subspace_dim, image_size * image_size * 3,
                    generator=gen, device=dev)
    return protos_from_draws(z, m, image_size, proto_scale)


def batch_from_draws(protos: torch.Tensor, labels: torch.Tensor,
                     noise: torch.Tensor, sigma: float,
                     flip: Optional[torch.Tensor] = None,
                     relabels: Optional[torch.Tensor] = None):
    """``(images NHWC, labels)``: each image its label's prototype plus
    ``sigma`` times its standard normal ``noise``; where ``flip``, the
    label becomes ``relabels`` (after the image was drawn), the label
    noise that caps top-1 at ``(1 - p) + p / C``."""
    images = protos[labels] + sigma * noise
    if flip is not None:
        labels = torch.where(flip, relabels, labels)
    return images, labels


def sample_batch(protos: torch.Tensor, gen: torch.Generator, n: int,
                 sigma: float, num_classes: int, label_noise: float = 0.0):
    """One fresh batch of ``n`` from the task, drawn from ``gen`` on its
    device (:func:`batch_from_draws`)."""
    dev = gen.device
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=dev)
    noise = torch.randn((n,) + tuple(protos.shape[1:]), generator=gen,
                        device=dev)
    flip = relabels = None
    if label_noise > 0:
        flip = torch.rand(n, generator=gen, device=dev) < label_noise
        relabels = torch.randint(0, num_classes, (n,), generator=gen,
                                 device=dev)
    return batch_from_draws(protos, labels, noise, sigma, flip, relabels)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _arm(arm: str, model, lr, world: int, args):
    """The arm's compressor and distributed optimizer."""
    comm = LocalComm(world)
    if arm == "dense":
        comp = Compression.none()
        return comp, DistributedOptimizer(
            sgd(lr, momentum=0.9, weight_decay=1e-4), comp, comm)
    comp = DGCCompressor(
        args.ratio, memory=DGCSGDMemory(
            momentum=0.9,
            dtype="bfloat16" if arm == "dgc_bf16mem" else None),
        warmup_epochs=args.warmup_epochs,
        int8_values=arm.startswith("dgc_int8"),
        int8_error_feedback=arm != "dgc_int8nofb",
        packed_indices=arm == "dgc_int8pack")
    comp.initialize((n.replace(".", "/"), tuple(p.shape))
                    for n, p in model.named_parameters() if p.dim() > 1)
    return comp, DistributedOptimizer(
        dgc_sgd(lr, momentum=0.9, weight_decay=1e-4), comp, comm)


def evaluate(model, setup, state, protos, args, device) -> float:
    """Top-1 over the fixed held-out stream (``--eval-size`` images in
    chunks of 512, drawn from seed 555), with worker 0's BatchNorm
    statistics."""
    gen = _generator(device, 555)
    hits = count = 0
    for _ in range(args.eval_size // EVAL_CHUNK):
        x, y = sample_batch(protos, gen, EVAL_CHUNK, args.sigma,
                            args.classes, args.label_noise)
        c = eval_step(model, setup, state.params, state.batch_stats[:1],
                      [x.permute(0, 3, 1, 2)], [y], LocalComm(1), (1,))
        hits, count = hits + c["top1"], count + c["count"]
    return float(hits) / float(count)


def run_arm(arm: str, seed: int, protos: torch.Tensor, args,
            device) -> dict:
    """One arm at one seed: ``--epochs`` epochs of ``--train-size //
    --batch`` steps, evaluated every ``--eval-every`` epochs and after the
    last."""
    t_arm = time.time()
    W = args.workers
    bs_w = args.batch // W
    steps = args.train_size // args.batch
    model = create("resnet20", args.classes,
                   torch.Generator().manual_seed(seed)).to(device)
    lr = make_lr_schedule(args.lr, W, steps, warmup_lr_epochs=5,
                          decay=cosine_schedule(args.epochs))
    comp, dist = _arm(arm, model, lr, W, args)
    setup = make_flat_setup(model, dist)
    state = make_flat_state(model, dist, setup, device)
    gens = [torch.Generator().manual_seed(seed * 7919 + 1 + r)
            for r in range(W)]
    curve = []
    for epoch in range(args.epochs):
        if comp.warmup_compress_ratio(epoch):
            setup = make_flat_setup(model, dist)
        data = _generator(device, (seed + 77) * 100003 + epoch)
        total = torch.zeros((), device=device)
        for _ in range(steps):
            x, y = sample_batch(protos, data, args.batch, args.sigma,
                                args.classes, args.label_noise)
            xs = list(x.permute(0, 3, 1, 2).split(bs_w))
            state, loss = train_step(model, setup, dist, state, xs,
                                     list(y.split(bs_w)), gens)
            total = total + loss
        if epoch == 0:
            print(f"[{arm} s{seed}] first epoch ({time.time() - t_arm:.0f}s "
                  "incl. the kernels' first launches)", file=sys.stderr,
                  flush=True)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            loss = float(total) / steps
            acc = evaluate(model, setup, state, protos, args, device)
            curve.append((epoch, loss, acc))
            print(f"[{arm} s{seed}] epoch {epoch:3d} loss {loss:.4f} "
                  f"top1 {acc * 100:.2f}%"
                  + ("" if arm == "dense" else
                     f" ratio {comp.compress_ratio}"),
                  file=sys.stderr, flush=True)
    last3 = [a for _, _, a in curve[-3:]]
    return {"final_top1": curve[-1][2],
            "mean_last3_top1": float(np.mean(last3)),
            "curve": curve, "wall_s": round(time.time() - t_arm, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", default="dense,dgc")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--subspace", type=int, default=24)
    ap.add_argument("--sigma", type=float, default=2.0)
    ap.add_argument("--label-noise", type=float, default=0.0)
    ap.add_argument("--proto-scale", type=float, default=1.0,
                    help="scales class separation: the discriminant SNR is "
                         "~|dz|*rownorm*scale/(2*sigma)")
    ap.add_argument("--train-size", type=int, default=50176)
    ap.add_argument("--eval-size", type=int, default=8192)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128, help="global batch")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ratio", type=float, default=0.001)
    ap.add_argument("--warmup-epochs", type=int, default=5)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="run each arm at seeds seed..seed+N-1 and report "
                         "the mean and spread")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    for arm in arms:
        if arm not in ARMS:
            raise SystemExit(f"unknown arm {arm!r}; the port runs {ARMS}")
    if args.batch % args.workers or args.eval_size < EVAL_CHUNK:
        raise SystemExit("--batch must split over --workers, and "
                         f"--eval-size hold at least {EVAL_CHUNK}")
    device = resolve_device(args.device)
    set_reproducible_numerics()
    print(f"workers={args.workers} bs/worker={args.batch // args.workers} "
          f"steps/epoch={args.train_size // args.batch} sigma={args.sigma} "
          f"classes={args.classes} subspace={args.subspace} "
          f"device={device}", file=sys.stderr)
    protos = make_protos(_generator(device, 1234), args.classes,
                         args.subspace, proto_scale=args.proto_scale)
    seeds = [args.seed + i for i in range(args.seeds)]
    runs = {(a, s): run_arm(a, s, protos, args, device)
            for a in arms for s in seeds}
    results = {}
    for arm in arms:
        per_seed = {s: runs[(arm, s)] for s in seeds}
        if args.seeds == 1:
            results[arm] = per_seed[seeds[0]]
            continue
        finals = [r["mean_last3_top1"] for r in per_seed.values()]
        results[arm] = {
            "seeds": {str(s): r for s, r in per_seed.items()},
            "final_top1": float(np.mean([r["final_top1"]
                                         for r in per_seed.values()])),
            "mean_last3_top1": float(np.mean(finals)),
            "spread_last3_top1": float(np.max(finals) - np.min(finals)),
            "std_last3_top1": float(np.std(finals)),
        }
    print(json.dumps(results))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
