"""Training harness: a recipe of :mod:`dgc_tpu_torch.configs` —
ResNet-20 or ResNet-110 on CIFAR-10 (``resnet20_wm5`` is the default),
ResNet-50 or ResNet-18 on ImageNet; with DGC and its warm-up, or the
dense baseline.

Counterpart of the repository's ``train.py`` for the port. ``Trainer``
builds the config's dataset (synthetic when no data root exists), model,
compressor (``train.dgc``: ``DGCCompressor`` over ``DGCSGDMemory``, else
the dense ``Compression.none``), learning-rate schedule, optimizer
(``dgc_sgd``, or stock ``sgd`` for the dense baseline; nesterov and the
BatchNorm weight-decay split as the config says) behind the distributed
optimizer, and the flat state; :meth:`Trainer.run_epoch` applies the
warm-up schedule (rebuilding the engine when the ratio changes) and runs
the epoch's steps; :meth:`Trainer.evaluate` runs the config's top-k
meters over a split. The CLI evaluates before training and after each
epoch, printing ``[acc/test_top1] = ...`` lines as the JAX harness does
and keeping the best top-1; ``--evaluate`` only evaluates.

Workers: ``--world W`` simulates W workers on one device in lockstep
(``LocalComm``). Under ``torchrun`` or Slurm, or with the launch scripts'
``JAX_COORDINATOR_ADDRESS`` triple, each process is one worker of a
``torch.distributed`` group (:func:`~dgc_tpu_torch.parallel.multihost.
initialize_multihost`: NCCL on the card, gloo when ``--device cpu``); so
it is with ``--init-method`` and ``--rank``, and ``--world`` is then the
group size.

The run lifecycle is the JAX harness's: the experiment directory is
:func:`get_save_path` over the recipe's config files
(``configs.CONFIG_FILES``) plus ``--suffix`` and ``.np<world>``, under
``runs/`` in the working directory. Every epoch is saved to its
``checkpoints`` (:class:`~dgc_tpu_torch.training.checkpoint.
CheckpointManager`: parameters, optimizer state, every worker's memory,
BatchNorm statistics and sampling generator; ``best`` when the metric
improved); a restarted run resumes after the newest saved epoch with the
best metric restored, and continues as the uninterrupted run would,
bitwise. ``--evaluate`` restores ``best`` and only evaluates (the initial
weights when nothing was saved). ``metrics.jsonl`` gets ``loss/train``
every 50 steps and at an epoch's last, and the epoch's meters, at x =
samples seen; ``--profile`` writes a ``torch.profiler`` trace of the first
8 steps of the first epoch trained to ``<save_path>/profile``.

Input: a background thread prepares each batch (:class:`~dgc_tpu_torch.
data.native.Prefetcher`) into pinned host memory on the card, and each
worker's block is uploaded on a side stream one step ahead of the step
that reads it (:meth:`Trainer.epoch_inputs`).

    python -m dgc_tpu_torch.train --device cpu --world 2 --steps 2 \\
        --epochs 1 --batch-size 8 --synthetic-size 64
    python -m dgc_tpu_torch.train --config resnet50_wm5 --device cpu \\
        --world 2 --epochs 1 --steps 1 --batch-size 2 --image-size 32 \\
        --synthetic-size 16
    python -m dgc_tpu_torch.train --config resnet20 --device cpu \\
        --evaluate --batch-size 8 --synthetic-size 64
    torchrun --standalone --nproc_per_node=2 -m dgc_tpu_torch.train \\
        --config resnet20_wm5 --epochs 1 --steps 2

``--image-size`` only shrinks the synthetic images (for CPU runs), as the
JAX harness's ``--dataset.image_size`` override does. ``--megakernel`` and
``--fused-select`` turn on the compressor's fused routes, as the JAX
harness's ``--train.compression.megakernel True`` and
``--train.compression.fused_select True`` do (the ``*_megakernel`` recipes
are their base recipes with ``--megakernel``).
"""

import argparse
import contextlib
import itertools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgc_tpu_torch import configs as _configs
from dgc_tpu_torch.compression.base import Compression
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.data.datasets import CIFAR, ImageNet
from dgc_tpu_torch.data.native import Prefetcher, stage_ahead
from dgc_tpu_torch.data.sampler import epoch_batches, num_steps_per_epoch
from dgc_tpu_torch.models import create, param_tree
from dgc_tpu_torch.optim.distributed import DistributedOptimizer
from dgc_tpu_torch.optim.sgd import dgc_sgd, sgd
from dgc_tpu_torch.parallel.comm import Comm, LocalComm, ProcessGroupComm
from dgc_tpu_torch.parallel.multihost import initialize_multihost
from dgc_tpu_torch.training import checkpoint
from dgc_tpu_torch.training.checkpoint import CheckpointManager
from dgc_tpu_torch.training.lr import (cosine_schedule, make_lr_schedule,
                                       multistep_schedule)
from dgc_tpu_torch.training.step import (eval_step, make_flat_setup,
                                         make_flat_state, train_step)
from dgc_tpu_torch.utils import profiling
from dgc_tpu_torch.utils.device import (resolve_device,
                                        set_reproducible_numerics)
from dgc_tpu_torch.utils.logging import MetricWriter, printr
from dgc_tpu_torch.utils.meters import TopKClassMeter

__all__ = ["Trainer", "main", "get_save_path"]

#: steps of the first trained epoch that ``--profile`` traces
PROFILE_STEPS = 8


def get_save_path(*config_paths, prefix="runs"):
    """The experiment directory of a set of config files, as the JAX
    harness names it: ``configs/cifar/resnet20.py`` +
    ``configs/dgc/wm5.py`` -> ``runs/cifar.resnet20+dgc.wm5`` (siblings
    joined by ``+``, without the reference's brackets)."""
    memo = {}
    for c in config_paths:
        node = memo
        for m in c.replace("configs/", "").replace(".py", "").split("/"):
            node = node.setdefault(m, {})

    def fmt(m):
        return "+".join(k + ("." + fmt(v) if v else "")
                        for k, v in m.items())

    return os.path.join(prefix, fmt(memo))


class _HostBatches:
    """``split``'s batches as tensors, copied into pinned host memory when
    ``pin`` (run on the prefetch thread)."""

    def __init__(self, split, pin: bool):
        self.split, self.pin = split, pin

    def get_batch(self, idx):
        images, labels = self.split.get_batch(idx)
        images, labels = torch.from_numpy(images), torch.from_numpy(labels)
        if self.pin:
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels


class Trainer:
    """The harness's state for one run; see the module docstring."""

    def __init__(self, cfg=None, comm: Optional[Comm] = None,
                 device="cuda", verbose: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or _configs.resnet20_wm5()
        self.comm = comm = comm or LocalComm(1)
        self.verbose = verbose
        tc = cfg.train
        self.seed = cfg.seed
        dc = cfg.dataset
        self.dataset = {"cifar": CIFAR, "imagenet": ImageNet}[dc.name](
            dc.root, dc.num_classes, dc.image_size,
            synthetic_size=dc.synthetic_size)
        self.nbps = tc.num_batches_per_step
        self.bs = tc.batch_size
        self.global_batch = comm.world * self.nbps * self.bs

        # initialised on the host, so every device starts from one weights
        self.model = create(cfg.model.name, cfg.model.num_classes,
                            torch.Generator().manual_seed(self.seed),
                            cfg.model.zero_init_residual).to(self.device)

        cc = tc.compression
        if tc.dgc:
            mc = cc.memory
            self.compression = DGCCompressor(
                cc.compress_ratio,
                memory=DGCSGDMemory(mc.momentum, nesterov=mc.nesterov,
                                    momentum_masking=mc.momentum_masking),
                sample_ratio=cc.sample_ratio,
                strided_sample=cc.strided_sample,
                compress_upper_bound=cc.compress_upper_bound,
                compress_lower_bound=cc.compress_lower_bound,
                max_adaptation_iters=cc.max_adaptation_iters,
                resample=cc.resample, warmup_epochs=cc.warmup_epochs,
                warmup_coeff=cc.warmup_coeff,
                fused_select=cc.fused_select, megakernel=cc.megakernel,
                verbose=verbose)
            self.compression.initialize(
                (n.replace(".", "/"), tuple(p.shape))
                for n, p in self.model.named_parameters() if p.dim() > 1)
        else:
            self.compression = getattr(Compression, cc.name)()

        self.steps_per_epoch = num_steps_per_epoch(
            len(self.dataset["train"]), self.global_batch,
            drop_last=self.nbps > 1)
        oc, sc = tc.optimizer, tc.scheduler
        decay = (cosine_schedule(sc.t_max) if sc.name == "cosine"
                 else multistep_schedule(sc.milestones, sc.gamma))
        lr = make_lr_schedule(
            scaled_lr=oc.lr * self.nbps * comm.world, world_size=comm.world,
            num_steps_per_epoch=self.steps_per_epoch,
            warmup_lr_epochs=tc.warmup_lr_epochs, decay=decay,
            schedule_lr_per_epoch=tc.schedule_lr_per_epoch)
        wd_mask = None
        if tc.optimize_bn_separately:
            # BatchNorm parameters get no weight decay: a 0/1 mask over [P]
            wd_mask = ParamLayout.for_compressor(
                param_tree(self.model), self.compression).mask_vector(
                    lambda n: "BatchNorm" not in n, device=self.device)
        self.dist = DistributedOptimizer(
            (dgc_sgd if tc.dgc else sgd)(
                lr, momentum=oc.momentum, weight_decay=oc.weight_decay,
                nesterov=oc.nesterov, weight_decay_mask=wd_mask),
            self.compression, comm)
        self.setup = make_flat_setup(self.model, self.dist)
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device)
        #: one host generator of sampling phases per local worker
        self.gens = [torch.Generator().manual_seed(self.seed * 7919 + 1 + r)
                     for r in comm.ranks]
        self._built_ratio = None
        self._upload_stream = None

    @property
    def topology(self) -> Dict[str, int]:
        """What a checkpoint must have been written under to restore
        here: processes, workers, the two-tier group size (1: the port
        has no two-tier exchange)."""
        return {"process_count": (dist.get_world_size()
                                  if dist.is_initialized() else 1),
                "world": self.comm.world, "num_local_workers": 1}

    def save_checkpoint(self, ckpt: CheckpointManager, epoch: int,
                        meters: Dict[str, float], best: bool = False) -> str:
        """Save this process's part of the state after ``epoch`` (every
        process of a group calls this)."""
        rep, workers = checkpoint.state_tensors(self.state, self.gens,
                                                self.comm.ranks)
        return ckpt.save(epoch, rep, workers, meters, best=best,
                         topology=self.topology)

    def restore_checkpoint(self, ckpt: CheckpointManager,
                           best: bool = False
                           ) -> Optional[Tuple[int, Dict[str, float]]]:
        """Restore the newest loadable epoch (``best``: the best one) into
        the state and the generators; ``(epoch, meters)``, or None when
        there is nothing to restore."""
        rep, workers = checkpoint.state_tensors(
            self.state, self.gens, self.comm.ranks, host=False)
        out = ckpt.restore(rep, workers, best=best, topology=self.topology)
        if out is None:
            return None
        rep, workers, epoch, meters = out
        self.state = checkpoint.load_state_tensors(
            self.state, self.gens, self.comm.ranks, rep, workers)
        return epoch, meters

    def load_flat(self, flat_params: torch.Tensor,
                  flat_stats: torch.Tensor) -> None:
        """Replace the initial weights (e.g. with ones carried from the
        JAX package); call before the first step."""
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device, flat_params, flat_stats)

    def _batches(self, idx: np.ndarray, split: str = "train",
                 per: Optional[int] = None):
        """This process's workers' blocks of one global batch, on the
        device (``per`` examples a worker; a training step's by
        default)."""
        images, labels = self.dataset[split].get_batch(idx)
        per = per or self.nbps * self.bs
        xs, ys = [], []
        for r in self.comm.ranks:
            x = torch.from_numpy(images[r * per:(r + 1) * per])
            y = torch.from_numpy(labels[r * per:(r + 1) * per])
            xs.append(x.to(self.device).permute(0, 3, 1, 2))
            ys.append(y.to(self.device, torch.int64))
        return xs, ys

    def _stage(self, batch):
        """One global batch's blocks of this process's workers, ``(xs,
        ys, ready)``: on the card uploaded on the side stream, non-blocking
        from pinned memory, with ``ready`` the event that ends the upload
        (the caching host allocator keeps a pinned block from reuse until
        its copy is done); on the CPU the tensors themselves and no
        event."""
        images, labels = batch
        per = self.nbps * self.bs
        blocks = [(images[r * per:(r + 1) * per],
                   labels[r * per:(r + 1) * per]) for r in self.comm.ranks]
        if self.device.type != "cuda":
            return ([x.permute(0, 3, 1, 2) for x, _ in blocks],
                    [y.to(torch.int64) for _, y in blocks], None)
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._upload_stream):
            xs = [x.to(self.device, non_blocking=True).permute(0, 3, 1, 2)
                  for x, _ in blocks]
            ys = [y.to(self.device, non_blocking=True).to(torch.int64)
                  for _, y in blocks]
            ready = torch.cuda.Event()
            ready.record()
        return xs, ys, ready

    def epoch_inputs(self, epoch: int, steps: Optional[int] = None):
        """The inputs of ``epoch``'s steps (at most ``steps``) for this
        process's workers, ``(images, labels)`` lists on the device: the
        batches of ``epoch_batches``, prepared on a background thread and
        uploaded one step ahead (:func:`stage_ahead`, depth 1), each
        ordered before the step that reads it by its upload's event (and
        its device memory held for that step's stream). Only the batches
        of those steps are prepared, so a split's augmentation draws as
        many as inline batches would."""
        split = self.dataset["train"]
        it = epoch_batches(len(split), self.global_batch, epoch,
                           seed=self.seed, drop_last=self.nbps > 1)
        if steps is not None:
            it = itertools.islice(it, steps)
        host = _HostBatches(split, pin=self.device.type == "cuda")
        with Prefetcher(host, it) as batches:
            for xs, ys, ready in stage_ahead(batches, self._stage):
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for t in xs + ys:
                        t.record_stream(stream)
                yield xs, ys

    def run_epoch(self, epoch: int, steps: Optional[int] = None,
                  step_times: Optional[List[float]] = None,
                  profile_dir: Optional[str] = None) -> List[torch.Tensor]:
        """Train ``epoch`` (at most ``steps`` steps). Returns the mean
        losses, still on the device. With ``step_times``, each step is
        synchronised and its wall time appended (seconds). With
        ``profile_dir``, the first :data:`PROFILE_STEPS` steps are traced
        there (:func:`~dgc_tpu_torch.utils.profiling.trace`)."""
        self.compression.warmup_compress_ratio(epoch)
        ratio = self.compression.compress_ratio
        if ratio != self._built_ratio:
            # new ratio -> new engine geometry; layouts and memory carry over
            self.setup = make_flat_setup(self.model, self.dist)
            self._built_ratio = ratio
            if self.verbose and ratio is not None:
                print(f"[epoch {epoch}] ratio {self._built_ratio:.4g}: "
                      f"payload {self.setup.engine.payload_size}/worker")
        losses = []
        inputs = self.epoch_inputs(epoch, steps)
        with contextlib.closing(inputs), contextlib.ExitStack() as prof:
            if profile_dir is not None:
                prof.enter_context(profiling.trace(profile_dir))
            for s, (xs, ys) in enumerate(inputs):
                t0 = time.perf_counter()
                self.state, loss = train_step(
                    self.model, self.setup, self.dist, self.state, xs, ys,
                    self.gens, self.nbps)
                if step_times is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    step_times.append(time.perf_counter() - t0)
                losses.append(loss)
                if s + 1 == PROFILE_STEPS:
                    prof.close()
        return losses

    def evaluate(self, split: str = "test") -> Dict[str, float]:
        """The config's meters over ``split`` (``{"acc/test_top1": %,
        ...}``): batches of ``world x batch_size`` in order, each worker
        its block of each batch with its own BatchNorm statistics, the
        last batch wrap-padded as the reference's sampler pads it."""
        ds = self.dataset[split]
        meters = {key.format(split): TopKClassMeter(m.k)
                  for key, m in self.cfg.train.meters.items()}
        topk = tuple(sorted({m.k for m in meters.values()}))
        totals = None
        for idx in epoch_batches(len(ds), self.comm.world * self.bs, 0,
                                 shuffle=False):
            xs, ys = self._batches(idx, split, self.bs)
            counts = eval_step(self.model, self.setup, self.state.params,
                               self.state.batch_stats, xs, ys, self.comm,
                               topk)
            # summed on the device: one host sync after the last batch
            totals = counts if totals is None else {
                k: totals[k] + v for k, v in counts.items()}
        if totals is not None:
            n = int(totals["count"])
            for meter in meters.values():
                meter.update_counts(int(totals[f"top{meter.k}"]), n)
        return {k: m.compute() for k, m in meters.items()}


def _print_meters(meters: Dict[str, float]) -> None:
    for k, v in meters.items():
        printr(f"[{k}] = {v:.2f}")


def main(argv=None) -> List[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="resnet20_wm5",
                   choices=sorted(_configs.RECIPES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--world", type=int, default=1,
                   help="workers (LocalComm), or the group size with "
                        "--init-method")
    p.add_argument("--init-method", default=None,
                   help="torch.distributed init URL: one worker per process")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="at most this many steps per epoch")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic-size", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="side of the synthetic images (small for CPU runs)")
    p.add_argument("--megakernel", action="store_true",
                   help="compensate and select through the forward "
                        "megakernel where it applies")
    p.add_argument("--fused-select", action="store_true",
                   help="select through the select-and-pack kernel where "
                        "it applies")
    p.add_argument("--evaluate", action="store_true",
                   help="restore the best checkpoint and only evaluate it "
                        "on the test split")
    p.add_argument("--suffix", default="",
                   help="appended to the experiment directory's name")
    p.add_argument("--profile", action="store_true",
                   help="trace the first steps of the first epoch trained "
                        "to <save_path>/profile")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_reproducible_numerics()
    cfg = _configs.RECIPES[args.config]()
    if args.image_size:
        cfg.dataset.image_size = args.image_size
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    if args.synthetic_size:
        cfg.dataset.synthetic_size = args.synthetic_size
    if args.megakernel:
        cfg.train.compression.megakernel = True
    if args.fused_select:
        cfg.train.compression.fused_select = True
    if args.init_method:
        if device.type == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=args.init_method,
                                world_size=args.world, rank=args.rank)
        grouped = True
    else:
        # torchrun, Slurm or the launch scripts' triple; none: one process
        grouped = initialize_multihost(device)
    if grouped:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        comm = ProcessGroupComm()
        if args.world not in (1, comm.world):
            raise SystemExit(f"--world {args.world} but the process group "
                             f"has {comm.world} processes")
        printr(f"[multihost] {comm.world} processes over "
               f"{dist.get_backend()}")
    else:
        comm = LocalComm(args.world)
    try:
        trainer = Trainer(cfg, comm, device, verbose=True)
        save_path = (get_save_path(*_configs.CONFIG_FILES[args.config])
                     + f"{args.suffix}.np{comm.world}")
        printr(f"[train.save_path] = {save_path}")
        ckpt = CheckpointManager(os.path.join(save_path, "checkpoints"))
        metric = cfg.train.metric
        last_epoch, best = -1, None
        restored = (trainer.restore_checkpoint(ckpt, best=args.evaluate)
                    if args.evaluate or ckpt.latest_epoch() is not None
                    else None)
        if restored is not None:
            last_epoch, saved = restored
            best = saved.get(metric + "_best")
            printr(f"\n[resumed] epoch {last_epoch}, best {best}")
        else:
            printr("\n==> train from scratch")
        # the sanity eval before training, as the reference runs it
        _print_meters(trainer.evaluate())
        if args.evaluate:
            return []
        out: List[float] = []
        epochs = (args.epochs if args.epochs is not None
                  else cfg.train.num_epochs)
        writer = MetricWriter(save_path)
        try:
            for epoch in range(last_epoch + 1, epochs):
                times: List[float] = []
                profile_dir = (os.path.join(save_path, "profile")
                               if args.profile and epoch == last_epoch + 1
                               else None)
                losses = [float(x) for x in trainer.run_epoch(
                    epoch, args.steps, times, profile_dir=profile_dir)]
                # x = samples seen, counting every earlier epoch whole
                seen = epoch * trainer.steps_per_epoch * trainer.global_batch
                for s, loss in enumerate(losses):
                    seen += trainer.global_batch
                    if s % 50 == 0 or s == len(losses) - 1:
                        writer.add_scalar("loss/train", loss, seen)
                out += losses
                meters = trainer.evaluate()
                is_best = best is None or best < meters[metric]
                if is_best:
                    best = meters[metric]
                meters[metric + "_best"] = best
                _print_meters(meters)
                for k, v in meters.items():
                    writer.add_scalar(k, v, seen)
                path = trainer.save_checkpoint(ckpt, epoch, meters,
                                               best=is_best)
                printr(f"[save_path] = {path}")
                # the epoch's summary last, on every process
                print(json.dumps({
                    "epoch": epoch,
                    "ratio": trainer.compression.compress_ratio,
                    "loss": losses, "step_s": times, "eval": meters}))
        finally:
            writer.close()
        return out
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
