"""Training harness: a DGC recipe of :mod:`dgc_tpu_torch.configs` —
ResNet-20 on CIFAR-10 (the default), ResNet-50 or ResNet-18 on ImageNet,
all with the wm5 warm-up.

Counterpart of the repository's ``train.py`` for the port. ``Trainer``
builds the config's dataset (synthetic when no data root exists), model,
compressor, learning-rate schedule, ``dgc_sgd`` (nesterov and the
BatchNorm weight-decay split as the config says) behind the distributed
optimizer, and the flat state; :meth:`Trainer.run_epoch` applies the
warm-up schedule (rebuilding the engine when the ratio changes) and runs
the epoch's steps.

Workers: ``--world W`` simulates W workers on one device in lockstep
(``LocalComm``). With ``--init-method`` each process is one worker of a
``torch.distributed`` group (NCCL on the card, gloo on the CPU), and
``--world`` is the group size.

    python -m dgc_tpu_torch.train --device cpu --world 2 --steps 2 \\
        --epochs 1 --batch-size 8 --synthetic-size 64
    python -m dgc_tpu_torch.train --config resnet50_wm5 --device cpu \\
        --world 2 --epochs 1 --steps 1 --batch-size 2 --image-size 32 \\
        --synthetic-size 16

``--image-size`` only shrinks the synthetic images (for CPU runs), as the
JAX harness's ``--dataset.image_size`` override does. ``--megakernel`` and
``--fused-select`` turn on the compressor's fused routes, as the JAX
harness's ``--train.compression.megakernel True`` and
``--train.compression.fused_select True`` do (the ``*_megakernel`` recipes
are their base recipes with ``--megakernel``).
"""

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from dgc_tpu_torch import configs as _configs
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.data.datasets import CIFAR, ImageNet
from dgc_tpu_torch.data.sampler import epoch_batches, num_steps_per_epoch
from dgc_tpu_torch.models import create, param_tree
from dgc_tpu_torch.optim.distributed import DistributedOptimizer
from dgc_tpu_torch.optim.sgd import dgc_sgd
from dgc_tpu_torch.parallel.comm import Comm, LocalComm, ProcessGroupComm
from dgc_tpu_torch.training.lr import (cosine_schedule, make_lr_schedule,
                                       multistep_schedule)
from dgc_tpu_torch.training.step import (make_flat_setup, make_flat_state,
                                         train_step)
from dgc_tpu_torch.utils.device import resolve_device

__all__ = ["Trainer", "main"]


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
        self.compression = DGCCompressor(
            cc.compress_ratio, memory=DGCSGDMemory(cc.memory.momentum),
            sample_ratio=cc.sample_ratio, strided_sample=cc.strided_sample,
            compress_upper_bound=cc.compress_upper_bound,
            compress_lower_bound=cc.compress_lower_bound,
            max_adaptation_iters=cc.max_adaptation_iters,
            resample=cc.resample, warmup_epochs=cc.warmup_epochs,
            fused_select=cc.fused_select, megakernel=cc.megakernel,
            verbose=verbose)
        self.compression.initialize(
            (n.replace(".", "/"), tuple(p.shape))
            for n, p in self.model.named_parameters() if p.dim() > 1)

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
            dgc_sgd(lr, momentum=oc.momentum, weight_decay=oc.weight_decay,
                    nesterov=oc.nesterov, weight_decay_mask=wd_mask),
            self.compression, comm)
        self.setup = make_flat_setup(self.model, self.dist)
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device)
        #: one host generator of sampling phases per local worker
        self.gens = [torch.Generator().manual_seed(self.seed * 7919 + 1 + r)
                     for r in comm.ranks]
        self._built_ratio = None

    def load_flat(self, flat_params: torch.Tensor,
                  flat_stats: torch.Tensor) -> None:
        """Replace the initial weights (e.g. with ones carried from the
        JAX package); call before the first step."""
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device, flat_params, flat_stats)

    def _batches(self, idx: np.ndarray):
        images, labels = self.dataset["train"].get_batch(idx)
        per = self.nbps * self.bs
        xs, ys = [], []
        for r in self.comm.ranks:
            x = torch.from_numpy(images[r * per:(r + 1) * per])
            y = torch.from_numpy(labels[r * per:(r + 1) * per])
            xs.append(x.to(self.device).permute(0, 3, 1, 2))
            ys.append(y.to(self.device, torch.int64))
        return xs, ys

    def run_epoch(self, epoch: int, steps: Optional[int] = None,
                  step_times: Optional[List[float]] = None
                  ) -> List[torch.Tensor]:
        """Train ``epoch`` (at most ``steps`` steps). Returns the mean
        losses, still on the device. With ``step_times``, each step is
        synchronised and its wall time appended (seconds)."""
        self.compression.warmup_compress_ratio(epoch)
        if self.compression.compress_ratio != self._built_ratio:
            # new ratio -> new engine geometry; layouts and memory carry over
            self.setup = make_flat_setup(self.model, self.dist)
            self._built_ratio = self.compression.compress_ratio
            if self.verbose:
                print(f"[epoch {epoch}] ratio {self._built_ratio:.4g}: "
                      f"payload {self.setup.engine.payload_size}/worker")
        losses = []
        it = epoch_batches(len(self.dataset["train"]), self.global_batch,
                           epoch, seed=self.seed, drop_last=self.nbps > 1)
        for s, idx in enumerate(it):
            if steps is not None and s >= steps:
                break
            xs, ys = self._batches(idx)
            t0 = time.perf_counter()
            self.state, loss = train_step(self.model, self.setup, self.dist,
                                          self.state, xs, ys, self.gens,
                                          self.nbps)
            if step_times is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                step_times.append(time.perf_counter() - t0)
            losses.append(loss)
        return losses


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
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    # this slice trains in full f32: no TF32 in cuDNN or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        import torch.distributed as dist
        if device.type == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=args.init_method,
                                world_size=args.world, rank=args.rank)
        comm = ProcessGroupComm()
    else:
        comm = LocalComm(args.world)
    try:
        trainer = Trainer(cfg, comm, device, verbose=True)
        out = []
        epochs = (args.epochs if args.epochs is not None
                  else cfg.train.num_epochs)
        for epoch in range(epochs):
            times: List[float] = []
            losses = [float(x) for x in trainer.run_epoch(epoch, args.steps,
                                                          times)]
            out += losses
            print(json.dumps({"epoch": epoch,
                              "ratio": trainer.compression.compress_ratio,
                              "loss": losses, "step_s": times}))
        return out
    finally:
        if args.init_method:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
