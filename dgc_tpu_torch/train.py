"""Training harness: a recipe of :mod:`dgc_tpu_torch.configs` —
ResNet-20 or ResNet-110 on CIFAR-10 (``resnet20_wm5`` is the default),
ResNet-50, ResNet-18 or VGG-16-BN on ImageNet (VGG also in bfloat16
compute, ``vgg16_bn_wm5_bf16``); with DGC and its warm-up, or the dense
baseline.

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
BatchNorm statistics, sampling generator and, for VGG, dropout
generator; ``best`` when the metric
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
    python -m dgc_tpu_torch.train --config vgg16_bn_wm5 --device cpu \\
        --world 2 --epochs 1 --steps 1 --batch-size 2 --image-size 224 \\
        --synthetic-size 8
    torchrun --standalone --nproc_per_node=2 -m dgc_tpu_torch.train \\
        --config resnet20_wm5 --epochs 1 --steps 2

``--image-size`` only shrinks the synthetic images (for CPU runs), as the
JAX harness's ``--dataset.image_size`` override does; VGG needs a multiple
of 7 x 32 (its five pools reach 7x7 at 224), or its forward raises, as
the reference's does. A real ``root`` with ``train/`` and ``val/`` class
folders is read with PIL (:class:`~dgc_tpu_torch.data.datasets.
ImageFolderSplit`); ``--data-root DIR`` names it, and then an ImageNet
run stops when the folders are missing instead of falling back to the
synthetic images, as the JAX harness's ``--dataset.root DIR
--dataset.synthetic_fallback False``. ``--megakernel`` and
``--fused-select`` turn on the compressor's fused routes, as the JAX
harness's ``--train.compression.megakernel True`` and
``--train.compression.fused_select True`` do (the ``*_megakernel`` recipes
are their base recipes with ``--megakernel``).

The narrow wires and state are recipes (``resnet20_wm5_fp16``,
``resnet20_wm5_int8``, ``resnet20_wm5_int8_packidx``,
``resnet50_wm5_bf16mem``, ``resnet50_wm5_bf16mem_int8_packidx``): the
compressor takes the recipe's ``fp16_values``, ``int8_values``,
``int8_error_feedback``, ``packed_indices`` and ``int32_indices``, the
memory its ``dtype``. ``--autotune`` (or the recipe's ``train.autotune``
block, ``resnet20_wm5_autotune``) plans a regime per bucket
(:class:`~dgc_tpu_torch.compression.autotune.Autotuner`, printed as
``[autotune] fabric ... -> plan [...]``), records each step's host
interval against the wire's bytes, refits the link model at each epoch
boundary into ``<save_path>/fabric.json`` and rebuilds the engine at the
next epoch only when the plan's key changed; a warm-up rebuild re-fits the
plan to the new geometry. It is refused without DGC.

The gossip exchange (``resnet20_wm5_gossip``, ``resnet50_wm5_gossip``:
``configs/gossip.py``, the recipe's ``train.gossip`` block with
``topology`` "ring" or "hcube", ``sync_every`` and ``max_staleness``,
None for the world's defaults): the trainer plans every bucket on the
family (``planner.plan_engine(..., candidates=(family,))``, printed as
``[gossip] GossipConfig(...) -> plan [...]``), keeps that plan for every
warm-up rebuild, re-fitted to the new geometry, and with ``--autotune``
adds the family to the autotuner's candidates instead. The fleet taps
carry each worker's staleness. It is refused without DGC
(``SystemExit``, as the JAX harness).

    python -m dgc_tpu_torch.train --config resnet20_wm5_gossip \\
        --device cpu --world 4 --epochs 1 --steps 4 --batch-size 8 \\
        --synthetic-size 64

    python -m dgc_tpu_torch.train --config resnet20_wm5 --autotune \\
        --device cpu --world 2 --epochs 2 --steps 3 --batch-size 8 \\
        --synthetic-size 64

Resilience (the ``*_resilience`` recipes, ``configs/resilience.py`` with
the checksum on; the recipe's ``train.resilience`` block): the step
guards (the non-finite skip and the loss-spike breaker, ``train_step(...,
guards=...)``), the payload checksum, a watchdog thread, a flight recorder
of the last steps (``<save_path>/flight.json``), and preemption: SIGTERM or
SIGINT stops the run at the next step boundary (agreed by every process),
writes an emergency checkpoint of the epoch in progress with the last
trained batch (``preempt_batch``) and exits 75; the same command run again
resumes mid-epoch at the next batch, bitwise as the uninterrupted run.
A streak of non-finite losses the guards cannot skip dumps the flight
ring and exits 70. ``DGC_FAULTS`` (``resilience.faults``) arms the drills
(``nan@K``, ``bitflip``, ``badidx``, ``kill@K``, ``slow``, ``hang``,
``exit``, ``init_fail@N``). ``--elastic`` (or the recipe's
``train.elastic``) resumes across a world-size change: the experiment
directory ends in ``.npE``, the per-worker state is resharded, and
``num_batches_per_step`` is scaled so the global batch stays the same.
The two-tier recipes (``*_twotier``, ``configs/dgc/twotier.py``:
``train.num_local_workers``, which must divide the world) average each
node's gradients densely, then run DGC across the nodes.

Under a supervisor (:mod:`dgc_tpu_torch.control`; the ``*_control``
recipes carry every signal its rule table reads) the run stamps
``DGC_RUN_ID`` into its telemetry header's and flight recorder's static
as ``run_id``, and its watchdog refreshes the ``DGC_HEARTBEAT`` file
whose stale mtime makes the supervisor kill a hung run.

    DGC_FAULTS=kill@3 python -m dgc_tpu_torch.train \\
        --config resnet20_wm5_resilience --device cpu --world 2 \\
        --epochs 1 --steps 6 --batch-size 8 --synthetic-size 64  # exits 75
    python -m dgc_tpu_torch.train --config resnet20_wm5_resilience \\
        --device cpu --world 2 --epochs 1 --steps 6 --batch-size 8 \\
        --synthetic-size 64                               # resumes at 4

Cohort surgery (``--surgery``, the block's ``surgery`` key): the
step-boundary agreement becomes :class:`~dgc_tpu_torch.resilience.surgery.
SurgeryCoordinator`'s gather of ``(preempt, verdict, target)`` with a
deadline. An excise order published to ``<save_path>/checkpoints/
surgery.json`` (``surgery.publish_order``) stops every process at the
next boundary: the emergency checkpoint, the exit record
(``surgery_exit.json``), the order cleared, exit 76. A member that misses
the deadline and its retries makes the rest dump the flight ring, write
the record and exit 76 at once.
"""

import argparse
import contextlib
import itertools
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgc_tpu_torch import configs as _configs
from dgc_tpu_torch.compression.autotune import Autotuner
from dgc_tpu_torch.compression.planner import REGIMES, plan_engine
from dgc_tpu_torch.compression.base import Compression
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.control import resolve_run_id
from dgc_tpu_torch.data.datasets import CIFAR, ImageNet
from dgc_tpu_torch.data.native import Prefetcher, stage_ahead
from dgc_tpu_torch.data.sampler import epoch_batches, num_steps_per_epoch
from dgc_tpu_torch.models import from_config, param_tree, uses_dropout
from dgc_tpu_torch.optim.adasum import AdasumDistributedOptimizer
from dgc_tpu_torch.optim.distributed import DistributedOptimizer
from dgc_tpu_torch.optim.sgd import dgc_sgd, sgd
from dgc_tpu_torch.parallel.comm import Comm, LocalComm, ProcessGroupComm
from dgc_tpu_torch.parallel.multihost import initialize_multihost
from dgc_tpu_torch.resilience import elastic as _elastic
from dgc_tpu_torch.resilience import faults as _faults
from dgc_tpu_torch.resilience import preempt as _preempt
from dgc_tpu_torch.resilience import surgery as _surgery
from dgc_tpu_torch.resilience.adaptive import AdaptiveConfig
from dgc_tpu_torch.resilience.guard import GuardConfig
from dgc_tpu_torch.telemetry import trace as _trace
from dgc_tpu_torch.telemetry.attrib import load_profile
from dgc_tpu_torch.telemetry.fleet import make_clock
from dgc_tpu_torch.telemetry.flight import FlightRecorder, NonfiniteStreak
from dgc_tpu_torch.telemetry.sink import TelemetrySink
from dgc_tpu_torch.training import checkpoint
from dgc_tpu_torch.training.checkpoint import CheckpointManager
from dgc_tpu_torch.training.lr import (cosine_schedule, make_lr_schedule,
                                       multistep_schedule)
from dgc_tpu_torch.training.step import (eval_step, make_flat_setup,
                                         make_flat_state,
                                         resolve_pending_skip, train_step)
from dgc_tpu_torch.utils import profiling
from dgc_tpu_torch.utils.device import (resolve_device,
                                        set_reproducible_numerics)
from dgc_tpu_torch.utils.logging import MetricWriter, printr
from dgc_tpu_torch.utils.meters import TopKClassMeter

__all__ = ["Trainer", "main", "get_save_path"]

#: steps of the first trained epoch that ``--profile`` traces
PROFILE_STEPS = 8
#: the recipes' wire flags the compressor takes as they are
_WIRE_FLAGS = ("fp16_values", "int8_values", "int8_error_feedback",
               "packed_indices", "int32_indices")


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
                 device="cuda", verbose: bool = False,
                 fabric_out: Optional[str] = None, adasum: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or _configs.resnet20_wm5()
        self.comm = comm = comm or LocalComm(1)
        self.verbose = verbose
        tc = cfg.train
        rc = tc.get("resilience") or {}
        #: the step guards (``train.resilience``), or None
        self.guards = (GuardConfig(
            nonfinite=bool(rc.get("nonfinite_guard", True)),
            spike_window=int(rc.get("spike_window", 0) or 0),
            spike_factor=float(rc.get("spike_factor", 10.0)))
            if rc.get("enabled", False) else None)
        checksum = bool(self.guards is not None and rc.get("checksum", False))
        if checksum and not tc.dgc:
            raise ValueError("the payload checksum needs the sparse DGC wire "
                             "(recipes with train.dgc = True)")
        #: the armed fault plan, read once (None: ``DGC_FAULTS`` unset)
        self.faults = _faults.active_plan()
        tel = tc.get("telemetry") or {}
        #: the step's telemetry taps (``train.telemetry.enabled``) and the
        #: fleet gather (``train.telemetry.fleet``)
        self.telemetry = bool(tel.get("enabled", False))
        self.fleet = bool(self.telemetry and tel.get("fleet", False))
        ac = tc.get("adaptive") or {}
        #: the straggler-adaptive exchange's policy (``train.adaptive``),
        #: or None
        self.adaptive = None
        if ac.get("enabled", False):
            if not tc.dgc:
                raise ValueError("the adaptive exchange degrades the sparse "
                                 "DGC wire (recipes with train.dgc = True)")
            if not self.fleet:
                raise ValueError(
                    "the adaptive exchange reads the fleet w_clock lane: "
                    "it needs train.telemetry.enabled and fleet")
            self.adaptive = AdaptiveConfig(**{
                k: float(ac[k]) for k in AdaptiveConfig._fields if k in ac})
        #: the telemetry sink and the host span tracer (the CLI sets them)
        self.sink = None
        self.tracer = _trace.NULL_TRACER
        #: the end of the last step call (the fleet clock's prep interval
        #: runs from it to the next step's start)
        self._prev_dispatch: Optional[float] = None
        #: workers a node (two tiers when > 1)
        self.num_local = int(tc.get("num_local_workers", 1) or 1)
        if comm.world % self.num_local:
            raise ValueError(f"num_local_workers {self.num_local} must "
                             f"divide the world {comm.world}")
        self.seed = cfg.seed
        dc = cfg.dataset
        self.dataset = {"cifar": CIFAR, "imagenet": ImageNet}[dc.name](
            dc.root, dc.num_classes, dc.image_size,
            synthetic_size=dc.synthetic_size,
            **({"synthetic_fallback": dc.synthetic_fallback}
               if "synthetic_fallback" in dc else {}))
        self.nbps = tc.num_batches_per_step
        self.bs = tc.batch_size
        self.global_batch = comm.world * self.nbps * self.bs

        # initialised on the host, so every device starts from one weights
        self.model = from_config(
            cfg.model, torch.Generator().manual_seed(self.seed)).to(
                self.device)

        cc = tc.compression
        if tc.dgc:
            mc = cc.memory
            self.compression = DGCCompressor(
                cc.compress_ratio,
                memory=DGCSGDMemory(mc.momentum, nesterov=mc.nesterov,
                                    momentum_masking=mc.momentum_masking,
                                    dtype=mc.get("dtype")),
                sample_ratio=cc.sample_ratio,
                strided_sample=cc.strided_sample,
                compress_upper_bound=cc.compress_upper_bound,
                compress_lower_bound=cc.compress_lower_bound,
                max_adaptation_iters=cc.max_adaptation_iters,
                resample=cc.resample, warmup_epochs=cc.warmup_epochs,
                warmup_coeff=cc.warmup_coeff,
                fused_select=cc.fused_select, megakernel=cc.megakernel,
                **{k: cc[k] for k in _WIRE_FLAGS if k in cc},
                checksum=checksum, verbose=verbose)
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
        # Adasum (library-only, as in the reference): the base optimizer
        # steps each worker's local gradient, the deltas are combined
        self.dist = (AdasumDistributedOptimizer if adasum
                     else DistributedOptimizer)(
            (dgc_sgd if tc.dgc else sgd)(
                lr, momentum=oc.momentum, weight_decay=oc.weight_decay,
                nesterov=oc.nesterov, weight_decay_mask=wd_mask),
            self.compression, comm, local_size=self.num_local)
        gc = tc.get("gossip") or {}
        #: the gossip exchange's regime family (``train.gossip``), or None
        self.gossip_family = None
        self._gossip_kw = {}
        if gc.get("enabled", False):
            if not tc.dgc:
                raise SystemExit("gossip decentralizes the sparse DGC wire "
                                 "(configs with train.dgc = True)")
            self.gossip_family = "gossip_" + str(gc.get("topology", "ring"))
            self._gossip_kw = {
                f"gossip_{k}": (None if gc.get(k) is None else int(gc[k]))
                for k in ("sync_every", "max_staleness")}
        #: the standing gossip plan every warm-up rebuild re-fits (None:
        #: gossip off, or the autotuner owns the plan)
        self._gossip_plan = None
        at = tc.get("autotune") or {}
        #: the online replanner (``train.autotune.enabled``), or None
        self.autotuner = None
        if at.get("enabled", False):
            if not tc.dgc:
                raise ValueError("autotune plans the sparse DGC wire "
                                 "(recipes with train.dgc = True)")
            self.autotuner = Autotuner(
                world=comm.world, fabric_out=fabric_out,
                min_points=at.get("min_points", 2),
                candidates=REGIMES + ((self.gossip_family,)
                                      if self.gossip_family else ()),
                **self._gossip_kw)
        #: a replan whose key changed: the engine is rebuilt next epoch
        self._plan_pending = False
        self._at_wire = 0
        self._build_setup()
        if self.autotuner is not None:
            printr(f"[autotune] fabric {self.autotuner.fabric.name} "
                   f"({self.autotuner.fabric.gbps:.3g} GB/s) -> plan "
                   f"{list(self.setup.engine.regimes)}")
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device, guards=self.guards,
                                     adaptive=self.adaptive)
        #: one host generator of sampling phases per local worker, seeded
        #: by its node's index (its own rank without two tiers): the
        #: workers of a node draw the same phases, those a flat run's
        #: worker of that index draws
        self.gens = [torch.Generator().manual_seed(
            self.seed * 7919 + 1 + r // self.num_local)
            for r in comm.ranks]
        #: one dropout generator per local worker on the device, for a
        #: model with dropout (seeds above every sampling seed)
        self.dropout_gens = (
            [torch.Generator(device=self.device).manual_seed(
                self.seed * 7919 + 1 + r + (1 << 32)) for r in comm.ranks]
            if uses_dropout(self.model) else None)
        self._built_ratio = None
        self._upload_stream = None
        #: the last batch index ``run_epoch`` trained before ``stop`` said
        #: so, else None
        self.stopped_at: Optional[int] = None
        #: the last guarded step's guard metrics (device tensors)
        self.last_guards = None

    def _build_setup(self) -> None:
        """The engine at the compressor's ratio; under the autotuner with
        the plan of its current fabric, under a gossip recipe with the
        standing gossip plan, each re-fit to this geometry."""
        self.setup = make_flat_setup(self.model, self.dist,
                                     plan=self._gossip_plan)
        if self.gossip_family is not None and self.autotuner is None \
                and self._gossip_plan is None:
            self._gossip_plan = plan_engine(
                self.setup.engine, world=self.comm.world,
                candidates=(self.gossip_family,), **self._gossip_kw)
            self.setup = make_flat_setup(self.model, self.dist,
                                         plan=self._gossip_plan)
            printr(f"[gossip] {self.setup.engine.plan.gossip} -> plan "
                   f"{list(self.setup.engine.regimes)}")
        if self.autotuner is not None:
            plan = self.autotuner.plan_for(self.setup.engine)
            self.setup = make_flat_setup(self.model, self.dist, plan=plan)
            # the (bytes, ms) points' size: the sparse wire when the plan
            # keeps one, else the dense all-reduce's bytes
            self._at_wire = (self.setup.engine.wire_bytes_per_worker()
                             or 4 * self.setup.layout.total)
        self._plan_pending = False

    def autotune_epoch_end(self, epoch: int, profile: Optional[Dict] = None):
        """The autotuner's epoch boundary: refit the link model over the
        steps' points (and a ``dgc-profile`` table's per-bucket all-gather
        costs, ``profile``), write ``fabric.json``, replan; a plan whose
        key changed rebuilds the engine at the next epoch (the memory
        carries over). Returns the new plan, or None."""
        at = self.autotuner
        new = at.epoch_end(self.setup.engine, epoch=epoch, profile=profile)
        if new is not None:
            self._plan_pending = True
            printr(f"[autotune] refit {at.fabric.gbps:.3g} GB/s alpha "
                   f"{at.fabric.alpha_ms:.3g} ms -> replan "
                   f"{list(new.regimes)} (rebuild next epoch)")
        elif at.refit_count:
            printr(f"[autotune] refit {at.fabric.gbps:.3g} GB/s alpha "
                   f"{at.fabric.alpha_ms:.3g} ms — plan unchanged (no "
                   "rebuild)")
        return new

    @property
    def topology(self) -> Dict[str, int]:
        """What a checkpoint must have been written under to restore
        here: processes, workers, the two-tier group size (1: the port
        has no two-tier exchange)."""
        return {"process_count": (dist.get_world_size()
                                  if dist.is_initialized() else 1),
                "world": self.comm.world,
                "num_local_workers": self.num_local}

    def save_checkpoint(self, ckpt: CheckpointManager, epoch: int,
                        meters: Dict[str, float], best: bool = False,
                        topology: Optional[Dict[str, int]] = None) -> str:
        """Save this process's part of the state after ``epoch`` (every
        process of a group calls this). A pending upload on the side
        stream is waited for first, and a pending guard verdict read."""
        if self._upload_stream is not None:
            self._upload_stream.synchronize()
        resolve_pending_skip(self.state)
        rep, workers = checkpoint.state_tensors(
            self.state, self.gens, self.comm.ranks,
            dropout_gens=self.dropout_gens)
        return ckpt.save(epoch, rep, workers, meters, best=best,
                         topology=topology or self.topology)

    def restore_checkpoint(self, ckpt: CheckpointManager,
                           best: bool = False, elastic: bool = False
                           ) -> Optional[Tuple[int, Dict[str, float]]]:
        """Restore the newest loadable epoch (``best``: the best one) into
        the state and the generators; ``(epoch, meters)``, or None when
        there is nothing to restore. ``elastic``: reshard a checkpoint of
        another world size."""
        rep, workers = checkpoint.state_tensors(
            self.state, self.gens, self.comm.ranks, host=False,
            dropout_gens=self.dropout_gens)
        opts = None
        if elastic:
            opts = {"per_worker_opt": self.dist.per_worker_opt_state}
            if hasattr(self.compression, "elastic_reshard_opts"):
                opts.update(self.compression.elastic_reshard_opts())
        out = ckpt.restore(rep, workers, best=best, topology=self.topology,
                           elastic=elastic, elastic_opts=opts)
        if out is None:
            return None
        rep, workers, epoch, meters = out
        self.state = checkpoint.load_state_tensors(
            self.state, self.gens, self.comm.ranks, rep, workers,
            dropout_gens=self.dropout_gens)
        return epoch, meters

    def load_flat(self, flat_params: torch.Tensor,
                  flat_stats: torch.Tensor) -> None:
        """Replace the initial weights (e.g. with ones carried from the
        JAX package); call before the first step."""
        self.state = make_flat_state(self.model, self.dist, self.setup,
                                     self.device, flat_params, flat_stats,
                                     adaptive=self.adaptive)

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

    def epoch_inputs(self, epoch: int, steps: Optional[int] = None,
                     start: int = 0):
        """The inputs of ``epoch``'s steps (at most ``steps``) for this
        process's workers, ``(images, labels)`` lists on the device: the
        batches of ``epoch_batches``, prepared on a background thread and
        uploaded one step ahead (:func:`stage_ahead`, depth 1), each
        ordered before the step that reads it by its upload's event (and
        its device memory held for that step's stream). Only the batches
        of those steps are prepared, so a split's augmentation draws as
        many as inline batches would. ``start``: the batches before it are
        skipped (a mid-epoch resume; the epoch's order is a function of
        the epoch and the seed, so it lines up)."""
        split = self.dataset["train"]
        it = epoch_batches(len(split), self.global_batch, epoch,
                           seed=self.seed, drop_last=self.nbps > 1)
        if steps is not None or start:
            it = itertools.islice(it, start, steps)
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
                  profile_dir: Optional[str] = None, start: int = 0,
                  stop: Optional[Callable[[int], bool]] = None,
                  on_step: Optional[Callable[[int, dict], None]] = None
                  ) -> List[torch.Tensor]:
        """Train ``epoch`` (its batches ``start`` to ``steps``, all by
        default). Returns the mean losses, still on the device. With
        ``step_times``, each step is synchronised and its wall time
        appended (seconds). With ``profile_dir``, the first
        :data:`PROFILE_STEPS` steps are traced there
        (:func:`~dgc_tpu_torch.utils.profiling.trace`). ``stop(batch)``
        is asked at each step boundary before the batch: True ends the
        epoch there (:attr:`stopped_at` is then the last batch trained);
        ``on_step(batch, metrics)`` runs after each step (``metrics``:
        ``loss``, ``step`` and ``guards`` with guards, ``telemetry`` and
        ``fleet`` with the taps). With the fleet taps each step gets the
        host's prep interval (:meth:`clock`); the host spans (``data_load``,
        ``step``) go to :attr:`tracer`."""
        self.compression.warmup_compress_ratio(epoch)
        ratio = self.compression.compress_ratio
        if ratio != self._built_ratio or self._plan_pending:
            # new ratio (or plan) -> new engine; layouts and memory carry
            # over
            self._build_setup()
            self._built_ratio = ratio
            if self.sink is not None:
                # readers re-anchor the per-bucket columns at a rebuild
                self.sink.write_record(dict(
                    _telemetry_static(self.setup), event="engine_rebuild",
                    epoch=epoch))
            if self.verbose and ratio is not None:
                print(f"[epoch {epoch}] ratio {self._built_ratio:.4g}: "
                      f"payload {self.setup.engine.payload_size}/worker")
        losses = []
        at_prev = None
        self.stopped_at = None
        inputs = self.epoch_inputs(epoch, steps, start)
        with contextlib.closing(inputs), contextlib.ExitStack() as prof:
            if profile_dir is not None:
                prof.enter_context(profiling.trace(profile_dir))
            for s, (xs, ys) in enumerate(
                    self.tracer.wrap_iter(inputs, "data_load")):
                if stop is not None and stop(start + s):
                    self.stopped_at = start + s - 1
                    break
                t0 = time.perf_counter()
                kw = {}
                if self.telemetry:
                    kw = {"telemetry": True, "fleet": self.fleet,
                          "adaptive": self.adaptive}
                if self.fleet:
                    # the prep interval: the last step call's end to this
                    # one's start, host wall clock
                    kw["clock"] = self.clock(
                        (t0 - self._prev_dispatch) * 1e3
                        if self._prev_dispatch is not None else 0.0)
                with self.tracer.span("step", epoch=epoch, batch=start + s):
                    self.state, out = train_step(
                        self.model, self.setup, self.dist, self.state, xs,
                        ys, self.gens, self.nbps, self.dropout_gens,
                        guards=self.guards, faults=self.faults, **kw)
                self._prev_dispatch = time.perf_counter()
                metrics = out if isinstance(out, dict) else {"loss": out}
                loss = metrics["loss"]
                self.last_guards = metrics.get("guards")
                if step_times is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    step_times.append(time.perf_counter() - t0)
                losses.append(loss)
                if self.autotuner is not None:
                    # the step's host interval against the wire bytes (no
                    # sync: the device's backlog shows in the interval)
                    now = time.perf_counter()
                    if at_prev is not None:
                        self.autotuner.record_step((now - at_prev) * 1e3,
                                                   self._at_wire)
                    at_prev = now
                if on_step is not None:
                    on_step(start + s, metrics)
                if s + 1 == PROFILE_STEPS:
                    prof.close()
        return losses

    def clock(self, dt_ms: float) -> torch.Tensor:
        """The fleet clock of a step: ``dt_ms`` in every worker's slot of
        a [world] f32 tensor on the device (:func:`telemetry.fleet.
        make_clock`)."""
        return make_clock(dt_ms, self.comm.world, self.device)

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


def _telemetry_static(setup) -> Dict:
    """The engine's sink header block (the dense baseline's engine has
    none: its kind and size)."""
    eng = setup.engine
    if hasattr(eng, "telemetry_static"):
        return eng.telemetry_static()
    return {"engine": type(eng).__name__,
            "num_params": int(setup.layout.total)}


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
    p.add_argument("--data-root", default=None,
                   help="the dataset's directory; ImageNet's must hold "
                        "train/ and val/, or the run stops")
    p.add_argument("--megakernel", action="store_true",
                   help="compensate and select through the forward "
                        "megakernel where it applies")
    p.add_argument("--fused-select", action="store_true",
                   help="select through the select-and-pack kernel where "
                        "it applies")
    p.add_argument("--autotune", action="store_true",
                   help="online exchange replanning: plan per-bucket wire "
                        "regimes, refit the link model from the steps' "
                        "times at each epoch boundary, and rebuild the "
                        "engine only when the plan's key changes; writes "
                        "<save_path>/fabric.json (configs/autotune.py)")
    p.add_argument("--evaluate", action="store_true",
                   help="restore the best checkpoint and only evaluate it "
                        "on the test split")
    p.add_argument("--suffix", default="",
                   help="appended to the experiment directory's name")
    p.add_argument("--profile", action="store_true",
                   help="trace the first steps of the first epoch trained "
                        "to <save_path>/profile")
    p.add_argument("--num-local-workers", type=int, default=None,
                   help="workers a node of the two-tier exchange (the "
                        "JAX harness's --train.num_local_workers)")
    p.add_argument("--elastic", action="store_true",
                   help="resume across a world-size change: reshard the "
                        "per-worker state, keep the global batch "
                        "(configs/elastic.py); the directory ends in .npE")
    p.add_argument("--trace", action="store_true",
                   help="structured tracing: host spans + dgcph.* phase "
                        "markers, saved as a Perfetto-loadable "
                        "<save_path>/trace.json (configs/trace.py)")
    p.add_argument("--surgery", action="store_true",
                   help="cohort surgery: fold excise orders into the "
                        "step-boundary agreement (exit 76); needs the "
                        "resilience block (the *_resilience recipes)")
    p.add_argument("--adaptive", action="store_true",
                   help="straggler-adaptive exchange: a lagging worker "
                        "sends a smaller fraction of its quota, the rest "
                        "stays in its residual; needs the fleet taps "
                        "(configs/adaptive.py; also DGC_ADAPTIVE=1)")
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
    if args.data_root:
        cfg.dataset.root = args.data_root
        if "synthetic_fallback" in cfg.dataset:
            cfg.dataset.synthetic_fallback = False
    if args.megakernel:
        cfg.train.compression.megakernel = True
    if args.fused_select:
        cfg.train.compression.fused_select = True
    if args.autotune:
        if not cfg.train.dgc:
            raise SystemExit("--autotune plans the sparse DGC wire (recipes "
                             "with train.dgc = True)")
        _configs.with_autotune(cfg)
    if args.num_local_workers:
        cfg.train.num_local_workers = args.num_local_workers
    if args.adaptive or os.environ.get("DGC_ADAPTIVE"):
        if not cfg.train.dgc:
            raise SystemExit("--adaptive degrades the sparse DGC wire "
                             "(recipes with train.dgc = True)")
        tel = cfg.train.get("telemetry") or {}
        if not (tel.get("enabled", False) and tel.get("fleet", False)):
            raise SystemExit(
                "--adaptive reads the fleet w_clock lane: it needs "
                "train.telemetry.enabled + fleet (the *_telemetry recipes; "
                "resnet50_wm5_adaptive stacks both)")
        _configs.with_adaptive(cfg)
    if args.trace:
        _configs.with_trace(cfg)
    if args.surgery:
        rc = cfg.train.get("resilience") or {}
        if not rc.get("enabled", False):
            raise SystemExit("--surgery widens the resilience layer's "
                             "step-boundary agreement: it needs "
                             "train.resilience (the *_resilience recipes)")
        rc.surgery = True
    ec = cfg.train.get("elastic") or {}
    elastic_on = bool(args.elastic or ec.get("enabled", False))
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
        # a two-tier run's memory is per node: its own directory; an
        # elastic run shares one lineage across world sizes
        num_local = int(cfg.train.get("num_local_workers", 1) or 1)
        tier = f".tt{num_local}" if num_local > 1 else ""
        save_path = (get_save_path(*_configs.CONFIG_FILES[args.config])
                     + args.suffix + tier
                     + (".npE" if elastic_on else f".np{comm.world}"))
        ckpt = CheckpointManager(os.path.join(save_path, "checkpoints"))
        if elastic_on:
            saved_topo = ckpt.saved_topology()
            if saved_topo is not None and int(saved_topo["world"]) != \
                    comm.world:
                nbps, note = _elastic.resolve_batch_geometry(
                    int(saved_topo["world"]), comm.world,
                    cfg.train.num_batches_per_step,
                    preserve=bool(ec.get("preserve_global_batch", True)))
                if note:
                    printr(f"[elastic] {note}")
                cfg.train.num_batches_per_step = nbps
        trainer = Trainer(cfg, comm, device, verbose=True,
                          fabric_out=os.path.join(save_path, "fabric.json"))
        printr(f"[train.save_path] = {save_path}")
        metric = cfg.train.metric
        last_epoch, best = -1, None
        resume_epoch, resume_batch = None, 0
        elastic_info = None
        restored = (trainer.restore_checkpoint(ckpt, best=args.evaluate,
                                               elastic=elastic_on)
                    if args.evaluate or ckpt.latest_epoch() is not None
                    else None)
        if restored is not None:
            last_epoch, saved = restored
            best = saved.get(metric + "_best")
            einfo = elastic_info = saved.pop("_elastic", None)
            if einfo is not None:
                printr(f"[elastic] resharded checkpoint state "
                       f"{einfo['from_world']} -> {einfo['to_world']} "
                       "workers")
            # an emergency checkpoint holds the epoch in progress and its
            # last trained batch: resume at the next batch of that epoch
            pb = saved.get("preempt_batch")
            if pb is not None and not args.evaluate:
                resume_epoch, resume_batch = last_epoch, int(pb) + 1
                last_epoch -= 1
                printr(f"\n[resumed] mid-epoch {resume_epoch} at batch "
                       f"{resume_batch}, best {best}")
            else:
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
        tel = _Telemetry(cfg, trainer, save_path, elastic_info)
        res = _Resilience(cfg.train.get("resilience") or {}, trainer,
                          save_path, device, last_epoch, resume_batch)
        tracer = trainer.tracer
        try:
            for epoch in range(last_epoch + 1, epochs):
                times: List[float] = []
                profile_dir = (os.path.join(save_path, "profile")
                               if args.profile and epoch == last_epoch + 1
                               else None)
                start = resume_batch if epoch == resume_epoch else 0
                raw = trainer.run_epoch(
                    epoch, args.steps, times, profile_dir=profile_dir,
                    start=start, stop=res.stop(epoch),
                    on_step=_chain(res.on_step(epoch), tel.on_step(epoch)))
                # the epoch's one host sync: it waits for every queued step
                with tracer.span("exchange_wait", epoch=epoch):
                    losses = [float(x) for x in raw]
                # x = samples seen, counting every earlier epoch whole
                seen = ((epoch * trainer.steps_per_epoch + start)
                        * trainer.global_batch)
                for s, loss in enumerate(losses):
                    seen += trainer.global_batch
                    if s % 50 == 0 or s == len(losses) - 1:
                        writer.add_scalar("loss/train", loss, seen)
                out += losses
                if trainer.stopped_at is not None:
                    print(json.dumps({"epoch": epoch, "preempted_at":
                                      trainer.stopped_at, "loss": losses}))
                    res.preempted(ckpt, epoch, metric, best)
                res.check_streak(losses, epoch)
                if trainer.autotuner is not None:
                    trainer.autotune_epoch_end(
                        epoch, profile=_load_profile(save_path))
                with tracer.span("eval", epoch=epoch):
                    meters = trainer.evaluate()
                is_best = best is None or best < meters[metric]
                if is_best:
                    best = meters[metric]
                meters[metric + "_best"] = best
                _print_meters(meters)
                for k, v in meters.items():
                    writer.add_scalar(k, v, seen)
                with tracer.span("checkpoint", epoch=epoch):
                    path = trainer.save_checkpoint(ckpt, epoch, meters,
                                                   best=is_best)
                printr(f"[save_path] = {path}")
                # the epoch's summary last, on every process
                res.last_ckpt_epoch = epoch
                print(json.dumps({
                    "epoch": epoch,
                    "ratio": trainer.compression.compress_ratio,
                    "loss": losses, "step_s": times, "eval": meters}))
        finally:
            # also on the preemption (75) and streak (70) exits: the trace
            # saved, the sink drained and closed
            writer.close()
            res.close()
            tel.close()
        return out
    finally:
        if grouped and dist.is_initialized():
            dist.destroy_process_group()


def _chain(*fns: Callable[[int, dict], None]) -> Callable[[int, dict], None]:
    def after(batch: int, metrics: dict) -> None:
        for fn in fns:
            fn(batch, metrics)
    return after


def _load_profile(save_path: str) -> Optional[Dict]:
    """``<save_path>/profile.json`` (a ``dgc-profile`` table) when there is
    a readable one, else None."""
    path = os.path.join(save_path, "profile.json")
    if not os.path.exists(path):
        return None
    try:
        return load_profile(path)
    except (ValueError, OSError, KeyError):
        return None


class _Telemetry:
    """The CLI's telemetry (the recipe's ``train.telemetry`` and
    ``train.trace``): the async sink at ``<save_path>/telemetry/`` (the
    coordinator's file, or under the fleet taps one ``host<i>/`` shard a
    process), its header the engine's ``telemetry_static`` with the run's
    topology, one record every ``every`` steps (the telemetry means, the
    guard counters, the fleet columns and the loss, still on the device:
    the sink copies them without a wait), and the host span tracer saved
    to ``<save_path>/trace.json``. Inert when both are off."""

    def __init__(self, cfg, trainer: Trainer, save_path: str,
                 elastic_info: Optional[Dict] = None):
        tc = cfg.train.get("telemetry") or {}
        self.trainer = trainer
        self.every = int(tc.get("every", 1) or 1)
        self.sink = None
        grouped = dist.is_initialized()
        rank = dist.get_rank() if grouped else 0
        if trainer.telemetry:
            sub = (os.path.join("telemetry", f"host{rank}") if trainer.fleet
                   else "telemetry")
            # a supervised run carries its supervisor's run id, so the
            # header, the supervise stream and every monitor gauge agree
            run_id = resolve_run_id()
            self.sink = TelemetrySink(
                os.path.join(save_path, sub),
                static=dict(_telemetry_static(trainer.setup),
                            world=trainer.comm.world,
                            num_local_workers=trainer.num_local,
                            process_index=rank,
                            num_processes=(dist.get_world_size() if grouped
                                           else 1),
                            **({"run_id": run_id} if run_id else {})),
                rotate_bytes=int(tc.get("rotate_mb", 64)) << 20,
                enabled=trainer.fleet or rank == 0,
                guards=trainer.guards is not None, fleet=trainer.fleet)
            printr(f"[telemetry] -> {self.sink.path or '(non-coordinator)'}"
                   + (" [fleet]" if trainer.fleet else ""))
            trainer.sink = self.sink
            if trainer.autotuner is not None:
                # refit and replan events ride the telemetry stream
                trainer.autotuner.sink = self.sink
            if elastic_info is not None:
                self.sink.write_record(dict(elastic_info,
                                            event="elastic_restart"))
        if trainer.adaptive is not None:
            printr(f"[adaptive] {trainer.adaptive}")
        trc = cfg.train.get("trace") or {}
        self.trace_path = self._trace_was = None
        if trc.get("enabled", False):
            self._trace_was = _trace.enable(True)
            trainer.tracer = _trace.SpanTracer(
                sink=self.sink,
                max_events=int(trc.get("max_events", 65536)))
            self.trace_path = os.path.join(save_path, "trace.json")
            printr(f"[trace] phase markers on; host spans -> "
                   f"{self.trace_path}")

    def on_step(self, epoch: int) -> Callable[[int, dict], None]:
        tr = self.trainer

        def after(batch: int, metrics: dict) -> None:
            if self.sink is None or batch % self.every:
                return
            stats = dict(metrics["telemetry"])
            if "guards" in metrics:
                stats.update(metrics["guards"])
            if "fleet" in metrics:
                stats.update(metrics["fleet"])
                stats["loss"] = metrics["loss"]
            seen = (epoch * tr.steps_per_epoch + batch + 1) * tr.global_batch
            self.sink.write(seen, stats)
        return after

    def close(self) -> None:
        if self.trace_path is not None:
            path = self.trainer.tracer.save(self.trace_path)
            printr(f"[trace] chrome trace -> {path} (load at "
                   "ui.perfetto.dev)")
            self.trace_path = None
            _trace.enable(self._trace_was)
        if self.sink is not None:
            self.sink.close()
            self.sink = None


class _Resilience:
    """The CLI's host-side resilience (the recipe's ``train.resilience``):
    the preemption handler and its step-boundary agreement, the watchdog,
    the flight recorder, the non-finite streak breaker and the host fault
    hooks. Inert when the block is off (the fault hooks stay armed by
    ``DGC_FAULTS``, as in the JAX harness only with resilience on)."""

    def __init__(self, rc, trainer: Trainer, save_path: str, device,
                 last_epoch: int, resume_batch: int):
        self.on = bool(rc.get("enabled", False))
        self.rc, self.trainer, self.device = rc, trainer, device
        self.last_ckpt_epoch = last_epoch
        self.gstep = ((last_epoch + 1) * trainer.steps_per_epoch
                      + resume_batch)
        self.handler = self.watchdog = self.flight = self.streak = None
        self.surgeon = self.surgery_exit = None
        self.flight_path = os.path.join(save_path, "flight.json")
        self.ckpt_dir = os.path.join(save_path, "checkpoints")
        if not self.on:
            return
        self.handler = _preempt.PreemptionHandler()
        fl = int(rc.get("flight_steps", 0) or 0)
        if fl > 0:
            eng = trainer.setup.engine
            run_id = resolve_run_id()
            self.flight = FlightRecorder(capacity=fl, static=dict(
                world=trainer.comm.world,
                num_local_workers=trainer.num_local, save_path=save_path,
                payload=getattr(eng, "payload_size", 0),
                **({"run_id": run_id} if run_id else {})))
        ns = int(rc.get("nonfinite_streak", 0) or 0)
        if ns > 0:
            self.streak = NonfiniteStreak(ns)
        wd = float(rc.get("watchdog_secs", 0) or 0)
        if wd > 0:
            # DGC_HEARTBEAT (set by a supervisor): the file whose stale
            # mtime makes the supervisor kill a hung run
            self.watchdog = _preempt.Watchdog(
                wd, sink=trainer.sink, flight=self.flight,
                flight_path=self.flight_path,
                heartbeat_path=os.environ.get("DGC_HEARTBEAT"))
        if bool(rc.get("surgery", False)):
            self.surgeon = _surgery.SurgeryCoordinator(
                os.path.join(self.ckpt_dir, _surgery.ORDER_FILE),
                boundary_timeout=float(rc.get("boundary_timeout", 60.0)),
                retries=int(rc.get("boundary_retries", 3)),
                backoff=float(rc.get("boundary_backoff", 5.0)),
                log=lambda m: printr(f"[surgery] {m}"))
        printr(f"[resilience] guards={trainer.guards} checksum="
               f"{getattr(trainer.setup.engine, 'checksum', False)} "
               f"watchdog={wd or 'off'} flight={fl or 'off'} "
               f"surgery={'on' if self.surgeon is not None else 'off'}")

    def stop(self, epoch: int) -> Optional[Callable[[int], bool]]:
        """The step-boundary check: every process agrees on a preemption
        (one tiny all-reduce with several). With surgery on, the agreement
        is the coordinator's gather of ``(preempt, verdict, target)`` with
        its deadline: an agreed excise stops the epoch as a preemption
        does, a lost cohort exits 76 at once."""
        faults = self.trainer.faults
        if self.handler is None and faults is None:
            return None

        def check(batch: int) -> bool:
            _faults.maybe_slow(faults, self.gstep)
            if self.handler is None:
                return False
            if self.surgeon is None:
                return _preempt.agree_preempt(self.handler.requested,
                                              self.device)
            ag = self.surgeon.agree(self.handler.requested)
            if ag.lost:
                self._cohort_lost(ag)
            if ag.excise or ag.preempt:
                self.surgery_exit = ag if ag.excise else None
                return True
            return False
        return check

    def _exit_record(self, agreement) -> None:
        """The exit-76 record: the verdict, the target and the process
        count the cohort ran at, for the supervisors."""
        pidx, pcount = self.surgeon._topology()
        _surgery.write_exit_record(
            os.path.join(self.ckpt_dir, _surgery.EXIT_RECORD), agreement,
            world=pcount, process_index=pidx, step=self.gstep)

    def _cohort_lost(self, agreement) -> None:
        """A member is hung or dead mid-agreement: no further collective
        (the emergency save included) can complete. Dump the flight ring,
        leave the exit record and go down hard; recovery rolls back to the
        last atomic checkpoint."""
        if self.flight is not None:
            self.flight.dump(self.flight_path, reason="surgery: cohort lost")
        self._exit_record(agreement)
        printr(f"[surgery] cohort lost at the boundary — exit "
               f"{_surgery.EXIT_SURGERY} (roll back to the last checkpoint)")
        sys.stdout.flush()
        os._exit(_surgery.EXIT_SURGERY)

    def on_step(self, epoch: int) -> Callable[[int, dict], None]:
        def after(batch: int, metrics: dict) -> None:
            self.gstep += 1
            if self.flight is not None:
                self.flight.record(self.gstep, epoch=epoch, batch=batch,
                                   loss=metrics["loss"],
                                   guards=metrics.get("guards"),
                                   spans_ms=self.trainer.tracer.step_summary(),
                                   last_ckpt_epoch=self.last_ckpt_epoch)
            if self.watchdog is not None:
                self.watchdog.beat()
            faults = self.trainer.faults
            if faults is not None:
                _faults.maybe_hang(faults, self.gstep)
                _faults.maybe_exit(faults, self.gstep)
                _faults.maybe_kill(faults, self.gstep)
        return after

    def preempted(self, ckpt: CheckpointManager, epoch: int, metric: str,
                  best) -> None:
        """The emergency exit: the flight ring, the checkpoint of the epoch
        in progress with its last trained batch, then exit 75; after an
        agreed excise, also the exit record and the consumed order
        cleared, then exit 76."""
        b = self.trainer.stopped_at
        ag = self.surgery_exit
        if ag is not None:
            printr(f"\n[surgery] excise agreed: verdict={ag.verdict} "
                   f"target={ag.target} — stopping at epoch {epoch}, "
                   f"batch {b}")
            reason = f"surgery: excise {ag.verdict} worker {ag.target}"
        else:
            printr(f"\n[preempt] signal {self.handler.signum}: stopping at "
                   f"epoch {epoch}, batch {b}")
            reason = f"preempt signal {self.handler.signum}"
        if self.flight is not None:
            p = self.flight.dump(self.flight_path, reason=reason)
            if p:
                printr(f"[preempt] flight recorder -> {p}")
        if bool(self.rc.get("emergency_checkpoint", True)):
            meters = {"preempt_batch": b}
            if best is not None:
                meters[metric + "_best"] = best
            t0 = time.perf_counter()
            path = _preempt.emergency_save(
                lambda topology: self.trainer.save_checkpoint(
                    ckpt, epoch, meters, topology=topology),
                self.trainer.topology)
            printr(f"[preempt] emergency checkpoint -> {path} "
                   f"({time.perf_counter() - t0:.2f} s)")
        if ag is not None:
            # everyone was alive at the boundary, so the save above is
            # whole: the record for the supervisors, and the consumed order
            # retired (a relaunched cohort must not excise again)
            self._exit_record(ag)
            _surgery.clear_order(self.surgeon.order_path)
        self.close()
        _preempt.clean_shutdown()
        sys.stdout.flush()
        raise SystemExit(_preempt.EXIT_PREEMPTED if ag is None
                         else _surgery.EXIT_SURGERY)

    def check_streak(self, losses: List[float], epoch: int) -> None:
        """Feed the epoch's losses to the breaker; on a trip, dump the
        flight ring and exit 70 (the state is gone; do not relaunch)."""
        if self.streak is None:
            return
        for x in losses:
            self.streak.update(x)
        if not self.streak.tripped:
            return
        printr(f"\n[resilience] {self.streak.streak} consecutive nonfinite "
               f"losses at epoch {epoch} — aborting (last checkpoint: epoch "
               f"{self.last_ckpt_epoch})")
        if self.flight is not None:
            p = self.flight.dump(self.flight_path,
                                 reason=f"nonfinite-streak x{self.streak.streak}")
            if p:
                printr(f"[resilience] flight recorder -> {p}")
        self.close()
        raise SystemExit(_preempt.EXIT_NONFINITE)

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.handler is not None:
            self.handler.uninstall()
            self.handler = None


if __name__ == "__main__":
    main()
