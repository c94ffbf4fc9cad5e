"""The recipes the port trains, each a flattened copy of the JAX package's
stacked config files (which import ``dgc_tpu``, so the port cannot read
them). Every recipe starts from ``configs/__init__.py`` (seed, the
top-1/top-5 meters, ``acc/test_top1`` as the metric):

* :func:`resnet20` and :func:`resnet110` — the dense baseline (stock SGD,
  no compression) on CIFAR-10: ``configs/cifar/__init__.py`` and
  ``configs/cifar/resnet20.py`` / ``resnet110.py``;
* :func:`resnet20_wm5` — ResNet-20 with DGC: the same plus
  ``configs/dgc/__init__.py``, ``configs/dgc/wm5.py``;
  :func:`resnet20_wm0` (``configs/dgc/wm0.py``: no warm-up),
  :func:`resnet20_wm5o` (``configs/dgc/wm5o.py``: five dense epochs),
  :func:`resnet20_wm5_nm` (``configs/dgc/nm.py`` stacked last: no
  momentum masking), and :func:`resnet110_wm5`, :func:`resnet110_wm5o`;
* :func:`resnet50_wm5` — ResNet-50 on ImageNet: ``configs/__init__.py``,
  ``configs/imagenet/__init__.py``, ``configs/imagenet/resnet50.py``,
  ``configs/dgc/__init__.py``, ``configs/dgc/wm5.py``;
  :func:`resnet50_wm5_cosine` with ``configs/imagenet/cosine.py`` stacked
  last;
* :func:`resnet18_wm5` — the same with ``configs/imagenet/resnet18.py``;
* :func:`resnet20_wm5_megakernel` and :func:`resnet50_wm5_megakernel` —
  with ``configs/dgc/megakernel.py`` stacked last;
* :func:`vgg16_bn_wm5` — VGG-16-BN on ImageNet: ``configs/__init__.py``,
  ``configs/imagenet/__init__.py``, ``configs/imagenet/vgg16_bn.py``,
  ``configs/dgc/__init__.py``, ``configs/dgc/wm5.py``; and
  :func:`vgg16_bn_wm5_bf16` with ``configs/bf16.py`` stacked last (the
  model computes in bfloat16; ``model.dtype`` names a ``torch`` dtype);
* the narrow wires and state, stacked on the wm5 recipes:
  :func:`resnet20_wm5_fp16` (``configs/dgc/fp16.py``: fp16 values and the
  fp16 dense all-reduce), :func:`resnet20_wm5_int8` (``int8.py``: int8
  values, one scale a tensor, error feedback), :func:`resnet20_wm5_int8_
  packidx` (``int8.py``, ``packidx.py``: with bit-packed indices),
  :func:`resnet50_wm5_bf16mem` (``bf16mem.py``: the bf16 error-feedback
  state) and :func:`resnet50_wm5_bf16mem_int8_packidx` (all three);
* :func:`resnet20_wm5_autotune` — ``configs/autotune.py`` stacked on
  :func:`resnet20_wm5`: the ``train.autotune`` block (``enabled``,
  ``min_points``), which the CLI's ``--autotune`` also sets
  (:func:`with_autotune`);
* :func:`resnet50_wm5_resilience` and :func:`resnet20_wm5_resilience` —
  ``configs/resilience.py`` stacked on the wm5 recipes, with its
  ``checksum`` on (the JAX harness's ``--train.resilience.checksum
  True``): the ``train.resilience`` block (the guards, the payload
  checksum, the watchdog, the emergency checkpoint, the flight recorder,
  the non-finite streak, and cohort surgery — ``surgery`` off by default,
  ``boundary_timeout``, ``boundary_retries``, ``boundary_backoff`` — which
  the CLI's ``--surgery`` turns on);
* :func:`resnet50_wm5_twotier` and :func:`resnet20_wm5_twotier` —
  ``configs/dgc/twotier.py`` stacked on the wm5 recipes:
  ``train.num_local_workers`` (8, which must divide the world; smaller
  runs set their own);
* :func:`resnet20_wm5_telemetry` and :func:`resnet50_wm5_telemetry` —
  ``configs/telemetry.py``, ``configs/fleet.py`` and ``configs/trace.py``
  stacked on the wm5 recipes (:func:`with_telemetry`): the
  ``train.telemetry`` block (``enabled``, ``every``, ``rotate_mb``,
  ``fleet``) and the ``train.trace`` block (``enabled``,
  ``max_events``); :func:`resnet50_wm5_adaptive` with
  ``configs/adaptive.py`` stacked last: the ``train.adaptive`` block
  (``enabled`` and the policy's knobs), which the CLI's ``--adaptive``
  also sets (:func:`with_adaptive`; ``--trace`` sets the trace block,
  :func:`with_trace`);
* :func:`resnet20_wm5_control` and :func:`resnet50_wm5_control` —
  ``configs/control.py`` stacked on the wm5 recipes
  (:func:`with_control`): telemetry every step with the fleet taps, and
  a resilience block with the watchdog (whose heartbeat the supervisor
  reads), the emergency checkpoint (exit 75), the flight recorder and
  the non-finite streak (exit 70) — every signal the control plane's
  rule table reads;
* :func:`resnet20_wm5_gossip` and :func:`resnet50_wm5_gossip` —
  ``configs/gossip.py`` stacked on the wm5 recipes (:func:`with_gossip`):
  the ``train.gossip`` block (``enabled``, ``topology`` "ring" or
  "hcube", ``sync_every`` and ``max_staleness``, None for the world's
  defaults ``max(2, W // 2)`` and ``max(W, sync_every)``), and the
  telemetry block with the fleet taps (where ``cfg`` lacks one), so the
  ``w_staleness`` lane and the forced-sync count reach the sink.

``train.dgc`` chooses DGC (``dgc_sgd``) or the dense baseline (stock
``sgd``), as in the reference. :data:`CONFIG_FILES` names each recipe's
stack as the JAX harness's ``--configs`` takes it (each file's package
``__init__.py`` loads first), from which the harness names the
experiment directory.
"""

from dgc_tpu_torch.utils.config import Config

__all__ = ["resnet20", "resnet110", "resnet20_wm5", "resnet20_wm0",
           "resnet20_wm5o", "resnet20_wm5_nm", "resnet110_wm5",
           "resnet110_wm5o", "resnet50_wm5", "resnet50_wm5_cosine",
           "resnet18_wm5", "resnet20_wm5_megakernel",
           "resnet50_wm5_megakernel", "vgg16_bn_wm5", "vgg16_bn_wm5_bf16",
           "resnet20_wm5_fp16", "resnet20_wm5_int8",
           "resnet20_wm5_int8_packidx", "resnet50_wm5_bf16mem",
           "resnet50_wm5_bf16mem_int8_packidx", "resnet20_wm5_autotune",
           "resnet50_wm5_resilience", "resnet20_wm5_resilience",
           "resnet50_wm5_twotier", "resnet20_wm5_twotier",
           "resnet20_wm5_telemetry", "resnet50_wm5_telemetry",
           "resnet50_wm5_adaptive", "resnet20_wm5_control",
           "resnet50_wm5_control", "resnet20_wm5_gossip",
           "resnet50_wm5_gossip", "with_autotune", "with_resilience",
           "with_telemetry", "with_trace", "with_adaptive", "with_control",
           "with_gossip", "RECIPES", "CONFIG_FILES"]


def _meters() -> Config:
    """``configs/__init__.py``'s meters: ``{split}`` is filled in by the
    evaluation."""
    return Config({"acc/{}_top1": Config(k=1), "acc/{}_top5": Config(k=5)})


def _dgc() -> Config:
    """``configs/dgc/__init__.py`` + ``configs/dgc/wm5.py``, with the
    compressor's and the memory's defaults for what they leave unset."""
    return Config(
        compress_ratio=0.001, sample_ratio=0.01,
        strided_sample=True, compress_upper_bound=1.3,
        compress_lower_bound=0.8, max_adaptation_iters=10, resample=True,
        warmup_epochs=5, warmup_coeff=None, fused_select=False,
        megakernel=False, fp16_values=False, int8_values=False,
        int8_error_feedback=True, packed_indices=False, int32_indices=True,
        memory=Config(momentum=0.9, nesterov=False, momentum_masking=True,
                      dtype=None))


def _cifar(model: str, dgc: bool) -> Config:
    """CIFAR-10 with ``model``: the dense baseline, or with ``dgc`` the
    wm5 recipe."""
    num_epochs, warmup_lr_epochs = 200, 5
    return Config(
        seed=42,
        dataset=Config(name="cifar", root="./data/cifar10", num_classes=10,
                       image_size=32, synthetic_size=2048),
        model=Config(name=model, num_classes=10, zero_init_residual=False,
                     dtype="float32"),
        train=Config(
            dgc=dgc,
            num_epochs=num_epochs,
            batch_size=128,
            num_batches_per_step=1,
            warmup_lr_epochs=warmup_lr_epochs,
            schedule_lr_per_epoch=True,
            optimize_bn_separately=False,
            # cosine over the post-warm-up epochs
            scheduler=Config(name="cosine",
                             t_max=num_epochs - warmup_lr_epochs),
            optimizer=Config(lr=0.1, momentum=0.9, weight_decay=1e-4,
                             nesterov=False),
            compression=_dgc() if dgc else Config(name="none"),
            metric="acc/test_top1",
            meters=_meters(),
        ),
    )


def resnet20() -> Config:
    """The dense baseline: ResNet-20, stock SGD, no compression. Each
    recipe returns a fresh config tree (callers may edit it)."""
    return _cifar("resnet20", dgc=False)


def resnet110() -> Config:
    """The dense baseline on ResNet-110."""
    return _cifar("resnet110", dgc=False)


def resnet20_wm5() -> Config:
    """ResNet-20 with DGC at ratio 0.001 and the 5-epoch warm-up."""
    return _cifar("resnet20", dgc=True)


def resnet20_wm0() -> Config:
    """:func:`resnet20_wm5` without the warm-up (``wm0.py``)."""
    cfg = resnet20_wm5()
    cfg.train.compression.warmup_epochs = 0
    return cfg


def _wm5o(cfg: Config) -> Config:
    """``configs/dgc/wm5o.py``: the five warm-up epochs at ratio 1."""
    cfg.train.compression.warmup_coeff = [1, 1, 1, 1, 1]
    return cfg


def resnet20_wm5o() -> Config:
    """ResNet-20 with DGC after five dense epochs."""
    return _wm5o(resnet20_wm5())


def resnet20_wm5_nm() -> Config:
    """:func:`resnet20_wm5` with ``configs/dgc/nm.py``: the momentum is
    not masked where a coordinate was sent."""
    cfg = resnet20_wm5()
    cfg.train.compression.memory.momentum_masking = False
    return cfg


def resnet110_wm5() -> Config:
    """ResNet-110 with DGC at ratio 0.001 and the 5-epoch warm-up."""
    return _cifar("resnet110", dgc=True)


def resnet110_wm5o() -> Config:
    """ResNet-110 with DGC after five dense epochs."""
    return _wm5o(resnet110_wm5())


def _imagenet(model: str, batch_size: int, lr: float, weight_decay: float,
              nesterov: bool, optimize_bn_separately: bool) -> Config:
    num_epochs, warmup_lr_epochs = 90, 5
    return Config(
        seed=42,
        dataset=Config(name="imagenet", root="./data/imagenet",
                       num_classes=1000, image_size=224, synthetic_size=512,
                       synthetic_fallback=True),
        model=Config(name=model, num_classes=1000, zero_init_residual=True,
                     dtype="float32"),
        train=Config(
            dgc=True,
            num_epochs=num_epochs,
            batch_size=batch_size,
            num_batches_per_step=1,
            warmup_lr_epochs=warmup_lr_epochs,
            schedule_lr_per_epoch=True,
            # BN parameters without weight decay
            optimize_bn_separately=optimize_bn_separately,
            # MultiStep with the milestones shifted by the warm-up epochs
            scheduler=Config(name="multistep",
                             milestones=[e - warmup_lr_epochs
                                         for e in (30, 60, 80)],
                             gamma=0.1),
            optimizer=Config(lr=lr, momentum=0.9, weight_decay=weight_decay,
                             nesterov=nesterov),
            compression=_dgc(),
            metric="acc/test_top1",
            meters=_meters(),
        ),
    )


def resnet50_wm5() -> Config:
    """ResNet-50 / ImageNet: batch 32, lr 0.0125, weight decay 1e-4 off
    the BatchNorm parameters, nesterov, zero-init residuals."""
    return _imagenet("resnet50", batch_size=32, lr=0.0125,
                     weight_decay=1e-4, nesterov=True,
                     optimize_bn_separately=True)


def resnet50_wm5_cosine() -> Config:
    """:func:`resnet50_wm5` with ``configs/imagenet/cosine.py``: cosine
    over the post-warm-up epochs instead of the step decay."""
    cfg = resnet50_wm5()
    cfg.train.scheduler = Config(
        name="cosine", t_max=cfg.train.num_epochs - cfg.train.warmup_lr_epochs)
    return cfg


def resnet18_wm5() -> Config:
    """ResNet-18 / ImageNet: batch 64, lr 0.025, weight decay 5e-5 on every
    parameter, zero-init residuals."""
    return _imagenet("resnet18", batch_size=64, lr=0.025,
                     weight_decay=5e-5, nesterov=False,
                     optimize_bn_separately=False)


def _megakernel(cfg: Config) -> Config:
    """``configs/dgc/megakernel.py`` stacked on a recipe."""
    cfg.train.compression.megakernel = True
    return cfg


def resnet20_wm5_megakernel() -> Config:
    """:func:`resnet20_wm5` on the megakernel route."""
    return _megakernel(resnet20_wm5())


def resnet50_wm5_megakernel() -> Config:
    """:func:`resnet50_wm5` on the megakernel route."""
    return _megakernel(resnet50_wm5())


def vgg16_bn_wm5() -> Config:
    """VGG-16-BN / ImageNet: batch 32, lr 0.0125, weight decay 5e-5 on
    every parameter, no nesterov, dropout 0.5 in the classifier."""
    cfg = _imagenet("vgg16_bn", batch_size=32, lr=0.0125,
                    weight_decay=5e-5, nesterov=False,
                    optimize_bn_separately=False)
    cfg.model.zero_init_residual = False
    return cfg


def vgg16_bn_wm5_bf16() -> Config:
    """:func:`vgg16_bn_wm5` with ``configs/bf16.py``: bfloat16 compute,
    parameters, gradients and compression in f32."""
    cfg = vgg16_bn_wm5()
    cfg.model.dtype = "bfloat16"
    return cfg


def _wires(cfg: Config, fp16=False, int8=False, packidx=False,
           bf16mem=False) -> Config:
    """``configs/dgc/fp16.py``, ``int8.py``, ``packidx.py`` and
    ``bf16mem.py`` stacked on a recipe."""
    cc = cfg.train.compression
    cc.fp16_values = cc.fp16_values or fp16
    cc.int8_values = cc.int8_values or int8
    cc.packed_indices = cc.packed_indices or packidx
    if bf16mem:
        cc.memory.dtype = "bfloat16"
    return cfg


def resnet20_wm5_fp16() -> Config:
    """:func:`resnet20_wm5` on the fp16 wire."""
    return _wires(resnet20_wm5(), fp16=True)


def resnet20_wm5_int8() -> Config:
    """:func:`resnet20_wm5` on the int8 wire (error feedback on)."""
    return _wires(resnet20_wm5(), int8=True)


def resnet20_wm5_int8_packidx() -> Config:
    """:func:`resnet20_wm5` on the int8 wire with bit-packed indices."""
    return _wires(resnet20_wm5(), int8=True, packidx=True)


def resnet50_wm5_bf16mem() -> Config:
    """:func:`resnet50_wm5` with the bf16 error-feedback state."""
    return _wires(resnet50_wm5(), bf16mem=True)


def resnet50_wm5_bf16mem_int8_packidx() -> Config:
    """:func:`resnet50_wm5` with the bf16 error-feedback state, the int8
    wire and bit-packed indices."""
    return _wires(resnet50_wm5(), int8=True, packidx=True, bf16mem=True)


def with_autotune(cfg: Config) -> Config:
    """``configs/autotune.py`` stacked on a recipe: online replanning of
    the exchange, with the points a refit needs first."""
    cfg.train.autotune = Config(enabled=True, min_points=2)
    return cfg


def resnet20_wm5_autotune() -> Config:
    """:func:`resnet20_wm5` with the exchange replanned online."""
    return with_autotune(resnet20_wm5())


def with_resilience(cfg: Config, checksum: bool = True) -> Config:
    """``configs/resilience.py`` stacked on ``cfg`` (its ``checksum`` as
    given: the file's default is off)."""
    cfg.train.resilience = Config(
        enabled=True, nonfinite_guard=True, spike_window=0,
        spike_factor=10.0, checksum=checksum, watchdog_secs=300,
        emergency_checkpoint=True, flight_steps=256, nonfinite_streak=3,
        surgery=False, boundary_timeout=60.0, boundary_retries=3,
        boundary_backoff=5.0)
    return cfg


def resnet50_wm5_resilience() -> Config:
    """:func:`resnet50_wm5` with the resilience layer and the checksum."""
    return with_resilience(resnet50_wm5())


def resnet20_wm5_resilience() -> Config:
    """:func:`resnet20_wm5` with the resilience layer and the checksum."""
    return with_resilience(resnet20_wm5())


def _twotier(cfg: Config) -> Config:
    """``configs/dgc/twotier.py``: eight workers a node."""
    cfg.train.num_local_workers = 8
    return cfg


def resnet50_wm5_twotier() -> Config:
    """:func:`resnet50_wm5` over the two-tier exchange."""
    return _twotier(resnet50_wm5())


def resnet20_wm5_twotier() -> Config:
    """:func:`resnet20_wm5` over the two-tier exchange."""
    return _twotier(resnet20_wm5())


def with_trace(cfg: Config) -> Config:
    """``configs/trace.py`` stacked on ``cfg``: the phase markers and the
    host spans, at most ``max_events`` spans kept for ``trace.json``."""
    cfg.train.trace = Config(enabled=True, max_events=65536)
    return cfg


def with_adaptive(cfg: Config) -> Config:
    """``configs/adaptive.py`` stacked on ``cfg``: the straggler-adaptive
    exchange's policy, and the fleet taps it reads (with the telemetry
    block where ``cfg`` lacks one)."""
    if "telemetry" not in cfg.train:
        cfg.train.telemetry = Config(enabled=True, every=1, rotate_mb=64)
    cfg.train.telemetry.fleet = True
    if "adaptive" not in cfg.train:
        cfg.train.adaptive = Config()
    cfg.train.adaptive.update(
        enabled=True, engage_gap_ms=100.0, min_frac=0.25, ramp_ms=500.0,
        deadline_factor=4.0, partial_frac=0.02, floor_ms=1.0)
    return cfg


def with_telemetry(cfg: Config, fleet: bool = True,
                   trace: bool = True) -> Config:
    """``configs/telemetry.py`` stacked on ``cfg``, then
    ``configs/fleet.py`` (``fleet``) and ``configs/trace.py``
    (``trace``)."""
    cfg.train.telemetry = Config(enabled=True, every=1, rotate_mb=64)
    if fleet:
        cfg.train.telemetry.fleet = True
    if trace:
        with_trace(cfg)
    return cfg


def resnet20_wm5_telemetry() -> Config:
    """:func:`resnet20_wm5` with the telemetry taps, the fleet gather and
    the tracing."""
    return with_telemetry(resnet20_wm5())


def resnet50_wm5_telemetry() -> Config:
    """:func:`resnet50_wm5` with the telemetry taps, the fleet gather and
    the tracing."""
    return with_telemetry(resnet50_wm5())


def resnet50_wm5_adaptive() -> Config:
    """:func:`resnet50_wm5_telemetry` with the straggler-adaptive
    exchange."""
    return with_adaptive(resnet50_wm5_telemetry())


def with_control(cfg: Config) -> Config:
    """``configs/control.py`` stacked on ``cfg``: the telemetry block
    (where ``cfg`` lacks one) with the fleet taps, and the resilience
    block (where ``cfg`` lacks one) without the checksum."""
    if "telemetry" not in cfg.train:
        cfg.train.telemetry = Config(enabled=True, every=1, rotate_mb=64)
    cfg.train.telemetry.fleet = True
    if "resilience" not in cfg.train:
        cfg.train.resilience = Config(
            enabled=True, nonfinite_guard=True, spike_window=0,
            spike_factor=10.0, checksum=False, watchdog_secs=300,
            emergency_checkpoint=True, flight_steps=256,
            nonfinite_streak=3)
    return cfg


def resnet20_wm5_control() -> Config:
    """:func:`resnet20_wm5` with every signal the control plane reads."""
    return with_control(resnet20_wm5())


def resnet50_wm5_control() -> Config:
    """:func:`resnet50_wm5` with every signal the control plane reads."""
    return with_control(resnet50_wm5())


def with_gossip(cfg: Config, topology: str = "ring", sync_every=None,
                max_staleness=None) -> Config:
    """``configs/gossip.py`` stacked on ``cfg``: the gossip exchange's
    opt-in (``train.gossip``: most sparse rounds exchange with a rotating
    ``topology`` neighborhood, a full sync every ``sync_every`` rounds or
    when an age would pass ``max_staleness``; None: the world's
    defaults), and the fleet taps (with the telemetry block where ``cfg``
    lacks one), which carry the staleness lane."""
    if "telemetry" not in cfg.train:
        cfg.train.telemetry = Config(enabled=True, every=1, rotate_mb=64)
    cfg.train.telemetry.fleet = True
    if "gossip" not in cfg.train:
        cfg.train.gossip = Config()
    cfg.train.gossip.update(enabled=True, topology=topology,
                            sync_every=sync_every,
                            max_staleness=max_staleness)
    return cfg


def resnet20_wm5_gossip() -> Config:
    """:func:`resnet20_wm5` on the gossip exchange (ring)."""
    return with_gossip(resnet20_wm5())


def resnet50_wm5_gossip() -> Config:
    """:func:`resnet50_wm5` on the gossip exchange (ring)."""
    return with_gossip(resnet50_wm5())


#: the ``--config`` names of the training CLI
RECIPES = {f.__name__: f for f in (
    resnet20, resnet110, resnet20_wm5, resnet20_wm0, resnet20_wm5o,
    resnet20_wm5_nm, resnet110_wm5, resnet110_wm5o, resnet50_wm5,
    resnet50_wm5_cosine, resnet18_wm5, resnet20_wm5_megakernel,
    resnet50_wm5_megakernel, vgg16_bn_wm5, vgg16_bn_wm5_bf16,
    resnet20_wm5_fp16, resnet20_wm5_int8, resnet20_wm5_int8_packidx,
    resnet50_wm5_bf16mem, resnet50_wm5_bf16mem_int8_packidx,
    resnet20_wm5_autotune, resnet50_wm5_resilience, resnet20_wm5_resilience,
    resnet50_wm5_twotier, resnet20_wm5_twotier, resnet20_wm5_telemetry,
    resnet50_wm5_telemetry, resnet50_wm5_adaptive, resnet20_wm5_control,
    resnet50_wm5_control, resnet20_wm5_gossip, resnet50_wm5_gossip)}

_R20, _R110 = "configs/cifar/resnet20.py", "configs/cifar/resnet110.py"
_R50, _R18 = "configs/imagenet/resnet50.py", "configs/imagenet/resnet18.py"
_VGG = "configs/imagenet/vgg16_bn.py"
_WM5, _MK = "configs/dgc/wm5.py", "configs/dgc/megakernel.py"
_I8, _PK = "configs/dgc/int8.py", "configs/dgc/packidx.py"
_BF16MEM = "configs/dgc/bf16mem.py"
_RES, _TT = "configs/resilience.py", "configs/dgc/twotier.py"
_TELEM = ("configs/telemetry.py", "configs/fleet.py", "configs/trace.py")

#: each recipe's config files, in the JAX harness's ``--configs`` order
CONFIG_FILES = {
    "resnet20": (_R20,),
    "resnet110": (_R110,),
    "resnet20_wm5": (_R20, _WM5),
    "resnet20_wm0": (_R20, "configs/dgc/wm0.py"),
    "resnet20_wm5o": (_R20, "configs/dgc/wm5o.py"),
    "resnet20_wm5_nm": (_R20, _WM5, "configs/dgc/nm.py"),
    "resnet110_wm5": (_R110, _WM5),
    "resnet110_wm5o": (_R110, "configs/dgc/wm5o.py"),
    "resnet50_wm5": (_R50, _WM5),
    "resnet50_wm5_cosine": (_R50, _WM5, "configs/imagenet/cosine.py"),
    "resnet18_wm5": (_R18, _WM5),
    "resnet20_wm5_megakernel": (_R20, _WM5, _MK),
    "resnet50_wm5_megakernel": (_R50, _WM5, _MK),
    "vgg16_bn_wm5": (_VGG, _WM5),
    "vgg16_bn_wm5_bf16": (_VGG, _WM5, "configs/bf16.py"),
    "resnet20_wm5_fp16": (_R20, _WM5, "configs/dgc/fp16.py"),
    "resnet20_wm5_int8": (_R20, _WM5, _I8),
    "resnet20_wm5_int8_packidx": (_R20, _WM5, _I8, _PK),
    "resnet50_wm5_bf16mem": (_R50, _WM5, _BF16MEM),
    "resnet50_wm5_bf16mem_int8_packidx": (_R50, _WM5, _BF16MEM, _I8, _PK),
    "resnet20_wm5_autotune": (_R20, _WM5, "configs/autotune.py"),
    "resnet50_wm5_resilience": (_R50, _WM5, _RES),
    "resnet20_wm5_resilience": (_R20, _WM5, _RES),
    "resnet50_wm5_twotier": (_R50, _WM5, _TT),
    "resnet20_wm5_twotier": (_R20, _WM5, _TT),
    "resnet20_wm5_telemetry": (_R20, _WM5) + _TELEM,
    "resnet50_wm5_telemetry": (_R50, _WM5) + _TELEM,
    "resnet50_wm5_adaptive": (_R50, _WM5) + _TELEM
    + ("configs/adaptive.py",),
    "resnet20_wm5_control": (_R20, _WM5, "configs/control.py"),
    "resnet50_wm5_control": (_R50, _WM5, "configs/control.py"),
    "resnet20_wm5_gossip": (_R20, _WM5, "configs/gossip.py"),
    "resnet50_wm5_gossip": (_R50, _WM5, "configs/gossip.py"),
}
