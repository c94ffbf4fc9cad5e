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
  with ``configs/dgc/megakernel.py`` stacked last.

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
           "resnet50_wm5_megakernel", "RECIPES", "CONFIG_FILES"]


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
        megakernel=False,
        memory=Config(momentum=0.9, nesterov=False, momentum_masking=True))


def _cifar(model: str, dgc: bool) -> Config:
    """CIFAR-10 with ``model``: the dense baseline, or with ``dgc`` the
    wm5 recipe."""
    num_epochs, warmup_lr_epochs = 200, 5
    return Config(
        seed=42,
        dataset=Config(name="cifar", root="./data/cifar10", num_classes=10,
                       image_size=32, synthetic_size=2048),
        model=Config(name=model, num_classes=10, zero_init_residual=False),
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
                       num_classes=1000, image_size=224, synthetic_size=512),
        model=Config(name=model, num_classes=1000, zero_init_residual=True),
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


#: the ``--config`` names of the training CLI
RECIPES = {f.__name__: f for f in (
    resnet20, resnet110, resnet20_wm5, resnet20_wm0, resnet20_wm5o,
    resnet20_wm5_nm, resnet110_wm5, resnet110_wm5o, resnet50_wm5,
    resnet50_wm5_cosine, resnet18_wm5, resnet20_wm5_megakernel,
    resnet50_wm5_megakernel)}

_R20, _R110 = "configs/cifar/resnet20.py", "configs/cifar/resnet110.py"
_R50, _R18 = "configs/imagenet/resnet50.py", "configs/imagenet/resnet18.py"
_WM5, _MK = "configs/dgc/wm5.py", "configs/dgc/megakernel.py"

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
}
