"""The recipes the port trains, each a flattened copy of the JAX package's
stacked config files (which import ``dgc_tpu``, so the port cannot read
them):

* :func:`resnet20_wm5` — ResNet-20 on CIFAR-10: ``configs/__init__.py``,
  ``configs/cifar/__init__.py``, ``configs/cifar/resnet20.py``,
  ``configs/dgc/__init__.py``, ``configs/dgc/wm5.py``;
* :func:`resnet50_wm5` — ResNet-50 on ImageNet: ``configs/__init__.py``,
  ``configs/imagenet/__init__.py``, ``configs/imagenet/resnet50.py``,
  ``configs/dgc/__init__.py``, ``configs/dgc/wm5.py``;
* :func:`resnet18_wm5` — the same with ``configs/imagenet/resnet18.py``;
* :func:`resnet20_wm5_megakernel` and :func:`resnet50_wm5_megakernel` —
  the first two with ``configs/dgc/megakernel.py`` stacked last.

All use DGC at compress ratio 0.001 with the 5-epoch warm-up.
"""

from dgc_tpu_torch.utils.config import Config

__all__ = ["resnet20_wm5", "resnet50_wm5", "resnet18_wm5",
           "resnet20_wm5_megakernel", "resnet50_wm5_megakernel", "RECIPES"]


def _dgc() -> Config:
    """``configs/dgc/__init__.py`` + ``configs/dgc/wm5.py``, with the
    compressor's default ``fused_select`` and ``megakernel`` (off)."""
    return Config(
        compress_ratio=0.001, sample_ratio=0.01, strided_sample=True,
        compress_upper_bound=1.3, compress_lower_bound=0.8,
        max_adaptation_iters=10, resample=True, warmup_epochs=5,
        fused_select=False, megakernel=False, memory=Config(momentum=0.9))


def resnet20_wm5() -> Config:
    """A fresh config tree (callers may edit it)."""
    num_epochs, warmup_lr_epochs = 200, 5
    return Config(
        seed=42,
        dataset=Config(name="cifar", root="./data/cifar10", num_classes=10,
                       image_size=32, synthetic_size=2048),
        model=Config(name="resnet20", num_classes=10,
                     zero_init_residual=False),
        train=Config(
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
            compression=_dgc(),
        ),
    )


def _imagenet(model: str, batch_size: int, lr: float, weight_decay: float,
              nesterov: bool, optimize_bn_separately: bool) -> Config:
    num_epochs, warmup_lr_epochs = 90, 5
    return Config(
        seed=42,
        dataset=Config(name="imagenet", root="./data/imagenet",
                       num_classes=1000, image_size=224, synthetic_size=512),
        model=Config(name=model, num_classes=1000, zero_init_residual=True),
        train=Config(
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
        ),
    )


def resnet50_wm5() -> Config:
    """ResNet-50 / ImageNet: batch 32, lr 0.0125, weight decay 1e-4 off
    the BatchNorm parameters, nesterov, zero-init residuals."""
    return _imagenet("resnet50", batch_size=32, lr=0.0125,
                     weight_decay=1e-4, nesterov=True,
                     optimize_bn_separately=True)


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
RECIPES = {"resnet20_wm5": resnet20_wm5, "resnet50_wm5": resnet50_wm5,
           "resnet18_wm5": resnet18_wm5,
           "resnet20_wm5_megakernel": resnet20_wm5_megakernel,
           "resnet50_wm5_megakernel": resnet50_wm5_megakernel}
