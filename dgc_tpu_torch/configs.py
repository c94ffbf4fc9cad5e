"""The headline recipe: ResNet-20 on CIFAR-10 with DGC at compress ratio
0.001 and the 5-epoch warm-up.

The JAX package builds it by stacking ``configs/__init__.py``,
``configs/cifar/__init__.py``, ``configs/cifar/resnet20.py``,
``configs/dgc/__init__.py`` and ``configs/dgc/wm5.py``; those files import
``dgc_tpu``, so the port carries the same values flattened into one
function.
"""

from dgc_tpu_torch.utils.config import Config

__all__ = ["resnet20_wm5"]


def resnet20_wm5() -> Config:
    """A fresh config tree (callers may edit it)."""
    num_epochs, warmup_lr_epochs = 200, 5
    return Config(
        seed=42,
        dataset=Config(root="./data/cifar10", num_classes=10, image_size=32,
                       synthetic_size=2048),
        model=Config(name="resnet20", num_classes=10),
        train=Config(
            num_epochs=num_epochs,
            batch_size=128,
            num_batches_per_step=1,
            warmup_lr_epochs=warmup_lr_epochs,
            schedule_lr_per_epoch=True,
            # cosine over the post-warm-up epochs
            scheduler=Config(name="cosine",
                             t_max=num_epochs - warmup_lr_epochs),
            optimizer=Config(lr=0.1, momentum=0.9, weight_decay=1e-4),
            compression=Config(
                compress_ratio=0.001, sample_ratio=0.01,
                strided_sample=True, compress_upper_bound=1.3,
                compress_lower_bound=0.8, max_adaptation_iters=10,
                resample=True, warmup_epochs=5,
                memory=Config(momentum=0.9)),
        ),
    )
