"""dgc_tpu_torch.models — the ResNets and VGG-16-BN, and what the train
step needs of any model: its parameters and BatchNorm statistics as
flax-shaped trees, its compute dtype and whether it draws dropout.

:func:`create` builds a model by the name a config gives it
(``resnet20``, ``resnet110``, ``resnet18``, ``resnet50``, ``vgg16_bn``) in
a compute dtype and initialises it from a generator with the reference's
recipe."""

from typing import Dict

import torch
from torch import nn

from dgc_tpu_torch.utils.pytree import nest

__all__ = ["param_tree", "stats_tree", "create", "from_config",
           "compute_dtype", "uses_dropout"]


def param_tree(model: nn.Module) -> Dict:
    """The parameters as a nested dict with flax's structure and names."""
    return nest(dict(model.named_parameters()), sep=".")


def stats_tree(model: nn.Module) -> Dict:
    """The BatchNorm running statistics as flax's ``batch_stats`` tree."""
    return nest(dict(model.named_buffers()), sep=".")


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The dtype the model computes in (its parameters stay f32)."""
    return getattr(model, "dtype", torch.float32)


def uses_dropout(model: nn.Module) -> bool:
    """Whether a training forward draws dropout masks (and so needs a
    ``dropout_generator``)."""
    return getattr(model, "dropout_rate", 0.0) > 0.0


def create(name: str, num_classes: int, generator: torch.Generator,
           zero_init_residual: bool = False,
           dtype: torch.dtype = torch.float32, **vgg_kwargs) -> nn.Module:
    """Model ``name`` with ``num_classes`` outputs computing in ``dtype``,
    initialised from ``generator``; ``vgg_kwargs`` (``cfg``,
    ``dropout_rate``) reach VGG, as a flax config's model keys do."""
    from dgc_tpu_torch.models import resnet_cifar, resnet_imagenet, vgg
    if name in ("resnet20", "resnet110"):
        if zero_init_residual:
            raise ValueError(f"{name} has no zero_init_residual option")
        model = getattr(resnet_cifar, name)(num_classes, dtype)
        resnet_cifar.init_variables(model, generator)
    elif name in ("resnet18", "resnet50"):
        model = getattr(resnet_imagenet, name)(num_classes,
                                               zero_init_residual, dtype)
        resnet_imagenet.init_variables(model, generator)
    elif name == "vgg16_bn":
        if zero_init_residual:
            raise ValueError(f"{name} has no zero_init_residual option")
        model = vgg.vgg16_bn(num_classes, dtype=dtype, **vgg_kwargs)
        vgg.init_variables(model, generator)
    else:
        raise ValueError(f"unknown model {name!r}")
    if vgg_kwargs and name != "vgg16_bn":
        raise ValueError(f"{name} takes no {sorted(vgg_kwargs)}")
    return model


def from_config(mc, generator: torch.Generator) -> nn.Module:
    """:func:`create` from a recipe's ``model`` config (``name``,
    ``num_classes``, ``zero_init_residual``, ``dtype`` named as a
    ``torch`` attribute, float32 by default; VGG's ``cfg`` and
    ``dropout_rate`` where given)."""
    return create(mc.name, mc.num_classes, generator, mc.zero_init_residual,
                  getattr(torch, mc.get("dtype", "float32")),
                  **{k: mc[k] for k in ("cfg", "dropout_rate") if k in mc})
