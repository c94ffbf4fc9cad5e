"""dgc_tpu_torch.models — the ResNets, and what the train step needs of
any model: its parameters and BatchNorm statistics as flax-shaped trees.

:func:`create` builds a model by the name a config gives it
(``resnet20``, ``resnet110``, ``resnet18``, ``resnet50``) and initialises
it from a generator with the reference's recipe."""

from typing import Dict

import torch
from torch import nn

from dgc_tpu_torch.utils.pytree import nest

__all__ = ["param_tree", "stats_tree", "create"]


def param_tree(model: nn.Module) -> Dict:
    """The parameters as a nested dict with flax's structure and names."""
    return nest(dict(model.named_parameters()), sep=".")


def stats_tree(model: nn.Module) -> Dict:
    """The BatchNorm running statistics as flax's ``batch_stats`` tree."""
    return nest(dict(model.named_buffers()), sep=".")


def create(name: str, num_classes: int, generator: torch.Generator,
           zero_init_residual: bool = False) -> nn.Module:
    """Model ``name`` with ``num_classes`` outputs, initialised from
    ``generator``."""
    from dgc_tpu_torch.models import resnet_cifar, resnet_imagenet
    if name in ("resnet20", "resnet110"):
        if zero_init_residual:
            raise ValueError(f"{name} has no zero_init_residual option")
        model = getattr(resnet_cifar, name)(num_classes)
        resnet_cifar.init_variables(model, generator)
    elif name in ("resnet18", "resnet50"):
        model = getattr(resnet_imagenet, name)(num_classes,
                                               zero_init_residual)
        resnet_imagenet.init_variables(model, generator)
    else:
        raise ValueError(f"unknown model {name!r}")
    return model
