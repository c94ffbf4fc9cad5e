"""VGG-16 with BatchNorm as an ``nn.Module``.

Counterpart of ``dgc_tpu/models/vgg.py`` (flax): 3x3 convolutions with
biases, each followed by BatchNorm and ReLU, at the stages of ``cfg``
(``"M"`` a 2x2 max-pool), then a 4096-4096-``num_classes`` classifier with
ReLU and dropout after each of its first two layers.

Parameters keep flax's names and layouts, as in
:mod:`dgc_tpu_torch.models.resnet_cifar`: ``Conv_0`` .. ``Conv_12`` (HWIO
kernels and biases), ``BatchNorm_0`` .. ``BatchNorm_12`` (momentum 0.9, eps
1e-5), ``Dense_0`` .. ``Dense_2`` (``[in, out]`` kernels). The feature map
is flattened in flax's (h, w, c) order before ``Dense_0``, so a carried
``Dense_0`` kernel computes the same function. An input that does not
reach the classifier at 7x7 is average-pooled to 7x7, which needs both
sides to be multiples of 7 (224 inputs arrive at 7x7).

Dropout is flax's: ``keep = 1 - rate``, the mask ``uniform < keep``, the
output ``where(mask, x / keep, 0)``. Its uniforms come from the
``torch.Generator`` the caller passes to ``forward`` (the train step gives
each worker its own, seeded from the run seed and the rank); a training
forward at a rate above 0 without one raises, and an evaluation
(``train=False``) draws nothing.
"""

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from dgc_tpu_torch.models.resnet_cifar import BatchNorm, Conv, Dense
from dgc_tpu_torch.models.resnet_cifar import init_variables

__all__ = ["VGG", "VGG16_CFG", "vgg16_bn", "dropout", "init_variables"]

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout`` at ``rate`` with the uniforms drawn from
    ``generator`` (on ``x``'s device)."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


class VGG(nn.Module):
    """Input NCHW f32; computes in ``dtype``; returns f32 logits."""

    def __init__(self, cfg: Sequence[Union[int, str]] = VGG16_CFG,
                 num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        cin, i = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            setattr(self, f"Conv_{i}", Conv(cin, v, 3, 1, 1, bias=True,
                                            dtype=dtype))
            setattr(self, f"BatchNorm_{i}", BatchNorm(v, dtype))
            cin, i = v, i + 1
        self.Dense_0 = Dense(7 * 7 * cin, 4096, dtype)
        self.Dense_1 = Dense(4096, 4096, dtype)
        self.Dense_2 = Dense(4096, num_classes, dtype)

    def _dropout(self, x, train: bool, generator):
        if not train or self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("a training forward with dropout needs its "
                             "generator (dropout_generator=...)")
        return dropout(x, self.dropout_rate, generator)

    def forward(self, x, train: bool = True,
                dropout_generator: Optional[torch.Generator] = None):
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Conv_{i}")(x), train))
            i += 1
        h, w = x.shape[2], x.shape[3]
        if (h, w) != (7, 7):
            if h % 7 or w % 7:
                raise ValueError("VGG input spatial dims must reduce to a "
                                 f"multiple of 7, got {h}x{w}")
            x = F.avg_pool2d(x, (h // 7, w // 7))
        # flax flattens NHWC: (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self._dropout(F.relu(self.Dense_0(x)), train, dropout_generator)
        x = self._dropout(F.relu(self.Dense_1(x)), train, dropout_generator)
        return self.Dense_2(x).float()


def vgg16_bn(num_classes: int = 1000, **kwargs) -> VGG:
    return VGG(num_classes=num_classes, **kwargs)
