"""ImageNet ResNets (ResNet-18 / ResNet-50) as ``nn.Module``s.

Counterpart of ``dgc_tpu/models/resnet_imagenet.py`` (flax): a 7x7/64
stride-2 stem, BatchNorm, ReLU and a 3x3 stride-2 max-pool with padding 1,
four stages at 64/128/256/512 channels (BasicBlock x [2, 2, 2, 2] for
ResNet-18; Bottleneck x [3, 4, 6, 3] with 4x expansion for ResNet-50),
stride 2 at the first block of stages 2-4, a 1x1 projection shortcut
wherever a block changes shape, global average pooling and a linear
classifier.

Parameters keep the flax layout and names, as in
:mod:`dgc_tpu_torch.models.resnet_cifar` (HWIO conv kernels, ``[in, out]``
dense kernel; ``Conv_0``, ``BatchNorm_0``, ``Bottleneck_0`` ...), because
the flat-buffer layout, and with it every selection, is a function of
element order. A block's projection is its last conv and BatchNorm
(``Conv_2``/``BatchNorm_2`` in a BasicBlock, ``Conv_3``/``BatchNorm_3`` in
a Bottleneck), as flax numbers them in call order. BatchNorm: momentum
0.9, eps 1e-5. ``zero_init_residual`` starts the scale of each block's
last BatchNorm of the residual branch at zero.
"""

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from dgc_tpu_torch.models.resnet_cifar import BatchNorm, Conv, Dense
from dgc_tpu_torch.models.resnet_cifar import init_variables as _init_base

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet50",
           "init_variables"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, 3, stride, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(channels, dtype)
        self.Conv_1 = Conv(channels, channels, 3, 1, 1, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(channels, dtype)
        self.zero_init_residual = zero_init_residual
        self.project = stride != 1 or cin != channels
        if self.project:
            self.Conv_2 = Conv(cin, channels, 1, stride, 0, dtype=dtype)
            self.BatchNorm_2 = BatchNorm(channels, dtype)

    def last_bn(self) -> BatchNorm:
        return self.BatchNorm_1

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.BatchNorm_2(self.Conv_2(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = channels * self.expansion
        self.Conv_0 = Conv(cin, channels, 1, 1, 0, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(channels, dtype)
        self.Conv_1 = Conv(channels, channels, 3, stride, 1, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(channels, dtype)
        self.Conv_2 = Conv(channels, out, 1, 1, 0, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, dtype)
        self.zero_init_residual = zero_init_residual
        self.project = stride != 1 or cin != out
        if self.project:
            self.Conv_3 = Conv(cin, out, 1, stride, 0, dtype=dtype)
            self.BatchNorm_3 = BatchNorm(out, dtype)

    def last_bn(self) -> BatchNorm:
        return self.BatchNorm_2

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = (self.BatchNorm_3(self.Conv_3(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Input NCHW f32; computes in ``dtype``; returns f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[nn.Module],
                 num_classes: int = 1000, zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 7, 2, 3, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64, dtype)
        cin, b = 64, 0
        for i, n_blocks in enumerate(stage_sizes):
            channels = 64 * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"{block.__name__}_{b}",
                        block(cin, channels, stride, zero_init_residual,
                              dtype))
                cin, b = channels * block.expansion, b + 1
        self.block_names = [f"{block.__name__}_{i}" for i in range(b)]
        self.Dense_0 = Dense(cin, num_classes, dtype)

    def forward(self, x, train: bool = True):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean(dim=(2, 3))).float()


def resnet18(num_classes: int = 1000, zero_init_residual: bool = False,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, zero_init_residual,
                  dtype)


def resnet50(num_classes: int = 1000, zero_init_residual: bool = False,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes, zero_init_residual,
                  dtype)


@torch.no_grad()
def init_variables(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisation (kaiming-normal fan_out convolutions,
    truncated lecun-normal dense kernel, unit BatchNorm scales, zero
    biases and statistics), then a zero scale on each block's last
    residual-branch BatchNorm where ``zero_init_residual``."""
    _init_base(model, generator)
    for mod in model.modules():
        if isinstance(mod, (BasicBlock, Bottleneck)) and \
                mod.zero_init_residual:
            mod.last_bn().scale.zero_()
