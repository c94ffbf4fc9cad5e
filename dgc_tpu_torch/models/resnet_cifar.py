"""CIFAR ResNets (ResNet-20 / ResNet-110) as ``nn.Module``s.

Counterpart of ``dgc_tpu/models/resnet_cifar.py`` (flax): a 3x3/16 stem,
three stages of basic blocks at 16/32/64 channels, stride 2 at stage
transitions, 1x1 projection shortcuts where the shape changes, global
average pooling and a linear classifier.

The parameters keep the flax layout and names, because the flat-buffer
layout (and with it sampling positions, thresholds and tie order) is a
function of element order: conv kernels are HWIO, dense kernels
``[in, out]``, and submodules are named ``Conv_0``, ``BatchNorm_0``,
``BasicBlock_0`` ... as flax names them. ``forward`` permutes the HWIO
view for ``conv2d``. Training binds the parameters to views of one flat
buffer (``torch.func.functional_call``), so autograd delivers the flat
gradient with no pack step.

BatchNorm matches flax: momentum 0.9 (torch's 0.1), eps 1e-5, and the
running variance is updated with the BIASED batch variance.

A model takes a compute ``dtype`` (``configs/bf16.py``'s bfloat16), with
flax's promotion rules: a convolution or dense layer casts its input and
its parameters to it (a no-op for the bf16 views the train step binds),
BatchNorm computes its statistics and its normalisation in f32 and
returns the compute dtype, and the logits return as f32.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CifarResNet", "resnet20", "resnet110", "init_variables"]

_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5


class Conv(nn.Module):
    """Convolution with an HWIO kernel (and a bias where ``bias``),
    computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.kernel.to(dt).permute(3, 2, 0, 1),
                        None if self.bias is None else self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """flax's BatchNorm over NCHW: statistics and normalisation in f32,
    the output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        x, scale, bias = x.float(), self.scale.float(), self.bias.float()
        if not train:
            return F.batch_norm(x, self.mean, self.var, scale, bias, False,
                                0.0, _BN_EPS).to(self.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.mean.copy_(_BN_MOMENTUM * self.mean
                            + (1 - _BN_MOMENTUM) * mean)
            self.var.copy_(_BN_MOMENTUM * self.var + (1 - _BN_MOMENTUM) * var)
        return F.batch_norm(x, None, None, scale, bias, True, 0.0,
                            _BN_EPS).to(self.dtype)


class Dense(nn.Module):
    """Affine layer with an ``[in, out]`` kernel, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, 3, stride, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(channels, dtype)
        self.Conv_1 = Conv(channels, channels, 3, 1, 1, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(channels, dtype)
        self.project = stride != 1 or cin != channels
        if self.project:
            self.Conv_2 = Conv(cin, channels, 1, stride, 0, dtype=dtype)
            self.BatchNorm_2 = BatchNorm(channels, dtype)

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.BatchNorm_2(self.Conv_2(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class CifarResNet(nn.Module):
    """Input NCHW f32 (the harness permutes NHWC batches); returns f32
    logits."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, 16, 3, 1, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(16, dtype)
        cin, b = 16, 0
        for i, (n_blocks, channels) in enumerate(zip(stage_sizes,
                                                     (16, 32, 64))):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"BasicBlock_{b}",
                        BasicBlock(cin, channels, stride, dtype))
                cin, b = channels, b + 1
        self.num_blocks = b
        self.Dense_0 = Dense(cin, num_classes, dtype)

    def forward(self, x, train: bool = True):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for b in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{b}")(x, train)
        return self.Dense_0(x.mean(dim=(2, 3))).float()


def resnet20(num_classes: int = 10,
             dtype: torch.dtype = torch.float32) -> CifarResNet:
    return CifarResNet((3, 3, 3), num_classes, dtype)


def resnet110(num_classes: int = 10,
              dtype: torch.dtype = torch.float32) -> CifarResNet:
    return CifarResNet((18, 18, 18), num_classes, dtype)


@torch.no_grad()
def init_variables(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise in place from ``generator`` with the reference's
    recipe: kaiming-normal (fan_out) convolutions, lecun-normal (truncated)
    dense kernels, unit BatchNorm scales, zero biases and statistics."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            h, w, _, cout = mod.kernel.shape
            std = math.sqrt(2.0 / (h * w * cout))
            mod.kernel.normal_(0.0, std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Dense):
            std = math.sqrt(1.0 / mod.kernel.shape[0]) / .87962566103423978
            nn.init.trunc_normal_(mod.kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
