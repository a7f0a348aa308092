"""Conv-net building blocks of the VQGAN (``vector_quantization_tpu/models/layers.py``).

The JAX package runs NHWC; these modules run PyTorch's NCHW, and the task
models (:mod:`...tasks.image_tokenization`) convert at their public
functions. Convolutions, GroupNorm, the attention block's matmuls and the
nearest ×2 upsample are PyTorch calls, as the JAX package leaves them to XLA
outside any Pallas kernel. Padding follows flax's: ``SAME`` for the stride-1
convolutions, and the downsample pads right and bottom by one before a
VALID stride-2 convolution.

:class:`BatchNorm` is flax's ``nn.BatchNorm`` over channel axis 1 (NCHW,
or (B, C)), which ``nn.BatchNorm1d``/``2d`` are not: in train mode it
normalises by the batch's biased variance ``E[x²] − E[x]²`` (clamped at 0,
over every axis but the channel's) and moves the running statistics with
that same variance, momentum 0.99 (``new = 0.99·old + 0.01·batch``),
epsilon 1e-5; ``train=False`` normalises by the running statistics, the
buffers ``mean`` and ``var`` (flax's ``batch_stats``). Its scale starts at
1 (flax's default), or N(1, ``scale_std``) where that is given (PatchGAN's
0.02); its bias at 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "GroupNorm32", "ResBlock", "AttnBlock", "Downsample", "Upsample"]


class BatchNorm(nn.Module):
    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5, scale_std: float = 0.0) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        if scale_std:
            with torch.no_grad():
                self.scale.normal_(1.0, scale_std)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            dims = (0, *range(2, x.dim()))
            mean = torch.mean(x, dim=dims)
            var = torch.clamp(torch.mean(torch.square(x), dim=dims) - torch.square(mean), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        shape = (-1, *[1] * (x.dim() - 2))
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def conv3x3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding="same")


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with 32 groups and eps 1e-6; C groups where C is not a
    multiple of 32 (the JAX package's rule for test-sized widths)."""

    def __init__(self, num_channels: int) -> None:
        groups = 32 if num_channels % 32 == 0 else num_channels
        super().__init__(groups, num_channels, eps=1e-6)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv3x3 -> GN -> SiLU -> conv3x3, plus the input (through
    a 1x1 conv ``shortcut`` where the width changes)."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h·w positions, with residual: one
    ``qkv`` projection split in q, k, v order, f32 scores scaled by 1/√c,
    softmax, value product, ``proj``. Written as two matmuls: at c = 512 the
    head is wider than PyTorch's fused attention kernels take."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)  # (B, h·w, C)
        q, k, v = self.qkv(y).chunk(3, dim=-1)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        y = self.proj(torch.matmul(attn, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    """Zero-pad right and bottom by one, then a VALID 3x3 stride-2 conv."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2 (equal to ``jax.image.resize(..., "nearest")`` at exactly
    2×), then a 3x3 conv."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
