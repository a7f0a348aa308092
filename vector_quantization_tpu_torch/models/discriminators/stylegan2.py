"""StyleGAN2 discriminator (port of
``vector_quantization_tpu/models/discriminators/stylegan2.py``), NHWC at
``forward`` as in the JAX package, NCHW inside.

- Equalised learning rate: each conv and linear keeps its weight
  ``kernel`` as drawn, N(0, 1), in flax's layout (HWIO for a conv, (in,
  out) for a linear), and divides it by √fan_in at every forward, so the
  optimizer moves the unscaled tensor.
- Activations: bias + leaky ReLU(0.2), times √2
  (:func:`...ops.upfirdn.fused_bias_leaky_relu`).
- A stride-2 conv is preceded by the [1, 3, 3, 1] blur
  (:func:`...ops.upfirdn.upfirdn2d_nchw`) padded by (ks//2 + 1,
  (ks + 1)//2).
- Residual blocks (conv 3×3, conv 3×3 down, shortcut 1×1 down without
  bias) are scaled by 1/√2.
- The minibatch standard deviation over ``min(B, batch_groups)`` groups
  is appended as a channel; then a 3×3 conv at 4×4, and two linears to
  the logit (B, 1), the first reading the map in NHWC order.

No BatchNorm: the module has no buffers, so ``VQGANAlgorithm``'s
``extra["d_batch_stats"]`` is empty, and ``train`` changes nothing.
Children keep the flax names (``from_rgb``, ``res{i}`` with ``conv1``,
``conv2``, ``shortcut``, ``final_conv``, ``fc1``, ``fc2``) for the bridge.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.upfirdn import blur_kernel_2d, fused_bias_leaky_relu, upfirdn2d_nchw
from ...registries import DiscriminatorRegistry

__all__ = ["StyleGAN2Discriminator"]


class EqualConv(nn.Module):
    def __init__(self, c_in: int, features: int, kernel_size: int, downsample: bool = False,
                 use_bias: bool = True, activate: bool = False) -> None:
        super().__init__()
        self.ks, self.downsample, self.activate = kernel_size, downsample, activate
        self.kernel = nn.Parameter(torch.randn(kernel_size, kernel_size, c_in, features))
        self.bias = nn.Parameter(torch.zeros(features)) if activate or use_bias else None
        self.scale = 1.0 / math.sqrt(kernel_size * kernel_size * c_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.kernel.permute(3, 2, 0, 1) * self.scale
        ks = self.ks
        if self.downsample:
            x = upfirdn2d_nchw(x, blur_kernel_2d(), pad=(ks // 2 + 1, (ks + 1) // 2))
            x = F.conv2d(x, weight, stride=2)
        else:
            x = F.conv2d(x, weight, padding=ks // 2)
        if self.activate:
            return fused_bias_leaky_relu(x, self.bias, channel_dim=1)
        return x if self.bias is None else x + self.bias[:, None, None]


class EqualLinear(nn.Module):
    def __init__(self, d: int, features: int, activate: bool = False) -> None:
        super().__init__()
        self.activate = activate
        self.kernel = nn.Parameter(torch.randn(d, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = 1.0 / math.sqrt(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x @ (self.kernel * self.scale)
        return fused_bias_leaky_relu(x, self.bias) if self.activate else x + self.bias


class _Residual(nn.Module):
    def __init__(self, c: int, out_channels: int) -> None:
        super().__init__()
        self.conv1 = EqualConv(c, c, 3, activate=True)
        self.conv2 = EqualConv(c, out_channels, 3, downsample=True, activate=True)
        self.shortcut = EqualConv(c, out_channels, 1, downsample=True, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.shortcut(x) + self.conv2(self.conv1(x))) / math.sqrt(2.0)


def _minibatch_std(x: torch.Tensor, batch_groups: int = 4, eps: float = 1e-8) -> torch.Tensor:
    """x (B, C, H, W) with the cross-group feature std appended as a
    channel: sample i of group-row ``i % (B/bg)``."""
    b, c, h, w = x.shape
    bg = min(b, batch_groups)
    y = x.reshape(bg, b // bg, c, h, w)
    y = torch.sqrt(torch.var(y, dim=0, unbiased=False) + eps).mean(dim=(1, 2, 3))  # (b/bg,)
    y = y.repeat(bg)[:, None, None, None].expand(b, 1, h, w)
    return torch.cat([x, y], dim=1)


@DiscriminatorRegistry.register()
class StyleGAN2Discriminator(nn.Module):
    """``channel_multiplier``/``max_channels`` scale the width table
    (1.0/512: the reference widths)."""

    CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128, 512: 64, 1024: 32}

    def __init__(self, image_size: int, batch_groups: int = 4, channel_multiplier: float = 1.0,
                 max_channels: int = 512, in_channels: int = 3) -> None:
        super().__init__()
        self.batch_groups = batch_groups
        self.channel_multiplier, self.max_channels = channel_multiplier, max_channels
        channels = [self._width(2**i) for i in range(int(math.log2(image_size)), 1, -1)]
        self.from_rgb = EqualConv(in_channels, channels[0], 1, activate=True)
        self.num_res = len(channels) - 1
        for i, (c, oc) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"res{i}", _Residual(c, oc))
        w4 = self._width(4)
        self.final_conv = EqualConv(channels[-1] + 1, w4, 3, activate=True)
        self.fc1 = EqualLinear(4 * 4 * w4, w4, activate=True)
        self.fc2 = EqualLinear(w4, 1)

    def _width(self, res: int) -> int:
        return max(8, min(self.max_channels, int(self.CHANNELS[res] * self.channel_multiplier)))

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> logits (B, 1)."""
        x = self.from_rgb(image.permute(0, 3, 1, 2))
        for i in range(self.num_res):
            x = getattr(self, f"res{i}")(x)
        x = self.final_conv(_minibatch_std(x, self.batch_groups))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(self.fc1(x))
