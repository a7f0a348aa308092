"""PatchGAN discriminator
(``vector_quantization_tpu/models/discriminators/patchgan.py``), NCHW
inside, NHWC at ``forward`` as in the JAX package.

A 4x4 stride-2 conv pyramid with LeakyReLU(0.2), BatchNorm after every conv
but the first and the head, the width doubling per level up to 8x, a
stride-1 penultimate conv and a 1-channel logit head; convs init N(0,
0.02), BatchNorm scale N(1, 0.02); the BatchNorm is flax's
(:class:`...models.layers.BatchNorm`). Children keep flax's auto names
(``Conv_{i}``, ``BatchNorm_{i}``) for the bridge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registries import DiscriminatorRegistry
from ..layers import BatchNorm

__all__ = ["PatchGANDiscriminator"]


def _conv(c_in: int, c_out: int, k: int, stride: int, bias: bool) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=1, bias=bias)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02)
        if bias:
            conv.bias.zero_()
    return conv


@DiscriminatorRegistry.register()
class PatchGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 3, width: int = 64, depth: int = 3, kernel_size: int = 4) -> None:
        super().__init__()
        ks = kernel_size
        self._order: list[tuple[str, str]] = []  # (conv, batch norm or "")

        def add(c_in: int, c_out: int, stride: int, norm: bool, bias: bool) -> None:
            conv = f"Conv_{len(self._order)}"
            self.add_module(conv, _conv(c_in, c_out, ks, stride, bias))
            bn = ""
            if norm:
                bn = f"BatchNorm_{sum(1 for _, b in self._order if b)}"
                self.add_module(bn, BatchNorm(c_out, scale_std=0.02))
            self._order.append((conv, bn))

        add(in_channels, width, 2, norm=False, bias=True)
        c = width
        for n in range(1, depth):
            add(c, width * min(2**n, 8), 2, norm=True, bias=False)
            c = width * min(2**n, 8)
        add(c, width * min(2**depth, 8), 1, norm=True, bias=False)
        add(width * min(2**depth, 8), 1, 1, norm=False, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) -> logits (B, H', W', 1); ``train`` normalises by the
        batch and moves the running statistics."""
        x = x.permute(0, 3, 1, 2)
        last = len(self._order) - 1
        for i, (conv, bn) in enumerate(self._order):
            x = getattr(self, conv)(x)
            if bn:
                x = getattr(self, bn)(x, train)
            if i < last:
                x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)
