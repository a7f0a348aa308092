"""Connectors: channel adapters between encoder, quantizer and decoder
(``vector_quantization_tpu/models/connectors.py``), on NCHW feature maps.

Unlike flax, a PyTorch layer needs its input width when it is built:
``TokenizerModel``/``AutoencoderModel.build_pre_hook`` fill ``in_channels``
from the neighbouring modules.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..registries import ConnectorRegistry

__all__ = ["IdentityConnector", "ConvConnector", "ComposedConnector"]


@ConnectorRegistry.register()
class IdentityConnector(nn.Module):
    def __init__(self, in_channels: int = 0, out_channels: int = 0) -> None:
        super().__init__()
        if in_channels and out_channels and in_channels != out_channels:
            raise ValueError(f"identity connector with {in_channels} != {out_channels}")
        self.in_channels, self.out_channels = in_channels, out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@ConnectorRegistry.register()
class ConvConnector(nn.Module):
    """A k×k conv (1×1 by default, SAME padding) on (B, C, H, W) maps."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1) -> None:
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"ConvConnector takes (B, C, H, W) maps, got shape {tuple(x.shape)}")
        return self.conv(x)


@ConnectorRegistry.register()
class ComposedConnector(nn.Module):
    """Connectors applied in order; child ``i`` is named ``connectors_{i}``
    as in flax."""

    def __init__(self, connectors: Sequence[nn.Module]) -> None:
        super().__init__()
        self._names = []
        for i, conn in enumerate(connectors):
            self.add_module(f"connectors_{i}", conn)
            self._names.append(f"connectors_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._names:
            x = getattr(self, name)(x)
        return x
