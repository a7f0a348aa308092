"""VQGAN conv encoder and decoder
(``vector_quantization_tpu/models/autoencoders/vqgan.py``), NCHW.

in-conv -> per-resolution layers of ``depth_mult`` residual (+attention)
blocks -> down/upsample between resolutions -> an optional ``refine`` block
(res + attn + res) -> GN/SiLU/conv projector. The encoder attends at its
last layer and refines after it (f16: width_mults (1, 1, 2, 2, 4)); the
decoder mirrors it (refine first, attention at layer 0, width_mults
(4, 2, 2, 1, 1)). Children keep the flax names (``conv_in``,
``layer{i}_res{d}``, ``layer{i}_attn{d}``, ``down{i}``/``up{i}``,
``refine``, ``proj_out``; flax's unnamed final GroupNorm is ``norm_out``),
so :func:`...utils.bridge.state_dict_from_flax` can map the params.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registries import DecoderRegistry, EncoderRegistry
from ..layers import AttnBlock, Downsample, GroupNorm32, ResBlock, Upsample, conv3x3

__all__ = ["VQGANEncoder", "VQGANDecoder"]


class _Refine(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.res1 = ResBlock(channels, channels)
        self.attn = AttnBlock(channels)
        self.res2 = ResBlock(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res2(self.attn(self.res1(x)))


class _VQGANBackbone(nn.Module):
    """The U-Net half shared by the encoder and the decoder."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        hidden_channels: int,
        width: int,
        width_mults: Sequence[int],
        depth_mult: int,
        attention_layer: int | None,
        refine_layer: int | None,
        resample: str,  # 'down' | 'up' | 'none'
    ) -> None:
        super().__init__()
        if resample not in ("down", "up", "none"):
            raise ValueError(f"unknown resample {resample!r}")
        widths = [hidden_channels] + [width * m for m in width_mults]
        self.conv_in = conv3x3(in_channels, hidden_channels)
        self._order = ["conv_in"]
        c = hidden_channels
        num_layers = len(width_mults)
        for i in range(num_layers):
            if refine_layer is not None and i == refine_layer:
                self._add("refine", _Refine(c))
            for d in range(depth_mult):
                self._add(f"layer{i}_res{d}", ResBlock(c, widths[i + 1]))
                c = widths[i + 1]
                if attention_layer == i:
                    self._add(f"layer{i}_attn{d}", AttnBlock(c))
            if i < num_layers - 1 and resample != "none":
                if resample == "down":
                    self._add(f"down{i}", Downsample(c))
                else:
                    self._add(f"up{i}", Upsample(c))
        if refine_layer is not None and refine_layer == num_layers:
            self._add("refine", _Refine(c))
        self.norm_out = GroupNorm32(c)
        self.proj_out = conv3x3(c, out_channels)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._order.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._order:
            x = getattr(self, name)(x)
        return self.proj_out(F.silu(self.norm_out(x)))


@EncoderRegistry.register()
class VQGANEncoder(nn.Module):
    """f16 default: (B, 3, 256, 256) -> (B, out_channels, 16, 16)."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 256,
        width: int = 128,
        width_mults: Sequence[int] = (1, 1, 2, 2, 4),
        depth_mult: int = 2,
        attention_layer: int | None = None,  # default: the last layer
        refine_layer: int | None = None,  # default: after the last layer
    ) -> None:
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.width_mults = tuple(width_mults)
        self.backbone = _VQGANBackbone(
            in_channels=in_channels,
            out_channels=out_channels,
            hidden_channels=width,
            width=width,
            width_mults=width_mults,
            depth_mult=depth_mult,
            attention_layer=len(width_mults) - 1 if attention_layer is None else attention_layer,
            refine_layer=len(width_mults) if refine_layer is None else refine_layer,
            resample="down",
        )

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.width_mults) - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)


@DecoderRegistry.register()
class VQGANDecoder(nn.Module):
    """f16 default: (B, in_channels, 16, 16) -> (B, 3, 256, 256)."""

    def __init__(
        self,
        in_channels: int = 256,
        out_channels: int = 3,
        width: int = 128,
        width_mults: Sequence[int] = (4, 2, 2, 1, 1),
        depth_mult: int = 3,
        attention_layer: int | None = 0,
        refine_layer: int | None = 0,
    ) -> None:
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.backbone = _VQGANBackbone(
            in_channels=in_channels,
            out_channels=out_channels,
            hidden_channels=width * width_mults[0],
            width=width,
            width_mults=width_mults,
            depth_mult=depth_mult,
            attention_layer=attention_layer,
            refine_layer=refine_layer,
            resample="up",
        )

    @staticmethod
    def last_parameter_name() -> str:
        """The projector conv's weight: the ``last`` of the adaptive GAN
        weight (the JAX decoder's ``last_parameter_path()``)."""
        return "backbone.proj_out.weight"

    def last_parameter(self) -> nn.Parameter:
        return self.get_parameter(self.last_parameter_name())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)
