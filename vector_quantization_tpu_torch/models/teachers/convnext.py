"""The ConvNeXt teacher (port of
``vector_quantization_tpu/models/teachers/convnext.py``): the ConvNeXt
trunk (Liu et al. 2022), base by default (depths 3/3/27/3, widths
128-1024).

A 4×4/4 stem with a LayerNorm; stages of blocks (a 7×7 depthwise conv, a
LayerNorm over the channels, a pointwise 4× MLP with flax's default GELU,
the tanh approximation, and the layer scale ``gamma``, 1e-6 at init, on
the residual branch); a LayerNorm and a 2×2/2 conv between stages. All
LayerNorms take eps 1e-6. The stream is NHWC, as in flax; the convolutions
run NCHW. Children keep the flax names (``stem``, ``stem_norm``,
``down{i}_norm``, ``down{i}``, ``s{i}b{j}`` with ``dwconv``,
``LayerNorm_0``, ``pw1``, ``pw2``, ``gamma``; the trunk is ``backbone``),
so :mod:`...utils.bridge` maps the params (conv kernels HWIO -> OIHW).
No pretrained weights are in the repository.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registries import TeacherRegistry
from .base import BaseTeacher

__all__ = ["ConvNeXtTeacher"]


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _ConvNeXtBlock(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.LayerNorm_0 = nn.LayerNorm(c, eps=1e-6)
        self.pw1 = nn.Linear(c, 4 * c)
        self.pw2 = nn.Linear(4 * c, c)
        self.gamma = nn.Parameter(torch.full((c,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(_conv_nhwc(self.dwconv, x))
        y = self.pw2(F.gelu(self.pw1(y), approximate="tanh"))
        return x + y * self.gamma


class _ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int], widths: Sequence[int]) -> None:
        super().__init__()
        self.depths = tuple(depths)
        self.stem = nn.Conv2d(3, widths[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(widths[0], eps=1e-6)
        for si, (depth, width) in enumerate(zip(depths, widths)):
            if si > 0:
                self.add_module(f"down{si}_norm", nn.LayerNorm(widths[si - 1], eps=1e-6))
                self.add_module(f"down{si}", nn.Conv2d(widths[si - 1], width, 2, stride=2))
            for bi in range(depth):
                self.add_module(f"s{si}b{bi}", _ConvNeXtBlock(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(_conv_nhwc(self.stem, x))
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = _conv_nhwc(getattr(self, f"down{si}"), getattr(self, f"down{si}_norm")(x))
            for bi in range(depth):
                x = getattr(self, f"s{si}b{bi}")(x)
        return x


@TeacherRegistry.register()
class ConvNeXtTeacher(BaseTeacher):
    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3), widths: Sequence[int] = (128, 256, 512, 1024),
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.widths = tuple(widths)
        self.backbone = _ConvNeXt(depths, widths)

    @property
    def out_channels(self) -> int:
        return self.widths[-1]

    @property
    def downsample_factor(self) -> int:
        return 32

    def backbone_forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.backbone(image)
