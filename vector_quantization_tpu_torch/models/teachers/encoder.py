"""``ClusterEncoder``: a frozen teacher used as the tokenizer's encoder
(port of ``vector_quantization_tpu/models/teachers/encoder.py``).

The tokenizer feeds the [-1, 1] image, NCHW as the port's encoders take
it; the teacher reads 0-255 pixels, so the image goes back to that scale
first, ``clip((image + 1)·127.5, 0, 255)`` and not rounded (the JAX
package's formula: the codec's round trip up to rounding). Features come
back NCHW (B, C, h, w).
"""

from __future__ import annotations

import torch
from torch import nn

from ...registries import EncoderRegistry, TeacherRegistry
from ...tasks.image_tokenization import build_submodule, nhwc, nchw

__all__ = ["ClusterEncoder"]


@EncoderRegistry.register()
class ClusterEncoder(nn.Module):
    def __init__(self, teacher: nn.Module) -> None:
        super().__init__()
        self.teacher = teacher

    @classmethod
    def build_pre_hook(cls, config, registry):
        config["teacher"] = build_submodule(TeacherRegistry, config["teacher"])
        return config

    @property
    def out_channels(self) -> int:
        return self.teacher.out_channels

    @property
    def downsample_factor(self) -> int:
        return self.teacher.downsample_factor

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        original = torch.clamp((nhwc(image) + 1.0) * 127.5, 0, 255)
        return nchw(self.teacher(original, return_2d=True))
