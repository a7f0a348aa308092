"""Frozen teachers, the feature sources of VQ-KD and Cluster (port of
``vector_quantization_tpu/models/teachers/base.py``).

A teacher takes the uint8 image (B, H, W, 3), NHWC as the batch holds it,
scales it to [0, 1], normalises it by a mean/std preset, runs its backbone
and returns float32 features, flattened (B, h·w, C) or as a map (B, h, w,
C) with ``return_2d``. The presets: CLIP's (0.48145466, 0.4578275,
0.40821073) / (0.26862954, 0.26130258, 0.27577711), ImageNet's (0.485,
0.456, 0.406) / (0.229, 0.224, 0.225), and ``none``.

``image_size`` resizes the normalised input to a square of that side
before the backbone, ``output_size`` the features after it, both by the
JAX package's ``jax.image.resize(..., "bicubic")`` (:func:`...ops.resize
.resize`: Keys' cubic with a = -0.5, antialiased on a downscale;
``F.interpolate``'s bicubic does not agree).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.resize import resize
from ...registries import TeacherRegistry

__all__ = ["BaseTeacher", "PixelTeacher", "CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_PRESETS = {
    "clip": (CLIP_MEAN, CLIP_STD),
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}


class BaseTeacher(nn.Module):
    """Subclasses define ``backbone_forward(image NHWC) -> (B, h, w, C)``
    and ``out_channels``."""

    def __init__(self, normalization: str = "imagenet", image_size: int | None = None,
                 output_size: int | None = None) -> None:
        super().__init__()
        for name, size in (("image_size", image_size), ("output_size", output_size)):
            if size is not None and size < 1:
                raise ValueError(f"{name} must be a positive side length, got {size}")
        mean, std = _PRESETS[normalization]
        self.normalization = normalization
        self.image_size, self.output_size = image_size, output_size
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32), persistent=False)
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32), persistent=False)

    def normalize(self, original_image: torch.Tensor) -> torch.Tensor:
        """uint8 (or 0-255 float) (B, H, W, 3) -> normalised float32."""
        x = original_image.to(torch.float32) / 255.0
        return (x - self.mean) / self.std

    def backbone_forward(self, image: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def out_channels(self) -> int:
        raise NotImplementedError

    def forward(self, original_image: torch.Tensor, return_2d: bool = False) -> torch.Tensor:
        x = self.normalize(original_image)
        if self.image_size is not None:
            x = resize(x, self.image_size, self.image_size, "bicubic")
        feats = self.backbone_forward(x).float()
        if self.output_size is not None:
            feats = resize(feats, self.output_size, self.output_size, "bicubic")
        if return_2d:
            return feats
        b, h, w, c = feats.shape
        return feats.reshape(b, h * w, c)


@TeacherRegistry.register()
class PixelTeacher(BaseTeacher):
    """Average-pooled pixels as features (tests and runs without weights)."""

    def __init__(self, patch_size: int = 16, **kwargs) -> None:
        super().__init__(**kwargs)
        self.patch_size = patch_size

    @property
    def out_channels(self) -> int:
        return 3

    @property
    def downsample_factor(self) -> int:
        return self.patch_size

    def backbone_forward(self, image: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = image.shape
        return image.reshape(b, h // p, p, w // p, p, c).mean(dim=(2, 4))
