"""Frozen teachers, the feature sources of VQ-KD and Cluster (port of
``vector_quantization_tpu/models/teachers/base.py``).

A teacher takes the uint8 image (B, H, W, 3), NHWC as the batch holds it,
scales it to [0, 1], normalises it by a mean/std preset, runs its backbone
and returns float32 features, flattened (B, h·w, C) or as a map (B, h, w,
C) with ``return_2d``. The presets: CLIP's (0.48145466, 0.4578275,
0.40821073) / (0.26862954, 0.26130258, 0.27577711), ImageNet's (0.485,
0.456, 0.406) / (0.229, 0.224, 0.225), and ``none``.

``image_size`` resizes the normalised input to a square of that side
before the backbone, ``output_size`` the features after it, both by
:func:`bicubic_resize`, the JAX package's ``jax.image.resize(...,
"bicubic")``: Keys' cubic with a = -0.5, antialiased (the kernel widened
by the shrink factor) on a downscale, under ``scale_and_translate``'s
rule with each output's weights renormalised to sum to 1.
``F.interpolate``'s bicubic takes a = -0.75 and does not antialias, so it
does not agree. An axis whose size does not change is left as it is.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ...registries import TeacherRegistry

__all__ = ["BaseTeacher", "PixelTeacher", "CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD",
           "bicubic_resize", "bicubic_weights"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_PRESETS = {
    "clip": (CLIP_MEAN, CLIP_STD),
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at |distance| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@lru_cache(maxsize=None)
def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (out, in) f32 resampling matrix of one axis, built as JAX's
    ``compute_weight_mat`` builds it (scale out/in, no translation,
    antialiased): output i samples input position (i + 0.5)/scale − 0.5
    through the kernel widened by max(1/scale, 1); each output's weights
    are divided by their sum (zero where that sum is ~0), and an output
    whose sample lies outside [−0.5, in − 0.5] gets none."""
    inv_scale = in_size / out_size
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / max(inv_scale, 1.0)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


def bicubic_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC ``x`` resized to (height, width), f32 products: one weight
    matrix per axis that changes, applied by ``einsum``."""
    if x.shape[1] != height:
        w = torch.from_numpy(bicubic_weights(x.shape[1], height)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", w, x)
    if x.shape[2] != width:
        w = torch.from_numpy(bicubic_weights(x.shape[2], width)).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", w, x)
    return x


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
            x = bicubic_resize(x, self.image_size, self.image_size)
        feats = self.backbone_forward(x).float()
        if self.output_size is not None:
            feats = bicubic_resize(feats, self.output_size, self.output_size)
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
