"""The pixel codec and the dataset item of
``vector_quantization_tpu/data/base.py`` (the rest of the data layer is not
ported yet).

``pixel_encode``: uint8 [0, 255] -> float32 [−1, 1]; ``pixel_decode``:
[−1, 1] -> uint8, rounding to nearest (half to even, as numpy and JAX do) so
that encode -> decode is lossless. Both take numpy arrays or tensors and
return the same kind.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Item", "pixel_encode", "pixel_decode"]


@dataclasses.dataclass
class Item:
    id_: str
    original_image: np.ndarray  # (H, W, 3) uint8
    image: np.ndarray  # (H, W, 3) float32 in [-1, 1]
    category: int


def pixel_encode(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) / 127.5 - 1.0
    return np.asarray(x).astype(np.float32) / 127.5 - 1.0


def pixel_decode(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255).to(torch.uint8)
    return np.clip(np.round((np.asarray(x) + 1.0) * 127.5), 0, 255).astype(np.uint8)
