"""Dataset layer (port of ``vector_quantization_tpu/data/base.py``): the
item, the pixel codec, the PIL transforms and the map-style dataset base.

``pixel_encode``: uint8 [0, 255] -> float32 [−1, 1]; ``pixel_decode``:
[−1, 1] -> uint8, rounding to nearest (half to even, as numpy and JAX do) so
that encode -> decode is lossless. Both take numpy arrays or tensors and
return the same kind.

``Transform`` is host-side PIL: ``none`` = resize the shorter side
(bicubic) + center crop; ``default`` = RandomResizedCrop (scale 0.08-1) +
horizontal flip; ``strong`` the same with scale 0.8-1; ``weak`` = resize +
random crop + flip. PIL is imported only when an image is transformed: a GPU
host may lack it, and synthetic data never needs it.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["Item", "BaseDataset", "Transform", "pixel_encode", "pixel_decode", "require_pil"]


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


def require_pil():
    """``PIL.Image``, or a clear error where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "image files need Pillow (PIL), which is not installed; use SyntheticDataset "
            "(configs/datasets/synthetic.py) or install Pillow"
        ) from e
    return Image


class Transform:
    """'none' | 'default' | 'strong' | 'weak' — PIL image in, uint8 (S, S, 3) out."""

    def __init__(self, image_size: int, augmentation: str = "none", seed: int = 0) -> None:
        self.image_size = image_size
        self.augmentation = augmentation
        self.rng = np.random.default_rng(seed)

    def _resize_shorter(self, img, image):
        s = self.image_size
        w, h = img.size
        scale = s / min(w, h)
        return img.resize((max(s, round(w * scale)), max(s, round(h * scale))), image.BICUBIC)

    def __call__(self, img) -> np.ndarray:
        image = require_pil()
        s = self.image_size
        if img.mode != "RGB":
            img = img.convert("RGB")
        if self.augmentation == "none":
            img = self._resize_shorter(img, image)
            w, h = img.size
            left, top = (w - s) // 2, (h - s) // 2
            img = img.crop((left, top, left + s, top + s))
        elif self.augmentation in ("default", "strong"):
            lo = 0.8 if self.augmentation == "strong" else 0.08
            w, h = img.size
            area = w * h
            for _ in range(10):
                target = area * self.rng.uniform(lo, 1.0)
                ar = np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(target * ar)))
                ch = int(round(np.sqrt(target / ar)))
                if 0 < cw <= w and 0 < ch <= h:
                    left = int(self.rng.integers(0, w - cw + 1))
                    top = int(self.rng.integers(0, h - ch + 1))
                    img = img.crop((left, top, left + cw, top + ch))
                    break
            img = img.resize((s, s), image.BICUBIC)
            if self.rng.random() < 0.5:
                img = img.transpose(image.FLIP_LEFT_RIGHT)
        elif self.augmentation == "weak":
            img = self._resize_shorter(img, image)
            w, h = img.size
            left = int(self.rng.integers(0, w - s + 1))
            top = int(self.rng.integers(0, h - s + 1))
            img = img.crop((left, top, left + s, top + s))
            if self.rng.random() < 0.5:
                img = img.transpose(image.FLIP_LEFT_RIGHT)
        else:
            raise ValueError(f"unknown augmentation {self.augmentation!r}")
        return np.asarray(img, dtype=np.uint8)


class BaseDataset(ABC):
    """Map-style dataset: ``len``, ``[i]`` -> :class:`Item`, and
    ``native_record(i)`` for file-backed JPEG items (the native decoder's
    fast path; None = decode in Python)."""

    def __init__(
        self,
        *,
        name: str,
        num_categories: int = 0,
        image_size: int = 256,
        fid_path: str | None = None,
        augmentation: str = "none",
        seed: int = 0,
    ) -> None:
        self.name = name
        self.num_categories = num_categories
        self.image_size = image_size
        self.fid_path = fid_path
        self.transform = Transform(image_size, augmentation, seed)

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def __getitem__(self, index: int) -> Item: ...

    def native_record(self, index: int) -> tuple[str, str, int] | None:
        return None

    def __iter__(self) -> Iterator[Item]:
        for i in range(len(self)):
            yield self[i]

    def _make_item(self, id_: str, img, category: int = -1) -> Item:
        original = self.transform(img)
        return Item(id_=id_, original_image=original, image=pixel_encode(original), category=category)
