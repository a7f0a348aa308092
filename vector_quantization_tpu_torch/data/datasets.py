"""Datasets (port of ``vector_quantization_tpu/data/datasets.py``):
``SyntheticDataset`` only, numpy only.

``SyntheticDataset``: deterministic procedural RGB images (three sinusoid
gratings, one per channel), seeded per index with
``np.random.default_rng(index)``: item ``i`` is bit for bit the JAX
package's item ``i``. ``collate`` stacks items into the batch dict the
algorithms and metrics take (numpy arrays; ``image`` f32 NHWC in [-1, 1],
``original_image`` uint8).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..registries import DatasetRegistry
from .base import Item, pixel_encode

__all__ = ["SyntheticDataset", "collate"]


@DatasetRegistry.register()
class SyntheticDataset:
    def __init__(self, *, size: int = 512, num_categories: int = 10, image_size: int = 256) -> None:
        self.num_categories = num_categories
        self.image_size = image_size
        self.size = size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Item:
        rng = np.random.default_rng(index)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        freqs = rng.uniform(1, 8, size=(3, 2))
        phases = rng.uniform(0, 2 * np.pi, size=3)
        chans = [0.5 + 0.5 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + p)
                 for f, p in zip(freqs, phases)]
        img = (np.stack(chans, axis=-1) * 255).astype(np.uint8)
        return Item(
            id_=f"synthetic/{index}",
            original_image=img,
            image=pixel_encode(img),
            category=int(index % max(self.num_categories, 1)),
        )


def collate(items: Sequence[Item]) -> dict[str, np.ndarray]:
    return {
        "image": np.stack([it.image for it in items]),
        "original_image": np.stack([it.original_image for it in items]),
        "category": np.asarray([it.category for it in items], np.int32),
    }
