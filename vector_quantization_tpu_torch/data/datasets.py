"""Datasets (port of ``vector_quantization_tpu/data/datasets.py``), numpy on
the host:

- ``ImageFolderDataset``: every image under ``root`` (sorted walk), the
  subdirectory as the category with ``categorical=True``;
- ``ImageNetDataset``: ``root/{split}/{synset}/*.JPEG``, 1000 classes;
- ``SyntheticDataset``: procedural RGB images (three sinusoid gratings, one
  per channel) seeded per index with ``np.random.default_rng(index)``; item
  ``i`` is bit for bit the JAX package's item ``i``;
- ``ConcatDataset``: datasets end to end;
- ``SplitDataset``: the last ``val_size`` indices of a corpus as ``val``,
  the rest as ``train`` (optionally strided); ``DRY_RUN`` skips the
  carve-out.

``collate`` stacks items into a :class:`Batch`: ``id_`` (list of str),
``original_image`` uint8 (B, H, W, 3), ``image`` f32 (B, H, W, 3) in
[-1, 1], ``category`` int32 (B,).
"""

from __future__ import annotations

import os
from bisect import bisect_right
from typing import Sequence

import numpy as np

from ..registries import DatasetRegistry
from ..utils.flags import Store
from .base import BaseDataset, Item, pixel_encode, require_pil

__all__ = ["Batch", "ImageFolderDataset", "ImageNetDataset", "SyntheticDataset", "ConcatDataset",
           "SplitDataset", "collate"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class Batch(dict):
    """dict with attribute access."""

    __getattr__ = dict.__getitem__


def collate(items: Sequence[Item]) -> Batch:
    return Batch(
        id_=[it.id_ for it in items],
        original_image=np.stack([it.original_image for it in items]),
        image=np.stack([it.image for it in items]),
        category=np.asarray([it.category for it in items], np.int32),
    )


@DatasetRegistry.register()
class ImageFolderDataset(BaseDataset):
    def __init__(self, *, root: str, categorical: bool = False, **kwargs) -> None:
        self.root = root
        self.categorical = categorical
        paths: list[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            paths.extend(os.path.join(dirpath, f) for f in sorted(files) if f.lower().endswith(_EXTS))
        if Store.DRY_RUN:
            paths = paths[:64]
        self.paths = paths
        categories = sorted({os.path.basename(os.path.dirname(p)) for p in paths})
        self.category_index = {c: i for i, c in enumerate(categories)}
        kwargs.setdefault("num_categories", len(categories) if categorical else 0)
        super().__init__(**kwargs)

    def __len__(self) -> int:
        return len(self.paths)

    def _record(self, index: int) -> tuple[str, str, int]:
        path = self.paths[index]
        category = self.category_index[os.path.basename(os.path.dirname(path))] if self.categorical else -1
        return path, os.path.splitext(os.path.relpath(path, self.root))[0], category

    def __getitem__(self, index: int) -> Item:
        path, id_, category = self._record(index)
        with require_pil().open(path) as img:
            img.load()
            return self._make_item(id_, img, category)

    def native_record(self, index: int) -> tuple[str, str, int] | None:
        path, id_, category = self._record(index)
        return (path, id_, category) if path.lower().endswith((".jpg", ".jpeg")) else None


@DatasetRegistry.register()
class ImageNetDataset(ImageFolderDataset):
    def __init__(self, *, root: str, split: str = "train", **kwargs) -> None:
        kwargs.setdefault("name", f"imagenet_{split}")
        super().__init__(root=os.path.join(root, split), categorical=True, **kwargs)
        self.num_categories = kwargs.get("num_categories", 1000) or 1000


@DatasetRegistry.register()
class SyntheticDataset(BaseDataset):
    def __init__(self, *, size: int = 512, num_categories: int = 10, **kwargs) -> None:
        kwargs.setdefault("name", "synthetic")
        kwargs.setdefault("num_categories", num_categories)
        super().__init__(**kwargs)
        self.size = 64 if Store.DRY_RUN and size > 64 else size

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


@DatasetRegistry.register()
class ConcatDataset(BaseDataset):
    def __init__(self, *, datasets: Sequence[BaseDataset], **kwargs) -> None:
        self.datasets = list(datasets)
        kwargs.setdefault("name", "+".join(d.name for d in self.datasets))
        kwargs.setdefault("num_categories", max(d.num_categories for d in self.datasets))
        kwargs.setdefault("image_size", self.datasets[0].image_size)
        super().__init__(**kwargs)
        self._offsets = np.cumsum([len(d) for d in self.datasets]).tolist()

    @classmethod
    def build_pre_hook(cls, config, registry):
        config["datasets"] = [registry.build_or_return(d) for d in config["datasets"]]
        return config

    def __len__(self) -> int:
        return self._offsets[-1]

    def _locate(self, index: int) -> tuple[BaseDataset, int]:
        ds_idx = bisect_right(self._offsets, index)
        return self.datasets[ds_idx], index - (0 if ds_idx == 0 else self._offsets[ds_idx - 1])

    def __getitem__(self, index: int) -> Item:
        ds, i = self._locate(index)
        return ds[i]

    def native_record(self, index: int) -> tuple[str, str, int] | None:
        ds, i = self._locate(index)
        return ds.native_record(i)


@DatasetRegistry.register()
class SplitDataset(BaseDataset):
    def __init__(self, *, dataset: BaseDataset, split: str = "train", val_size: int = 25_000,
                 stride: int | None = None, **kwargs) -> None:
        self.dataset = dataset
        kwargs.setdefault("name", f"{dataset.name}_{split}")
        kwargs.setdefault("num_categories", dataset.num_categories)
        kwargs.setdefault("image_size", dataset.image_size)
        super().__init__(**kwargs)
        n = len(dataset)
        if Store.DRY_RUN:
            self.indices = list(range(n))
            return
        idx = np.arange(n)
        if stride:
            idx = idx.reshape(-1, stride).T.reshape(-1)
        if split == "train":
            self.indices = idx[: n - val_size].tolist()
        elif split == "val":
            self.indices = idx[n - val_size:].tolist()
        else:
            raise ValueError(split)

    @classmethod
    def build_pre_hook(cls, config, registry):
        config["dataset"] = registry.build_or_return(config["dataset"])
        return config

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, index: int) -> Item:
        return self.dataset[self.indices[index]]

    def native_record(self, index: int) -> tuple[str, str, int] | None:
        return self.dataset.native_record(self.indices[index])
