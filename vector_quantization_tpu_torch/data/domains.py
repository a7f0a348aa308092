"""Domain datasets: COCO, SA-Med2D, SATIN and LAION-Aesthetics (port of
``vector_quantization_tpu/data/domains.py``), folder corpora whose
category is 0, as the reference fixes it (the JAX package's classes, plain
``ImageFolderDataset`` subclasses, give its uncategorised -1).

- ``COCODataset``: the images under ``root/<split>`` (``train2014`` by
  default), named ``coco_<split>``;
- ``SAMed2DDataset`` (``sa_med2d``) and ``SATINDataset`` (``satin``): the
  images under ``root``;
- ``LAIONAestheticsDataset``: the folder under ``root`` split as
  :class:`...data.datasets.SplitDataset` splits it (the last ``val_size``,
  25,000 by default, indices are ``val``), named
  ``laion_aesthetics_<split>``. A decode that raises is tried again, up to
  10 attempts, each after the first at an index drawn
  uniformly from the split; the last exception is raised again. The JAX
  package draws those indices from Python's global ``random``; the port
  from a ``random.Random`` the dataset owns, seeded from its name and
  ``seed``, so a run's retries repeat. It builds from a config (the JAX
  class inherits ``SplitDataset``'s hook, which asks for a ``dataset``
  entry the config does not have, and raises).
"""

from __future__ import annotations

import os
import random

from ..registries import DatasetRegistry
from .base import Item
from .datasets import ImageFolderDataset, SplitDataset

__all__ = ["COCODataset", "LAIONAestheticsDataset", "SAMed2DDataset", "SATINDataset"]

_ATTEMPTS = 10  # LAION's decodes of one item, the first at its own index


class _DomainFolder(ImageFolderDataset):
    """Every image under ``root``, category 0."""

    def _record(self, index: int) -> tuple[str, str, int]:
        path, id_, _ = super()._record(index)
        return path, id_, 0


@DatasetRegistry.register()
class COCODataset(_DomainFolder):
    def __init__(self, *, root: str, split: str = "train2014", **kwargs) -> None:
        kwargs.setdefault("name", f"coco_{split}")
        super().__init__(root=os.path.join(root, split), **kwargs)


@DatasetRegistry.register()
class SAMed2DDataset(_DomainFolder):
    def __init__(self, *, root: str, **kwargs) -> None:
        kwargs.setdefault("name", "sa_med2d")
        super().__init__(root=root, **kwargs)


@DatasetRegistry.register()
class SATINDataset(_DomainFolder):
    def __init__(self, *, root: str, **kwargs) -> None:
        kwargs.setdefault("name", "satin")
        super().__init__(root=root, **kwargs)


@DatasetRegistry.register()
class LAIONAestheticsDataset(SplitDataset):
    def __init__(self, *, root: str, split: str = "train", val_size: int = 25_000, **kwargs) -> None:
        base = _DomainFolder(root=root, name="laion_aesthetics", image_size=kwargs.get("image_size", 256))
        kwargs.setdefault("name", f"laion_aesthetics_{split}")
        super().__init__(dataset=base, split=split, val_size=val_size, **kwargs)
        self.rng = random.Random(f"{self.name}/{kwargs.get('seed', 0)}")

    @classmethod
    def build_pre_hook(cls, config, registry):
        return config  # the corpus is built from ``root``, not from a ``dataset`` config

    def __getitem__(self, index: int) -> Item:
        last: Exception | None = None
        for _ in range(_ATTEMPTS):
            try:
                return super().__getitem__(index)
            except Exception as e:  # noqa: BLE001 - a flaky decode
                last = e
                index = self.rng.randint(0, len(self) - 1)
        raise last  # type: ignore[misc]
