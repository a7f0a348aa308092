"""Environment-variable flags (the port's copy of
``vector_quantization_tpu/utils/flags.py``).

``Store`` reads the environment at every access:

- ``DRY_RUN``: ``DRY_RUN=1 python -m vector_quantization_tpu_torch.cli.train
  ...`` shrinks a run: at most 5 train iterations, 2 eval, tokenize or FID
  batches, 64 synthetic images or image-folder files, no split carve-out,
  and ``cli.val`` polls every 10 s and stops after one empty scan;
- ``PRETRAINED``: the directory of converted pretrained weights
  (``pretrained`` by default); ``FIDMetric`` looks for Inception's in its
  ``inception`` subdirectory.
"""

from __future__ import annotations

import os

__all__ = ["Store"]

_TRUTHY = {"1", "true", "yes", "on"}


class _StoreMeta(type):
    @property
    def DRY_RUN(cls) -> bool:
        return os.environ.get("DRY_RUN", "").strip().lower() in _TRUTHY

    @property
    def PRETRAINED(cls) -> str:
        return os.environ.get("PRETRAINED", "pretrained")


class Store(metaclass=_StoreMeta):
    """Global env flags, read fresh on every access: ``DRY_RUN``, ``PRETRAINED``."""
