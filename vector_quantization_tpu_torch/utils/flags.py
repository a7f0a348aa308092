"""Environment-variable flags (the port's copy of
``vector_quantization_tpu/utils/flags.py``, ``DRY_RUN`` only).

``Store.DRY_RUN`` reads the environment at every access, so
``DRY_RUN=1 python -m vector_quantization_tpu_torch.cli.train ...`` shrinks a
run: at most 5 train iterations, 2 eval or tokenize batches, 64 synthetic
images or image-folder files, no split carve-out.
"""

from __future__ import annotations

import os

__all__ = ["Store"]

_TRUTHY = {"1", "true", "yes", "on"}


class _StoreMeta(type):
    @property
    def DRY_RUN(cls) -> bool:
        return os.environ.get("DRY_RUN", "").strip().lower() in _TRUTHY


class Store(metaclass=_StoreMeta):
    """Global env flags, read fresh on every access: ``DRY_RUN``."""
