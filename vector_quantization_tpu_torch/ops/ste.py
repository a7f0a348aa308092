"""Straight-through estimator (``vector_quantization_tpu/ops/ste.py``)."""

from __future__ import annotations

import torch

__all__ = ["ste"]


def ste(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward value ``z``; the gradient flows to ``x`` only."""
    return x + (z - x).detach()
