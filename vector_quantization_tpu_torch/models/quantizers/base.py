"""Quantizer interface (``vector_quantization_tpu/models/quantizers/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["QuantizerOutput"]


@dataclasses.dataclass
class QuantizerOutput:
    """What a quantizer forward returns.

    - ``z``: straight-through quantized features (N, D), the decoder input;
    - ``codes``: (N,) int32 code ids;
    - ``loss``: scalar, the sum of the configured quantizer losses;
    - ``losses``: the individual loss values by name;
    - ``aux``: extras for codebook updates and metrics (the post-normalise
      features ``x``; the distance matrix when a loss needs it).
    """

    z: torch.Tensor
    codes: torch.Tensor
    loss: torch.Tensor
    losses: dict[str, torch.Tensor]
    aux: dict[str, Any]

    def replace(self, **changes: Any) -> "QuantizerOutput":
        return dataclasses.replace(self, **changes)
