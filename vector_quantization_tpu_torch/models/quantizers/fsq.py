"""FSQ and SQ quantizers (port of
``vector_quantization_tpu/models/quantizers/fsq.py``): no parameters; the
arithmetic is :class:`...ops.fsq.FSQCodec`'s. ``embedding_dim`` is
``len(levels)``, so the autoencoder's connectors take their widths from
it. The forward's ``loss`` is a zero scalar and ``losses`` is empty.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch import nn

from ...ops.fsq import FSQCodec
from ...registries import QuantizerRegistry
from .base import QuantizerOutput

__all__ = ["FiniteScalarQuantizer", "ScalarQuantizer"]


@QuantizerRegistry.register()
class FiniteScalarQuantizer(nn.Module):
    """levels e.g. (8, 8, 5, 5, 5): 8000 codes."""

    def __init__(self, levels: Sequence[int], eps: float = 1e-3,
                 losses: Mapping[str, Mapping[str, Any]] | None = None) -> None:
        super().__init__()
        self.levels = tuple(int(l) for l in levels)
        self.eps = eps
        self.losses = dict(losses or {})
        self.codec = FSQCodec(levels=self.levels, eps=eps)

    @property
    def codebook_size(self) -> int:
        return self.codec.codebook_size

    @property
    def embedding_dim(self) -> int:
        return len(self.levels)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.codec.encode(x)[0]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.codec.decode(codes)

    def embeddings(self) -> torch.Tensor:
        return self.codec.embeddings()

    def forward(self, x: torch.Tensor, train: bool = False) -> QuantizerOutput:
        codes, z = self.codec.encode(x)
        return QuantizerOutput(z=z, codes=codes, loss=torch.zeros((), dtype=torch.float32, device=x.device),
                               losses={}, aux={"x": x})


@QuantizerRegistry.register()
class ScalarQuantizer(FiniteScalarQuantizer):
    """Scalar quantization: the FSQ machinery with FSQ's default levels."""

    def __init__(self, levels: Sequence[int] = (8, 8, 5, 5, 5), **kwargs: Any) -> None:
        super().__init__(levels, **kwargs)
