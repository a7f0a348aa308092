"""Finite Scalar Quantization (port of ``vector_quantization_tpu/ops/fsq.py``):
codebook-free rounding with a straight-through estimator.

- ``levels``: scalars per channel, e.g. ``(8, 8, 5, 5, 5)``, 8000 codes.
- encode: ``z = tanh(x + atanh(odd/max))·max − odd`` with
  ``max = (L−1)(1−eps)`` and ``odd = (L−1) % 2``, halved; rounded (half to
  even, as ``jnp.round``) through the STE; the output ``z / (L//2)`` lies
  in [−1, 1]; the code is the little-endian mixed-radix number of the
  shifted digits ``z + L//2``, int32.
- decode: digits ``(code // cumprod) % L``; ``z = digits/(L//2) − 1``.

Elementwise work and a small sum, no lookup: FSQ launches no kernel.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .ste import ste

__all__ = ["FSQCodec"]


@dataclasses.dataclass(frozen=True)
class FSQCodec:
    """Stateless mixed-radix FSQ encoder/decoder for one channel layout."""

    levels: tuple[int, ...]
    eps: float = 1e-3

    @cached_property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    @property
    def num_channels(self) -> int:
        return len(self.levels)

    @cached_property
    def _radix_cumprod(self) -> np.ndarray:
        # little-endian: code = sum_i digit_i * prod_{j<i} L_j
        return np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int64)

    def _const(self, values, like: torch.Tensor, dtype=None) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype or like.dtype, device=like.device)

    def _half(self, like: torch.Tensor, dtype=None) -> torch.Tensor:
        return self._const([l // 2 for l in self.levels], like, dtype)

    def bound(self, x: torch.Tensor) -> torch.Tensor:
        """The bounded pre-round value (halved, centred)."""
        levels = self._const(self.levels, x)
        max_ = (levels - 1) * (1 - self.eps)
        odd = self._const([(l - 1) % 2 for l in self.levels], x)
        z = torch.tanh(x + torch.atanh(odd / max_)) * max_ - odd
        return z / 2

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (..., C) -> (codes (...,) int32, z (..., C) in [−1, 1]); ``z``
        carries the STE gradient back to ``x``."""
        if x.shape[-1] != self.num_channels:
            raise ValueError(f"FSQ expects {self.num_channels} channels, got {tuple(x.shape)}")
        z = self.bound(x)
        z = ste(torch.round(z), z)
        half = self._half(x)
        digits = (z + half).detach().to(torch.int32)
        return self.to_decimal(digits), z / half

    def to_decimal(self, digits: torch.Tensor) -> torch.Tensor:
        cumprod = self._const(self._radix_cumprod.tolist(), digits, torch.int32)
        return torch.sum(digits * cumprod, dim=-1).to(torch.int32)

    def from_decimal(self, codes: torch.Tensor) -> torch.Tensor:
        cumprod = self._const(self._radix_cumprod.tolist(), codes, torch.int32)
        levels = self._const(self.levels, codes, torch.int32)
        return torch.remainder(torch.div(codes[..., None].to(torch.int32), cumprod, rounding_mode="floor"), levels)

    def decode(self, codes: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """codes (...,) -> z (..., C), lattice points in [−1, 1]."""
        digits = self.from_decimal(codes).to(dtype)
        return digits / self._half(digits, dtype) - 1.0

    def embeddings(self, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
        """The whole (K, C) lattice, the virtual codebook."""
        return self.decode(torch.arange(self.codebook_size, device=device), dtype=dtype)
