"""Sequence modeling: the class-conditional token layout (port of
``vector_quantization_tpu/tasks/sequence_modeling.py``, ``TokenCodebook``
and ``pack_c2i_tokens``).

Vocabulary: ids [0, num_categories) are condition classes, then the
optional CFG uncondition token at ``num_categories``, then image codes
biased by ``num_categories + has_cfg``. ``generate()`` (the dense KV cache)
is a later slice (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TokenCodebook", "pack_c2i_tokens"]


@dataclasses.dataclass(frozen=True)
class TokenCodebook:
    """Id-range bias/debias."""

    start: int
    size: int

    @property
    def end(self) -> int:
        return self.start + self.size

    def bias(self, tokens):
        return tokens + self.start

    def debias(self, tokens):
        return tokens - self.start


def pack_c2i_tokens(
    category: torch.Tensor, image_codes: torch.Tensor, image_codebook: TokenCodebook
) -> torch.Tensor:
    """[category | biased image codes] -> (B, 1 + h*w) int32."""
    codes = image_codebook.bias(image_codes.reshape(image_codes.shape[0], -1))
    return torch.cat(
        [category[:, None].to(torch.int32), codes.to(torch.int32)], dim=1
    )
