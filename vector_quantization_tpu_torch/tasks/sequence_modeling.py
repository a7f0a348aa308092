"""Sequence modeling: the class-conditional token layout and the
teacher-forced loss (port of
``vector_quantization_tpu/tasks/sequence_modeling.py``: ``TokenCodebook``,
``pack_c2i_tokens``, ``next_token_ce``, ``teacher_forced_sample``).

Vocabulary: ids [0, num_categories) are condition classes, then the
optional CFG uncondition token at ``num_categories``, then image codes
biased by ``num_categories + has_cfg``. ``generate()`` (the dense KV cache)
is a later slice (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..models.transformers.sampling import sample_tokens

__all__ = ["TokenCodebook", "next_token_ce", "pack_c2i_tokens", "teacher_forced_sample"]


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


def next_token_ce(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced CE: logits (B, T, V) predicting tokens[:, 1:], in f32."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def teacher_forced_sample(
    generator: torch.Generator,
    logits: torch.Tensor,
    image_codebook: TokenCodebook,
    sampler: Mapping[str, Any],
) -> torch.Tensor:
    """Re-sample every position from teacher-forced logits (B, T, V) within
    the image range (the token accuracy metric's draw): (B, T) int32 ids.
    The same distribution as the JAX package's draw, not the same stream."""
    b, t, v = logits.shape
    tokens = sample_tokens(
        generator,
        logits.reshape(b * t, v),
        image_codebook.start,
        image_codebook.end,
        temperature=sampler.get("temperature", 1.0),
        top_k=sampler.get("top_k", 0),
        top_p=sampler.get("top_p", 1.0),
    )
    return tokens.reshape(b, t)
