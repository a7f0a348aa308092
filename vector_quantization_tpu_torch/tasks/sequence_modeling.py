"""Sequence modeling: the class-conditional token layout, the
teacher-forced loss and AR generation (port of
``vector_quantization_tpu/tasks/sequence_modeling.py``: ``TokenCodebook``,
``pack_c2i_tokens``, ``next_token_ce``, ``teacher_forced_sample``,
``generate``).

Vocabulary: ids [0, num_categories) are condition classes, then the
optional CFG uncondition token at ``num_categories``, then image codes
biased by ``num_categories + has_cfg``.

``generate`` prefills the prefix through the dense KV cache, then runs one
decode step per token in a Python loop (the JAX package's ``lax.scan``),
the cache growing by ``kv_segment`` columns at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..models.transformers.llama import resize_rows
from ..models.transformers.sampling import cfg_mix, sample_tokens

__all__ = ["TokenCodebook", "generate", "next_token_ce", "pack_c2i_tokens",
           "teacher_forced_sample"]


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


@torch.inference_mode()
def generate(
    transformer,
    prefix: torch.Tensor,
    num_tokens: int,
    image_codebook: TokenCodebook,
    generator: torch.Generator,
    *,
    sampler: Mapping[str, Any] | None = None,
    cfg_alpha: float | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    kv_segment: int | None = 32,
) -> torch.Tensor:
    """AR generation: prefill ``prefix`` through the dense KV cache, then
    sample one token and decode it, ``num_tokens`` times.

    prefix: (B, S) biased condition tokens on the model's device (already
    CFG-doubled when ``cfg_alpha`` is set: [uncond; cond]). Returns
    (B, num_tokens) int32 *debiased* image codes (the conditional half with
    CFG). Every step draws once from ``generator``, in token order, so the
    sampled stream does not depend on ``kv_segment``.

    ``kv_segment``: the cache starts at ``S + kv_segment`` columns and
    grows by ``kv_segment`` (zero columns, masked) between segments, so
    each step attends over the columns its segment needs rather than the
    whole ``max_length``; masked columns weigh exactly 0. ``None`` (or a
    segment of at least ``num_tokens``) allocates ``max_length`` columns
    once.
    """
    sampler = dict(sampler or {})
    b, s = prefix.shape
    if s + num_tokens > transformer.max_length:
        raise ValueError(
            f"generation length {s}+{num_tokens} exceeds the transformer's "
            f"max_length {transformer.max_length} (KV cache size)"
        )
    seg = int(kv_segment) if kv_segment is not None and kv_segment < num_tokens else None

    def limit(c: int) -> int:
        # columns needed through the end of segment c
        return s + min((c + 1) * seg, num_tokens)

    cache = transformer.init_cache(b, dtype=cache_dtype, device=prefix.device,
                                   rows=limit(0) if seg else None)
    kw = dict(temperature=sampler.get("temperature", 1.0), top_k=sampler.get("top_k", 0),
              top_p=sampler.get("top_p", 1.0))
    start, end = image_codebook.start, image_codebook.end
    logits, cache = transformer(prefix, cache)
    logits = logits[:, -1]
    tokens = []
    for i in range(num_tokens):
        if seg and i and i % seg == 0:
            cache = cache.map(lambda a, w=limit(i // seg): resize_rows(a, w))
        if cfg_alpha is not None:
            tok = sample_tokens(generator, cfg_mix(logits, cfg_alpha), start, end, **kw)
            tok = torch.cat([tok, tok])
        else:
            tok = sample_tokens(generator, logits, start, end, **kw)
        tokens.append(tok)
        logits, cache = transformer(tok[:, None], cache)
        logits = logits[:, -1]
    codes = torch.stack(tokens, dim=1)
    if cfg_alpha is not None:
        codes = codes[: b // 2]
    return image_codebook.debias(codes)

