"""Samplers for AR generation (port of
``vector_quantization_tpu/models/transformers/sampling.py``).

Top-k / top-p filtering as value-threshold bisections instead of a
vocabulary sort (HF ``top_k_top_p_filtering`` semantics: keep the top-k,
then drop tokens whose preceding cumulative probability exceeds top_p,
always keeping the most likely token); filtered logits are set to -1e10.
Sampling is Gumbel-max from a ``torch.Generator``: the same distribution as
``jax.random.categorical``, not the same stream.
"""

from __future__ import annotations

import torch

__all__ = ["top_k_top_p_filter", "sample_tokens", "cfg_mix"]

_NEG = -1e10


def _kth_largest(x: torch.Tensor, k: int, iters: int = 40) -> torch.Tensor:
    """Per-row k-th largest value of (B, V) x by threshold bisection on the
    [row_min, row_max] bracket, snapped to the smallest realised value >= the
    final lower bound."""
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take_upper = (x >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(take_upper, mid, lo), torch.where(take_upper, hi, mid)
    return torch.where(x >= lo, x, torch.inf).amin(dim=-1, keepdim=True)


def top_k_top_p_filter(
    logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """(B, V) logits -> filtered logits (dropped entries = -1e10)."""
    v = logits.shape[-1]
    k = top_k if (top_k and top_k < v) else v
    if k < v:
        logits = torch.where(logits < _kth_largest(logits, k), _NEG, logits)
    if top_p < 1.0:
        # keep token i iff the mass strictly above its probability is still
        # < top_p (plus always the argmax)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp((logits - m).float())
        e = torch.where(logits <= _NEG, 0.0, e)
        target = top_p * e.sum(dim=-1, keepdim=True)
        e_max = e.amax(dim=-1, keepdim=True)
        lo, hi = torch.zeros_like(e_max), e_max
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            cond = torch.where(e > mid, e, 0.0).sum(dim=-1, keepdim=True) >= target
            lo, hi = torch.where(cond, mid, lo), torch.where(cond, hi, mid)
        e_thr = torch.where(e > lo, e, torch.inf).amin(dim=-1, keepdim=True)
        keep = (e >= e_thr) | (e == e_max)
        logits = torch.where(keep, logits, _NEG)
    return logits


def sample_tokens(
    generator: torch.Generator,
    logits: torch.Tensor,
    start: int,
    end: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids in [start, end)."""
    logits = logits[:, start:end] / temperature
    logits = top_k_top_p_filter(logits, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    tokens = torch.argmax(logits + gumbel, dim=-1)
    return (tokens + start).to(torch.int32)


def cfg_mix(logits: torch.Tensor, alpha: float) -> torch.Tensor:
    """Doubled batch [uncond; cond] (halves) -> (B/2, V) mixed logits."""
    uncond, cond = logits.chunk(2, dim=0)
    return (1.0 - alpha) * uncond + alpha * cond
