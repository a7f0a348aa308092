"""Pairwise distances between flattened features and a codebook.

The functions of ``vector_quantization_tpu/ops/distances.py``: squared L2
through the matmul expansion ``‖x‖² − 2x·e + ‖e‖²`` (clamped at 0) and
``1 − x̂·ê`` for cosine, both (N, D) x (K, D) -> (N, K) float32. They
materialise the N×K matrix, so the lookup's hot path does not use them
(:mod:`.vq_lookup`); losses that need the full matrix (entropy) do.
"""

from __future__ import annotations

import torch

__all__ = ["l2_distance_sq", "cosine_distance", "normalize", "pairwise_distance"]


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(sum(x²) + eps)``, as the JAX package computes it (not
    ``F.normalize``, which divides by ``max(‖x‖, eps)``)."""
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=dim, keepdim=True) + eps)


def l2_distance_sq(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. x: (N, D), e: (K, D) -> (N, K), float32."""
    x = x.float()
    e = e.float()
    x_sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    e_sq = torch.sum(torch.square(e), dim=-1)
    return torch.clamp(x_sq - 2.0 * (x @ e.T) + e_sq[None, :], min=0.0)


def cosine_distance(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """1 − cos(x, e). x: (N, D), e: (K, D) -> (N, K), float32."""
    return 1.0 - normalize(x.float()) @ normalize(e.float()).T


def pairwise_distance(x: torch.Tensor, e: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "l2":
        return l2_distance_sq(x, e)
    if metric == "cosine":
        return cosine_distance(x, e)
    raise ValueError(f"unknown distance metric: {metric!r}")
