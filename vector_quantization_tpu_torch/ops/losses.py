"""Quantizer losses (``vector_quantization_tpu/ops/losses.py``):

- ``codebook_loss``   = mean ‖z − sg(x)‖² (trains the codebook via the gather);
- ``commitment_loss`` = mean ‖sg(z) − x‖² (pulls the encoder to the code);
- ``vqgan_quantizer_loss`` = codebook + β·commitment;
- ``entropy_loss``    = sample entropy − mean entropy of softmax(sign·distance/T).

Each takes a ``weight`` multiplier, as the configs pass it.
"""

from __future__ import annotations

import torch

__all__ = ["codebook_loss", "commitment_loss", "vqgan_quantizer_loss", "entropy_loss"]


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))


def codebook_loss(z: torch.Tensor, x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * _mse(z, x.detach())


def commitment_loss(z: torch.Tensor, x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * _mse(z.detach(), x)


def vqgan_quantizer_loss(
    z: torch.Tensor, x: torch.Tensor, beta: float = 0.25, weight: float = 1.0
) -> torch.Tensor:
    return weight * (codebook_loss(z, x) + beta * commitment_loss(z, x))


def entropy_loss(
    distance: torch.Tensor, temperature: float, sign: float = 1.0, weight: float = 1.0
) -> torch.Tensor:
    """distance: (..., K), the full distance matrix."""
    affinity = sign * distance.reshape(-1, distance.shape[-1]) / temperature
    probs = torch.softmax(affinity, dim=-1)
    log_probs = torch.log_softmax(affinity + 1e-5, dim=-1)
    avg_probs = torch.mean(probs, dim=0)
    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-5))
    sample_entropy = -torch.mean(torch.sum(probs * log_probs, dim=-1))
    return weight * (sample_entropy - avg_entropy)
