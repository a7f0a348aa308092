"""GAN losses (``vector_quantization_tpu/models/losses/gan.py``).

- hinge discriminator loss: mean(relu(1 + fake) + relu(1 - real)) / 2;
- generator losses: ``vanilla`` mean(-fake), ``non_saturating``
  mean(softplus(-fake)) (BCE against 1);
- the R1 penalty: per-sample ‖∇_x D(x)‖² on real images, averaged, from
  ``torch.autograd.grad(..., create_graph=True)`` so that it can itself be
  differentiated with respect to the discriminator's weights.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["hinge_d_loss", "vanilla_g_loss", "non_saturating_g_loss", "r1_gradient_penalty"]


def hinge_d_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    loss = (F.relu(1.0 + logits_fake) + F.relu(1.0 - logits_real)) / 2.0
    return weight * torch.mean(loss)


def vanilla_g_loss(logits_fake: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * torch.mean(-logits_fake)


def non_saturating_g_loss(logits_fake: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * torch.mean(F.softplus(-logits_fake))


def r1_gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor, weight: float = 1.0
) -> torch.Tensor:
    """``d_apply`` must run the discriminator in eval mode (running BN
    statistics), as the JAX package's and the original's R1 pass does."""
    x = image.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    per_sample = torch.sum(torch.square(grads), dim=tuple(range(1, grads.dim())))
    return weight * torch.mean(per_sample)
