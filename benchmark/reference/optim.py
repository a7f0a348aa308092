"""Adam and AdamW as optax computes them, plain PyTorch, one leaf at a time.

``clip_by_global_norm`` (scaled by ``max_norm / ‖g‖`` only when ``‖g‖ >=
max_norm``), ``scale_by_adam`` with bias correction at the update count,
``u = m̂ / (sqrt(v̂) + eps)``; AdamW adds ``weight_decay · p`` to ``u``
before the learning rate; a constant learning rate.
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = None) -> None:
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> list:
        """Moves the parameters; returns the gradients as the moments took
        them (after the clip)."""
        grads = [g.clone() for g in grads]
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            if norm >= self.grad_clip:
                grads = [g * (self.grad_clip / norm) for g in grads]
        self.count += 1
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / (1.0 - self.b1 ** self.count)) / (torch.sqrt(v / (1.0 - self.b2 ** self.count)) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(self.lr * u)
        return grads
