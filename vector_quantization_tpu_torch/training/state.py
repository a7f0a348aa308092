"""Train state (port of ``vector_quantization_tpu/training/state.py``).

The JAX package threads an immutable pytree through pure steps; the port
keeps the same fields and updates them in place: ``model`` is the module
whose parameters the optimizer moves, ``opt_state`` the optimizer's moments
and count (``training/optim.py``), ``rng`` a ``torch.Generator`` on the
model's device (train-time randomness such as CFG dropout),
``d_opt_state`` the second optimizer's (the GAN discriminator's; None
elsewhere), and ``extra`` the algorithm's non-gradient state, by name:
``ema_params`` (the EMA shadow of the model's parameters, which the state
owns), CVQ's ``probability`` and the lazy k-means init's ``initialized``
(a host bool), and, for VQGAN training, ``d_batch_stats`` and
``lpips_params``, for VQ-KD ``teacher_params``. Those three are the
discriminator's BatchNorm buffers and the frozen LPIPS and teacher weights
themselves, not copies: the modules own them and the step reads them
through the modules; ``extra`` carries the same tensors under the JAX
state's names, for a reader of the whole state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: dict[str, Any]
    rng: torch.Generator
    d_opt_state: dict[str, Any] | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def params(self) -> list[torch.Tensor]:
        """The model's parameters in order, as the optimizer takes them (it
        leaves out the ones its ``exclude`` matched)."""
        return list(self.model.parameters())
