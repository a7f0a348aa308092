"""Train state (port of ``vector_quantization_tpu/training/state.py``).

The JAX package threads an immutable pytree through pure steps; the port
keeps the fields the AR step needs and updates them in place: ``model`` is
the module whose parameters the optimizer moves, ``opt_state`` the
optimizer's moments and count (``training/optim.py``), ``rng`` a
``torch.Generator`` on the model's device (train-time randomness such as
CFG dropout). The JAX state's ``extra`` (non-gradient algorithm state) and
``d_opt_state`` (the discriminator's optimizer) belong to later slices.
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

    def params(self) -> list[torch.Tensor]:
        """The trained parameters, in the optimizer state's order."""
        return list(self.model.parameters())
