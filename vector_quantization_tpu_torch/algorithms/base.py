"""Algorithm layer (port of ``vector_quantization_tpu/algorithms/base.py``,
the ``Algorithm`` base; ``ReconstructionAlgorithm`` belongs to the VQGAN
training slice).

An algorithm owns the trained model and the optimizer config and exposes
``init_state``, ``train_step`` and ``eval_step``. Where the JAX package's
steps are pure functions that return a new state, the port's update the
state's parameters and optimizer moments in place and return it.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..training.optim import Optimizer, build_optimizer
from ..training.state import TrainState

__all__ = ["Algorithm"]

_EMA = "ROADMAP.md queue A: EMA weights (ema_decay)"


class Algorithm:
    """Base: owns model + optimizer; subclasses define the loss."""

    def __init__(
        self,
        *,
        model: nn.Module,
        optimizer: Mapping[str, Any] | None = None,
        ema_decay: float | None = None,
    ) -> None:
        if ema_decay is not None:
            raise NotImplementedError(_EMA)
        self.model = model
        self.optimizer_cfg = dict(optimizer or {"type": "adam", "lr": 1e-4})
        self._tx: Optimizer | None = None

    def tx(self) -> Optimizer:
        if self._tx is None:
            self._tx = build_optimizer(self.optimizer_cfg)
        return self._tx

    def init_state(self, seed: int = 0) -> TrainState:
        """Step 0: the model's current weights, fresh optimizer moments, and
        a generator seeded with ``seed`` on the model's device."""
        params = list(self.model.parameters())
        device = params[0].device
        return TrainState(
            step=0,
            model=self.model,
            opt_state=self.tx().init(params),
            rng=torch.Generator(device=device).manual_seed(seed),
        )

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        raise NotImplementedError

    def eval_step(self, state: TrainState, batch) -> dict:
        raise NotImplementedError
