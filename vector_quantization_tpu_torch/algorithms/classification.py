"""Image classification: the linear probe over a frozen tokenizer's
quantized features (port of ``vector_quantization_tpu/algorithms/classification.py``).

Features: the frozen ``ir_model``'s ``encode_to_quant`` (the nearest-code
kernel on the card), ``quantizer.decode`` of the codes, the mean over the
h·w positions, all under ``no_grad``: the tokenizer is outside the
optimizer and never changes. Head (:class:`LinearProbe`): flax's
BatchNorm over (B, C) (momentum 0.99, eps 1e-5, the biased batch
variance; :class:`...models.layers.BatchNorm`) and a ``Linear`` started as
flax's ``Dense`` (lecun-normal kernel, zero bias), with flax's names
``BatchNorm_0`` and ``Dense_0``. Trained with LARS (``lr`` 0.1 by default)
on the mean integer-label cross-entropy; ``eval_step`` gives ``loss`` and
``accuracy`` (argmax, the first maximal index).

State, as the JAX ``TrainState`` has it: ``model`` the head,
``extra["ir_params"]`` the tokenizer's weights and ``extra["bn_stats"]``
the head's running statistics (the modules' own tensors, under the JAX
state's keys, so checkpoints and the bridge carry both). ``load_ir_from``
merges checkpoints' ``params`` over the tokenizer's tree (strict=False).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm
from ..registries import AlgorithmRegistry, ModelRegistry
from ..tasks.image_tokenization import model_device
from ..training.state import TrainState
from ..utils.bridge import flax_tree
from .base import Algorithm

__all__ = ["LinearProbe", "ClassificationAlgorithm"]


class LinearProbe(nn.Module):
    def __init__(self, in_features: int, num_categories: int) -> None:
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Dense_0 = nn.Linear(in_features, num_categories)
        with torch.no_grad():  # flax's lecun_normal: truncated at ±2 std, variance 1/fan_in
            std = math.sqrt(1.0 / in_features) / 0.87962566103423978
            nn.init.trunc_normal_(self.Dense_0.weight, std=std, a=-2 * std, b=2 * std)
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.Dense_0(self.BatchNorm_0(x, train))


@AlgorithmRegistry.register()
class ClassificationAlgorithm(Algorithm):
    def __init__(
        self,
        *,
        ir: Mapping[str, Any] | nn.Module,
        num_categories: int,
        image_size: int = 256,
        device: torch.device | str | None = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("optimizer", {"type": "lars", "lr": 0.1})
        self.device = model_device(device)
        if isinstance(ir, nn.Module):
            self.ir_model = ir.to(self.device)
        else:
            self.ir_model = ModelRegistry.build(ir, device=self.device)
        self.ir_model.requires_grad_(False).eval()
        self.num_categories = num_categories
        self.image_size = image_size
        head = LinearProbe(self.ir_model.quantizer.embedding_dim, num_categories)
        super().__init__(model=head.to(self.device), **kwargs)

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.extra["ir_params"] = dict(self.ir_model.named_parameters())
        state.extra["bn_stats"] = dict(self.model.named_buffers())
        return state

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        return {**super().extra_modules(), "ir_params": (self.ir_model, False), "bn_stats": (self.model, True)}

    def load_ir_from(self, state: TrainState, paths) -> TrainState:
        """Merge checkpoints' ``params`` over the tokenizer's tree, in place."""
        from ..training.checkpoints import load_model_from

        load_model_from(paths, flax_tree(self.ir_model))
        return state

    @torch.no_grad()
    def features(self, image: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> pooled quantized features (B, D)."""
        codes = self.ir_model.encode_to_quant(image.to(self.device))
        b, h, w = codes.shape
        z = self.ir_model.quantizer.decode(codes.reshape(-1))
        return z.reshape(b, h * w, -1).mean(dim=1)

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        feats = self.features(batch["image"])
        labels = batch["category"].to(self.device, torch.long)
        loss = F.cross_entropy(state.model(feats, train=True), labels)
        params = state.params()
        grads = list(torch.autograd.grad(loss, self.tx().trained(params)))
        self.tx().step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        logits = state.model(self.features(batch["image"]), train=False)
        labels = batch["category"].to(self.device, torch.long)
        return {"loss": F.cross_entropy(logits, labels),
                "accuracy": (torch.argmax(logits, dim=-1) == labels).float().mean()}
