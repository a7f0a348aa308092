"""AR prior training, class-conditional (port of
``vector_quantization_tpu/algorithms/ar.py``, ``ARAlgorithm``).

A frozen tokenizer bridges pixels and codes; the transformer is
teacher-forced on [category | image codes] sequences; CFG dropout replaces
a category by the uncondition token with probability ``cfg`` during
training. A batch carrying ``codes`` skips the tokenizer; one carrying
``image`` is tokenized by ``encode_to_quant`` (the nearest-code kernel on
the card) under ``no_grad``. The tokenizer is outside the optimizer and
its weights never change, as the JAX package keeps its params in
``state.extra`` under ``stop_gradient``.

``train_step``: tokens -> the fused-CE loss (or the dense head +
``next_token_ce``) -> gradients -> the optimizer, in place.
``eval_step``: the dense head's CE and the teacher-forced sampling
accuracy. Generation (``generate_step``, ``half_generate_step``,
``eval_generate``) needs the dense KV cache, a later slice: it raises.

The algorithm runs on CUDA unless built with ``device="cpu"``
(``AlgorithmRegistry.build(cfg, device="cpu")``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..registries import AlgorithmRegistry, ModelRegistry, TransformerRegistry
from ..tasks.image_tokenization import model_device
from ..tasks.sequence_modeling import (
    TokenCodebook,
    next_token_ce,
    pack_c2i_tokens,
    teacher_forced_sample,
)
from ..training.state import TrainState
from .base import Algorithm

__all__ = ["ARAlgorithm"]

_DENSE_SLICE = "ROADMAP.md queue A: the dense shared-column engine and generate()"


@AlgorithmRegistry.register()
class ARAlgorithm(Algorithm):
    def __init__(
        self,
        *,
        transformer: Mapping[str, Any],
        ir: Mapping[str, Any] | nn.Module,
        num_categories: int,
        cfg: float | None = None,
        cfg_alpha: float = 1.75,
        sampler: Mapping[str, Any] | None = None,
        image_size: int = 256,
        eval_generate: bool = False,
        fused_ce: bool = True,
        device: torch.device | str | None = None,
        **kwargs: Any,
    ) -> None:
        if eval_generate:
            raise NotImplementedError(f"eval_generate: {_DENSE_SLICE}")
        self.device = model_device(device)
        self.fused_ce = fused_ce
        if isinstance(ir, nn.Module):
            self.ir_model = ir.to(self.device)
        else:
            self.ir_model = ModelRegistry.build(ir, device=self.device)
        self.ir_model.requires_grad_(False).eval()
        codebook_size = self.ir_model.quantizer.codebook_size
        self.num_categories = num_categories
        self.cfg = cfg
        self.cfg_alpha = cfg_alpha
        self.sampler = dict(sampler or {"temperature": 1.0, "top_k": 600, "top_p": 0.92})
        self.image_size = image_size
        self.image_hw = image_size // self.ir_model.encoder.downsample_factor
        num_cond = num_categories + (1 if cfg is not None else 0)
        self.image_codebook = TokenCodebook(num_cond, codebook_size)
        t_cfg = dict(transformer)
        t_cfg.setdefault("vocabulary_size", num_cond + codebook_size)
        t_cfg.setdefault("max_length", 1 + self.image_hw * self.image_hw)
        super().__init__(model=TransformerRegistry.build(t_cfg).to(self.device), **kwargs)

    @property
    def uncondition_token(self) -> int:
        return self.num_categories

    # -- pieces ------------------------------------------------------------

    def encode_image_tokens(self, image: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> code grids (B, h, w), no gradient."""
        with torch.no_grad():
            return self.ir_model.encode_to_quant(image)

    def _tokens(self, state: TrainState, batch, train: bool) -> torch.Tensor:
        if "codes" in batch:
            codes = batch["codes"].to(self.device)
        else:
            codes = self.encode_image_tokens(batch["image"].to(self.device))
        category = batch["category"].to(self.device, torch.int32)
        if self.cfg is not None and train:
            u = torch.rand(category.shape, generator=state.rng, device=self.device)
            category = torch.where(u < self.cfg, self.uncondition_token, category)
        return pack_c2i_tokens(category, codes, self.image_codebook)

    def _use_fused(self) -> bool:
        return (self.fused_ce and getattr(self.model, "supports_fused_ce", False)
                and not getattr(self.model, "quantize", False))

    # -- steps -------------------------------------------------------------

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        tokens = self._tokens(state, batch, train=True)
        model = state.model
        params = state.params()
        if self._use_fused():
            loss = model(tokens, fused_ce_targets=tokens)
        else:
            loss = next_token_ce(model(tokens), tokens)
        grads = list(torch.autograd.grad(loss, params))
        self.tx().step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach()}

    def eval_step(self, state: TrainState, batch, generator: torch.Generator | None = None) -> dict:
        """Loss and token accuracy; the accuracy's draws use ``generator``
        (default: one seeded with the state's step)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(state.step)
        with torch.no_grad():
            tokens = self._tokens(state, batch, train=False)
            logits = state.model(tokens)
            loss = next_token_ce(logits, tokens)
            sampled = teacher_forced_sample(generator, logits[:, :-1], self.image_codebook,
                                            self.sampler)
            gt = tokens[:, 1:]
            accuracy = (sampled == gt).float().mean()
        return {"loss": loss, "accuracy": accuracy, "codes": gt}

    def half_generate_step(self, state: TrainState, batch, rng):
        raise NotImplementedError(f"half_generate_step: {_DENSE_SLICE}")

    def generate_step(self, state: TrainState, category, rng):
        raise NotImplementedError(f"generate_step: {_DENSE_SLICE}")
