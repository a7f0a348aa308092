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

``state.extra["ir_params"]`` holds the tokenizer's weights by name (the
module's own tensors, under the JAX state's key). ``load_ir_from`` merges
checkpoints' ``params`` over ``{"params": <the tokenizer's tree>}`` as the
JAX package does (``training/checkpoints.load_model_from``, strict=False):
only a checkpoint whose ``params`` hold a ``params`` subtree reaches the
tokenizer, so a VQGAN or reconstruction checkpoint leaves it unchanged.

``train_step``: tokens -> the fused-CE loss (or the dense head +
``next_token_ce``) -> gradients -> the optimizer, in place; inside the
span ``vq.train_step``, the spans ``vq.ar.tokens``, ``vq.ar.forward``,
``vq.backward`` and ``vq.optimizer`` (``utils.debug.span``). A model with
``returns_aux`` (the DeepSeek-V3 prior) also gives an auxiliary loss,
added to the CE, and its ``after_step`` runs after the optimizer, inside
``vq.ar.after_step`` (its experts' balancing bias).
``eval_step``: the dense head's CE and the teacher-forced sampling
accuracy (with ``eval_generate``, also the generated images of the
batch's classes). ``generate_step``: classes -> images through
``tasks/sequence_modeling.generate`` (CFG as configured) and the
tokenizer's decoder; ``half_generate_step``: the back half of each image
regenerated from its ground-truth front half.

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
    generate,
    next_token_ce,
    pack_c2i_tokens,
    teacher_forced_sample,
)
from ..training.state import TrainState
from ..utils.bridge import flax_tree
from ..utils.debug import span
from .base import Algorithm

__all__ = ["ARAlgorithm"]


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
        # eval_generate: eval_step also generates the batch's classes
        # (costly; off by default)
        self.eval_generate = eval_generate
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
        kind = t_cfg["type"]
        if getattr(TransformerRegistry.get(kind) if isinstance(kind, str) else kind, "builds_on_device", False):
            t_cfg.setdefault("device", self.device)  # its weights drawn there, not on the host
        super().__init__(model=TransformerRegistry.build(t_cfg).to(self.device), **kwargs)

    @property
    def uncondition_token(self) -> int:
        return self.num_categories

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.extra["ir_params"] = dict(self.ir_model.named_parameters())
        return state

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        return {**super().extra_modules(), "ir_params": (self.ir_model, False)}

    def load_ir_from(self, state: TrainState, paths) -> TrainState:
        """Merge checkpoints' ``params`` over ``{"params": ir_params}`` in
        place (the JAX package's composition; see the module docstring)."""
        from ..training.checkpoints import load_model_from

        load_model_from(paths, {"params": flax_tree(self.ir_model)})
        return state

    # -- pieces ------------------------------------------------------------

    def encode_image_tokens(self, image: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> code grids (B, h, w), no gradient."""
        with torch.no_grad():
            return self.ir_model.encode_to_quant(image)

    def decode_image_tokens(self, codes: torch.Tensor) -> torch.Tensor:
        """code grids (B, h, w) -> pixels (B, H, W, 3) in [-1, 1]."""
        with torch.no_grad():
            return self.ir_model.decode_from_quant(codes)

    def _tokens(self, state: TrainState, batch, train: bool) -> torch.Tensor:
        if "codes" in batch:
            codes = batch["codes"].to(self.device)
        else:
            codes = self.encode_image_tokens(batch["image"].to(self.device))
        category = batch["category"].to(self.device, torch.int32)
        if self.cfg is not None and train:
            # the global batch's draw, this rank's rows of it
            b = category.shape[0]
            n, r = (1, 0) if self.strategy is None else (self.strategy.data_size, self.strategy.data_rank)
            u = torch.rand((n * b,), generator=state.rng, device=self.device)[r * b:(r + 1) * b]
            category = torch.where(u < self.cfg, self.uncondition_token, category)
        return pack_c2i_tokens(category, codes, self.image_codebook)

    def _use_fused(self) -> bool:
        return (self.fused_ce and getattr(self.model, "supports_fused_ce", False)
                and not getattr(self.model, "quantize", False))

    # -- steps -------------------------------------------------------------

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        with span("vq.train_step"):
            with span("vq.ar.tokens"):
                tokens = self._tokens(state, batch, train=True)
            model = state.model
            params = state.params()
            aux = None
            with span("vq.ar.forward"):
                if self._use_fused():
                    loss = model(tokens, fused_ce_targets=tokens)
                elif getattr(model, "returns_aux", False):
                    logits, aux = model(tokens, return_aux=True)
                    loss = next_token_ce(logits, tokens) + aux["balance"]
                else:
                    loss = next_token_ce(model(tokens), tokens)
            with span("vq.backward"):
                # a routed expert that no token chose this step takes a zero gradient
                grads = list(torch.autograd.grad(loss, params, allow_unused=aux is not None,
                                                 materialize_grads=aux is not None))
            self.apply_gradients(self.tx(), params, grads, state.opt_state)
            if aux is not None:
                with span("vq.ar.after_step"):
                    model.after_step(aux)
            state.step += 1
        return state, {"loss": loss.detach()}

    def eval_step(self, state: TrainState, batch, generator: torch.Generator | None = None) -> dict:
        """Loss and token accuracy (and with ``eval_generate`` the images
        generated for the batch's classes); the accuracy's draws and the
        generation's use ``generator`` (default: one seeded with the
        state's step)."""
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
        memo = {"loss": loss, "accuracy": accuracy, "codes": gt}
        if self.eval_generate:
            memo["generated_image"] = self.generate_step(state, batch["category"], generator)
        return memo

    def half_generate_step(self, state: TrainState, batch, generator: torch.Generator):
        """Regenerate the back half of each image from its ground-truth
        front half: images (B, H, W, 3) in [-1, 1]."""
        tokens = self._tokens(state, batch, train=False)
        total = self.image_hw * self.image_hw
        keep = total // 2
        back = generate(state.model, tokens[:, : 1 + keep], total - keep, self.image_codebook,
                        generator, sampler=self.sampler)
        front = self.image_codebook.debias(tokens[:, 1 : 1 + keep])
        codes = torch.cat([front, back], dim=1).reshape(-1, self.image_hw, self.image_hw)
        return self.decode_image_tokens(codes)

    def generate_step(self, state: TrainState, category, generator: torch.Generator):
        """category (B,) -> images (B, H, W, 3) in [-1, 1]."""
        cond = torch.as_tensor(category).to(self.device, torch.int32)
        if self.cfg is not None:
            cond = torch.cat([torch.full_like(cond, self.uncondition_token), cond])
        codes = generate(state.model, cond[:, None], self.image_hw * self.image_hw,
                         self.image_codebook, generator, sampler=self.sampler,
                         cfg_alpha=self.cfg_alpha if self.cfg is not None else None)
        return self.decode_image_tokens(codes.reshape(-1, self.image_hw, self.image_hw))
