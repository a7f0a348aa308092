"""VQGAN: the GAN-trained tokenizer's two-optimizer train step (port of
``vector_quantization_tpu/algorithms/vqgan.py``, ``VQGANAlgorithm``).

One ``train_step``, in the JAX step's order:

1. **Generation.** encode -> quantize (the nearest-code kernel on the card)
   -> decode; ``q_loss`` (the quantizer's), ``r_loss`` (the configured
   recon losses, LPIPS among them) and, once ``step >= discriminator_start``,
   ``g_loss`` of the discriminator's logits on the reconstruction, the
   discriminator in eval mode (running BatchNorm statistics) with its
   pre-step weights. The adaptive weight ``aglw = ‖∇_last r_loss‖ /
   (‖∇_last g_loss‖ + 1e-4)``, clipped to [0, 1e4], detached, times
   ``aglw_gain``, where ``last`` is the decoder's final conv weight: two
   ``torch.autograd.grad(..., retain_graph=True)`` on the training pass's
   own graph, as the original computes it. Before ``discriminator_start``
   ``g_loss`` is 0 and ``aglw`` is ``aglw_gain or 1.0``. The generator's
   gradient of ``q_loss + r_loss + g_loss·aglw`` (taken with respect to
   the generator's parameters only, so nothing lands in the
   discriminator's ``.grad``) moves it, once ``step >= generator_start``.
2. The codebook update (``normalize``) on the updated codebook.
3. **Discrimination**, once ``step >= discriminator_start``: the R1 penalty
   (if ``r1_weight``) with the discriminator in eval mode and its
   statistics from before this step's passes; then the discriminator in
   train mode on the detached reconstruction of step 1, then on the real
   images (two forwards: the running statistics move twice, in that
   order); the hinge loss (+ R1) moves the discriminator through its own
   optimizer.
4. The EMA of the generator's parameters (``ema_decay``).

Each phase runs inside a span (``utils.debug.span``, recorded only while a
profiler records): ``vq.vqgan.generation``, ``vq.vqgan.aglw``, the
generator's ``vq.backward`` and ``vq.optimizer``, ``vq.codebook_update``,
``vq.vqgan.discrimination`` (its optimizer a nested ``vq.optimizer``) and
``vq.ema``, all inside ``vq.train_step``.

The step is a host int, so the gates are Python ``if``s. The discriminator
belongs to the algorithm (``self.discriminator``) and owns its BatchNorm
buffers (``state.extra["d_batch_stats"]`` holds the same tensors); its
optimizer's moments are ``state.d_opt_state``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..models.discriminators import patchgan as _patchgan  # noqa: F401  (registers)
from ..models.discriminators import stylegan2 as _stylegan2  # noqa: F401
from ..models.losses.gan import (
    hinge_d_loss,
    non_saturating_g_loss,
    r1_gradient_penalty,
    vanilla_g_loss,
)
from ..registries import AlgorithmRegistry, DiscriminatorRegistry
from ..training.optim import Optimizer, build_optimizer
from ..training.state import TrainState
from ..utils.bridge import flax_tree
from ..utils.debug import span
from .base import ReconstructionAlgorithm

__all__ = ["VQGANAlgorithm"]

G_LOSSES = {"vanilla": vanilla_g_loss, "non_saturating": non_saturating_g_loss}


@AlgorithmRegistry.register()
class VQGANAlgorithm(ReconstructionAlgorithm):
    codebook_path = ("generator", "quantizer", "codebook")

    def __init__(
        self,
        *,
        discriminator: Mapping[str, Any] | nn.Module,
        d_optimizer: Mapping[str, Any] | None = None,
        generator_start: int = 0,
        discriminator_start: int = 0,
        generator_loss: str = "vanilla",
        aglw_gain: float | None = 0.8,
        r1_weight: float | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(discriminator, nn.Module):
            discriminator = DiscriminatorRegistry.build(discriminator)
        self.discriminator = discriminator.to(self.device)
        self.d_optimizer_cfg = dict(d_optimizer or self.optimizer_cfg)
        self._d_tx: Optimizer | None = None
        if min(generator_start, discriminator_start) != 0:
            raise ValueError("one of generator_start and discriminator_start must be 0")
        self.g_start = generator_start
        self.d_start = discriminator_start
        self.g_loss_fn = G_LOSSES[generator_loss]
        self.aglw_gain = aglw_gain
        self.r1_weight = r1_weight

    def d_tx(self) -> Optimizer:
        if self._d_tx is None:
            self._d_tx = build_optimizer(self.d_optimizer_cfg)
        return self._d_tx

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.d_opt_state = self.d_tx().init(list(self.discriminator.parameters()))
        state.extra["d_batch_stats"] = dict(self.discriminator.named_buffers())
        return state

    def param_tree(self, state: TrainState) -> dict[str, Any]:
        return {"generator": flax_tree(state.model), "discriminator": flax_tree(self.discriminator)}

    def optimizer_states(self, state: TrainState) -> dict:
        return {**super().optimizer_states(state),
                "d_opt_state": (self.d_tx(), self.discriminator, state.d_opt_state)}

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        return {**super().extra_modules(), "d_batch_stats": (self.discriminator, True)}

    # -- pieces ------------------------------------------------------------

    def _r_loss(self, pred, image) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        losses = {f"loss_{name}": self._recon(name, cfg, pred, image)
                  for name, cfg in self.recon_losses.items()}
        return sum(losses.values(), self._zero()), losses

    def _extra_generation_losses(self, model, out, batch, extra) -> dict:
        """Hook for hybrid algorithms to add losses to the generation
        phase. Default: none."""
        return {}

    def _augment_generation_out(self, model, out, generator) -> dict:
        """Hook for hybrid algorithms to add model outputs to the
        generation phase's ``out``. Default: unchanged."""
        return out

    def _aglw(self, r_loss, g_loss, last) -> torch.Tensor:
        with span("vq.vqgan.aglw"):
            (r_grad,) = torch.autograd.grad(r_loss, last, retain_graph=True)
            (g_grad,) = torch.autograd.grad(g_loss, last, retain_graph=True)
            if self.strategy is not None:  # the global losses' gradients
                self.strategy.reduce_mean([r_grad, g_grad])
            aglw = torch.linalg.vector_norm(r_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
            return torch.clamp(aglw, 0.0, 1e4).detach() * self.aglw_gain

    # -- train step --------------------------------------------------------

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        with span("vq.train_step"):
            image = batch["image"].to(self.device)
            model, disc = state.model, self.discriminator
            with_g = state.step >= self.g_start
            with_d = state.step >= self.d_start

            # ---- generation ----
            with span("vq.vqgan.generation"):
                feat = model.encode(image)
                qout = model.quantize(feat, train=True)
                pred = model.decode(qout.z)
                out = self._augment_generation_out(model, {"feat": feat, "quantizer": qout, "pred": pred},
                                                   state.rng)
                q_loss = qout.loss
                r_loss, r_losses = self._r_loss(pred, image)
                if with_d:
                    g_loss = self.g_loss_fn(disc(pred, train=False))
            if with_d:
                if self.aglw_gain is None:
                    aglw = torch.ones((), dtype=torch.float32, device=self.device)
                else:
                    aglw = self._aglw(r_loss, g_loss, model.decoder.last_parameter())
            else:
                g_loss = self._zero()
                aglw = torch.full((), self.aglw_gain or 1.0, dtype=torch.float32, device=self.device)
            total = q_loss + r_loss + g_loss * aglw
            extra_losses = self._extra_generation_losses(model, out, batch, state.extra)
            total = total + sum(extra_losses.values(), self._zero())
            if with_g:
                self._step_gradients(state, total)
            self._codebook_update(state, qout)

            # ---- discrimination ----
            d_loss = r1 = self._zero()
            if with_d:
                with span("vq.vqgan.discrimination"):
                    d_params = list(disc.parameters())
                    if self.r1_weight:
                        r1 = r1_gradient_penalty(lambda x: disc(x, train=False), image, self.r1_weight)
                    logits_fake = disc(pred.detach(), train=True)
                    logits_real = disc(image, train=True)
                    d_loss = hinge_d_loss(logits_fake, logits_real)
                    d_grads = torch.autograd.grad(d_loss + r1, d_params, allow_unused=True,
                                                  materialize_grads=True)
                    self.apply_gradients(self.d_tx(), d_params, list(d_grads), state.d_opt_state)

            self.maybe_update_ema(state.extra, model)
            state.step += 1
            metrics = {"loss": total, "d_loss": d_loss, "r1_gp": r1, "q_loss": q_loss,
                       "r_loss": r_loss, "g_loss": g_loss, "aglw": aglw, **r_losses, **qout.losses,
                       **extra_losses}
            return state, {k: v.detach() for k, v in metrics.items()}

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        image = batch["image"].to(self.device)
        out = state.model(image, train=False)
        r_loss, r_losses = self._r_loss(out["pred"], image)
        return {"pred": out["pred"], "codes": out["quantizer"].codes, "r_loss": r_loss, **r_losses}
