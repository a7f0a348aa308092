"""The VQGAN + VQ-KD hybrid (port of
``vector_quantization_tpu/algorithms/exp_vqgan_vqkd.py``).

``VQGANVQKDModel`` is an ``AutoencoderModel`` with a second branch on the
quantized features ``quantizer.z``: a connector (``vqkd_pre_decode``,
its ``in_channels`` the codebook's width and its ``out_channels`` by default
the branch decoder's ``in_channels``) and a feature decoder
(``vqkd_decoder``, VQ-KD's ``ViTDecoder``) that predicts a frozen teacher's
features. Its forward adds ``vqkd_pred`` to the autoencoder's outputs.

``VQGANVQKDAlgorithm`` is ``VQGANAlgorithm`` plus that teacher: frozen, in
eval mode, run under ``no_grad`` on ``batch["original_image"]`` (uint8
NHWC), its weights in ``state.extra["teacher_params"]`` (the module's own
tensors, as ``VQKDAlgorithm`` holds them, so checkpoints carry them). The
generation phase gains ``loss_distill = distill_weight · cosine_loss(
vqkd_pred, teacher features)``. The VQGAN step runs encode, quantize and
decode one by one and never calls the model's forward, so the branch runs
once a step, in ``_augment_generation_out``. ``codebook_update`` defaults to
EMA k-means (decay 0.99) where the config names none; a config's own value
wins, as in the JAX package. The teacher's feature map must match the
branch's output grid (the teacher's ``image_size``/``output_size``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..models.autoencoders import vit as _vit  # noqa: F401  (registers ViTDecoder)
from ..models.losses.recon import cosine_loss
from ..registries import AlgorithmRegistry, ConnectorRegistry, DecoderRegistry, ModelRegistry, TeacherRegistry
from ..tasks.image_reconstruction import AutoencoderModel
from ..tasks.image_tokenization import build_submodule, model_device, nchw, nhwc
from ..training.state import TrainState
from . import vqkd as _vqkd  # noqa: F401  (registers the teachers)
from .vqgan import VQGANAlgorithm

__all__ = ["VQGANVQKDModel", "VQGANVQKDAlgorithm"]


@ModelRegistry.register()
class VQGANVQKDModel(AutoencoderModel):
    """``AutoencoderModel`` + the feature-decoder branch."""

    def __init__(
        self,
        encoder: nn.Module,
        quantizer: nn.Module,
        post_encode: nn.Module | None = None,
        decoder: nn.Module | None = None,
        pre_decode: nn.Module | None = None,
        vqkd_decoder: nn.Module | None = None,
        vqkd_pre_decode: nn.Module | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__(encoder, quantizer, post_encode, decoder, pre_decode, device)
        self.vqkd_decoder = vqkd_decoder
        self.vqkd_pre_decode = vqkd_pre_decode
        self.to(model_device(device))

    @classmethod
    def build_pre_hook(cls, config, registry):
        config = super().build_pre_hook(config, registry)
        config["vqkd_decoder"] = build_submodule(DecoderRegistry, config["vqkd_decoder"])
        pd = config.get("vqkd_pre_decode")
        if isinstance(pd, Mapping):
            pd = dict(pd)
            pd.setdefault("in_channels", config["quantizer"].embedding_dim)
            if hasattr(config["vqkd_decoder"], "in_channels"):
                pd.setdefault("out_channels", config["vqkd_decoder"].in_channels)
            config["vqkd_pre_decode"] = build_submodule(ConnectorRegistry, pd)
        return config

    def vqkd_decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, D) quantized features -> predicted teacher features
        (B, h', w', C)."""
        z = nchw(z)
        if self.vqkd_pre_decode is not None:
            z = self.vqkd_pre_decode(z)
        return nhwc(self.vqkd_decoder(z))

    def forward(self, x: torch.Tensor, train: bool = False) -> dict[str, Any]:
        out = super().forward(x, train=train)
        out["vqkd_pred"] = self.vqkd_decode(out["quantizer"].z)
        return out


@AlgorithmRegistry.register()
class VQGANVQKDAlgorithm(VQGANAlgorithm):
    def __init__(
        self,
        *,
        teacher: Mapping[str, Any] | nn.Module,
        distill_weight: float = 1.0,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("codebook_update", {"type": "kmeans", "decay": 0.99})
        super().__init__(**kwargs)
        if not isinstance(teacher, nn.Module):
            teacher = TeacherRegistry.build(teacher)
        self.teacher = teacher.to(self.device).eval().requires_grad_(False)
        self.distill_weight = distill_weight

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.extra["teacher_params"] = dict(self.teacher.named_parameters())
        return state

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        return {**super().extra_modules(), "teacher_params": (self.teacher, False)}

    def _augment_generation_out(self, model, out, generator) -> dict:
        out["vqkd_pred"] = model.vqkd_decode(out["quantizer"].z)
        return out

    def _extra_generation_losses(self, model, out, batch, extra) -> dict:
        with torch.no_grad():
            feats = self.teacher(torch.as_tensor(batch["original_image"]).to(self.device), return_2d=True)
        return {"loss_distill": self.distill_weight * cosine_loss(out["vqkd_pred"], feats)}
