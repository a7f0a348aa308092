"""VectorQuantizer: the codebook lookup quantizer
(``vector_quantization_tpu/models/quantizers/vq.py``).

distance -> nearest code (the hand-written kernel on CUDA, :mod:`...ops.vq_lookup`)
-> gather -> losses -> straight-through estimator. ``normalize_inputs``
L2-normalises the features and the codebook first (the spherical codebook of
the LlamaGen configs). The losses dict is the config's:
``{"vqgan": {"beta": 0.25}}`` or ``{"codebook": ..., "commitment": ...,
"entropy": ...}``. The codebook is the parameter ``codebook`` (K, D).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ...ops.distances import normalize, pairwise_distance
from ...ops.losses import codebook_loss, commitment_loss, entropy_loss, vqgan_quantizer_loss
from ...ops.ste import ste
from ...ops.vq_lookup import vq_quantize
from ...registries import QuantizerRegistry
from .base import QuantizerOutput

__all__ = ["VectorQuantizer"]


@QuantizerRegistry.register()
class VectorQuantizer(nn.Module):
    def __init__(
        self,
        codebook_size: int,
        embedding_dim: int,
        distance: str = "l2",
        losses: Mapping[str, Mapping[str, Any]] | None = None,
        normalize_inputs: bool = False,
        codebook_init: str = "uniform",
    ) -> None:
        super().__init__()
        if codebook_init not in ("uniform", "normal"):
            raise ValueError(f"unknown init {codebook_init!r}")
        self.codebook_size = codebook_size
        self.embedding_dim = embedding_dim
        self.distance = distance
        self.losses = dict(losses or {})
        self.normalize_inputs = normalize_inputs
        self.codebook_init = codebook_init
        self.codebook = nn.Parameter(torch.empty(codebook_size, embedding_dim))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        # 'uniform': uniform(-1/K, 1/K), as the JAX package initialises it
        with torch.no_grad():
            if self.codebook_init == "uniform":
                self.codebook.uniform_(-1.0 / self.codebook_size, 1.0 / self.codebook_size)
            else:
                self.codebook.normal_(0.0, 1.0)

    def effective_codebook(self) -> torch.Tensor:
        e = self.codebook
        return normalize(e) if self.normalize_inputs else e

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) features -> (N,) int32 codes."""
        if self.normalize_inputs:
            x = normalize(x)
        return vq_quantize(x, self.effective_codebook(), self.distance)[0]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(N,) codes -> (N, D) embeddings (differentiable gather)."""
        return torch.index_select(self.effective_codebook(), 0, codes.reshape(-1))

    def forward(self, x: torch.Tensor, train: bool = False) -> QuantizerOutput:
        if self.normalize_inputs:
            x = normalize(x)
        e = self.effective_codebook()
        codes, z = vq_quantize(x, e, self.distance)

        loss_vals: dict[str, torch.Tensor] = {}
        aux: dict[str, Any] = {"x": x}
        if "entropy" in self.losses or "distance" in (self.losses.get("_aux_", ()) or ()):
            aux["distance"] = pairwise_distance(x, e, self.distance)
        for name, cfg in self.losses.items():
            cfg = dict(cfg or {})
            if name == "vqgan":
                loss_vals["loss_vqgan"] = vqgan_quantizer_loss(z, x, **cfg)
            elif name == "codebook":
                loss_vals["loss_codebook"] = codebook_loss(z, x, **cfg)
            elif name == "commitment":
                loss_vals["loss_commitment"] = commitment_loss(z, x, **cfg)
            elif name == "entropy":
                loss_vals["loss_entropy"] = entropy_loss(aux["distance"], **cfg)
            elif name != "_aux_":
                raise ValueError(f"unknown quantizer loss {name!r}")
        total = sum(loss_vals.values(), torch.zeros((), dtype=torch.float32, device=x.device))
        return QuantizerOutput(z=ste(z, x), codes=codes, loss=total, losses=loss_vals, aux=aux)
