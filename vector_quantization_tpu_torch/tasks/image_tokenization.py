"""Image tokenization: encode -> connect -> quantize
(``vector_quantization_tpu/tasks/image_tokenization.py``).

The public functions keep the JAX package's NHWC layout: ``encode`` and
``encode_to_quant`` take pixels (B, H, W, 3); features are (B, h, w, D) and
codes (B, h, w) int32. The encoder and connectors run NCHW inside.
``build_pre_hook`` builds the children from their configs and infers the
connector's widths. The model moves itself to ``device``: ``None`` means
CUDA, and without a GPU that raises; pass ``device="cpu"`` (as a config
key or ``Registry.build(..., device="cpu")``) to run the kernels' plain
versions on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..models.quantizers.base import QuantizerOutput
from ..registries import ConnectorRegistry, EncoderRegistry, ModelRegistry, QuantizerRegistry

__all__ = ["TokenizerModel", "build_submodule", "model_device", "nchw", "nhwc"]


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def model_device(device: torch.device | str | None) -> torch.device:
    """``None`` -> CUDA, which must be available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the tokenizer runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def build_submodule(registry, cfg, **extra):
    if cfg is None or isinstance(cfg, nn.Module):
        return cfg
    return registry.build(cfg, **extra)


@ModelRegistry.register()
class TokenizerModel(nn.Module):
    """Encoder + post-encode connector + quantizer."""

    def __init__(
        self,
        encoder: nn.Module,
        quantizer: nn.Module,
        post_encode: nn.Module | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self.encoder = encoder
        self.quantizer = quantizer
        self.post_encode = post_encode
        self.to(model_device(device))

    @classmethod
    def build_pre_hook(cls, config, registry):
        config["encoder"] = build_submodule(EncoderRegistry, config["encoder"])
        config["quantizer"] = build_submodule(QuantizerRegistry, config["quantizer"])
        pe = config.get("post_encode")
        if isinstance(pe, Mapping):
            pe = dict(pe)
            pe.setdefault("in_channels", config["encoder"].out_channels)
            pe.setdefault("out_channels", config["quantizer"].embedding_dim)
            config["post_encode"] = build_submodule(ConnectorRegistry, pe)
        return config

    def _encode_nchw(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.encoder(nchw(x))
        if self.post_encode is not None:
            feat = self.post_encode(feat)
        return feat

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> features (B, h, w, D)."""
        return nhwc(self._encode_nchw(x))

    def quantize(self, feat: torch.Tensor, train: bool = False) -> QuantizerOutput:
        """(B, h, w, D) -> QuantizerOutput with z (B, h, w, D), codes (B, h, w)."""
        b, h, w, d = feat.shape
        out = self.quantizer(feat.reshape(b * h * w, d), train=train)
        return out.replace(z=out.z.reshape(b, h, w, -1), codes=out.codes.reshape(b, h, w))

    def encode_to_quant(self, x: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> code grid (B, h, w) int32."""
        feat = self.encode(x)
        b, h, w, d = feat.shape
        return self.quantizer.encode(feat.reshape(b * h * w, d)).reshape(b, h, w)

    def forward(self, x: torch.Tensor, train: bool = False) -> dict[str, Any]:
        feat = self.encode(x)
        qout = self.quantize(feat, train=train)
        return {"feat": feat, "quantizer": qout, "loss": qout.loss}
