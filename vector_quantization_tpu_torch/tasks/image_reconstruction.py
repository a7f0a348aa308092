"""Image reconstruction: tokenization + pre-decode connector + decoder
(``vector_quantization_tpu/tasks/image_reconstruction.py``).

``decode`` takes quantized features (B, h, w, D) and ``decode_from_quant``
code grids (B, h, w); both return pixels (B, H, W, 3), NHWC as in the JAX
package. The decoder runs NCHW inside.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..registries import ConnectorRegistry, DecoderRegistry, ModelRegistry
from .image_tokenization import TokenizerModel, build_submodule, model_device, nchw, nhwc

__all__ = ["AutoencoderModel"]


@ModelRegistry.register()
class AutoencoderModel(TokenizerModel):
    """The full tokenize + reconstruct pipeline."""

    def __init__(
        self,
        encoder: nn.Module,
        quantizer: nn.Module,
        post_encode: nn.Module | None = None,
        decoder: nn.Module | None = None,
        pre_decode: nn.Module | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        device = model_device(device)
        super().__init__(encoder, quantizer, post_encode, device)
        self.decoder = decoder
        self.pre_decode = pre_decode
        self.to(device)

    @classmethod
    def build_pre_hook(cls, config, registry):
        config = super().build_pre_hook(config, registry)
        config["decoder"] = build_submodule(DecoderRegistry, config["decoder"])
        pd = config.get("pre_decode")
        if isinstance(pd, Mapping):
            pd = dict(pd)
            pd.setdefault("in_channels", config["quantizer"].embedding_dim)
            if hasattr(config["decoder"], "in_channels"):
                pd.setdefault("out_channels", config["decoder"].in_channels)
            config["pre_decode"] = build_submodule(ConnectorRegistry, pd)
        return config

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, D) quantized features -> reconstruction (B, H, W, C)."""
        z = nchw(z)
        if self.pre_decode is not None:
            z = self.pre_decode(z)
        return nhwc(self.decoder(z))

    def decode_from_quant(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, h, w) code ids -> reconstruction (B, H, W, C)."""
        b, h, w = codes.shape
        return self.decode(self.quantizer.decode(codes.reshape(-1)).reshape(b, h, w, -1))

    def forward(self, x: torch.Tensor, train: bool = False) -> dict[str, Any]:
        feat = self.encode(x)
        qout = self.quantize(feat, train=train)
        return {"feat": feat, "quantizer": qout, "pred": self.decode(qout.z), "loss": qout.loss}
