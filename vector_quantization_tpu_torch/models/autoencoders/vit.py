"""BEiT-style ViT encoder and decoder, VQ-KD's two halves (port of
``vector_quantization_tpu/models/autoencoders/vit.py``).

- Pre-LN blocks: LayerNorm (eps 1e-6), attention with a learnable q and v
  bias and a key bias fixed at zero (``qkv_kernel`` (D, 3D) in flax's
  layout, ``q_bias``, ``v_bias``), exact (erf) GELU MLP.
- Patch conv, cls token, a learnable position embedding of a static size
  (a sequence of another length raises).
- ``fc_norm`` on the patch tokens (cls dropped), then ``task1`` -> tanh ->
  ``task2``, unpatchified to ``out_patch_size``.
- ``ViTEncoder``: 224 px / 16 -> (B, 32, 14, 14); ``ViTDecoder``: the 14 x
  14 code grid (patch 1) -> teacher-width features. The decoder's
  ``last_parameter`` is ``task2``'s kernel.

The port's encoders and decoders take and return NCHW maps; the tokens run
(B, N, D). Attention is ``F.scaled_dot_product_attention`` (the JAX
package's is an einsum + softmax; no Pallas kernel). Children keep the
flax names (``patch_embed``, ``block{i}``, ``fc_norm``, ``task1``,
``task2``), so :mod:`...utils.bridge` maps the params. Random init as
flax's: truncated normal (0.02) kernels, zero biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registries import DecoderRegistry, EncoderRegistry

__all__ = ["ViTEncoder", "ViTDecoder", "trunc_normal_"]


def trunc_normal_(t: torch.Tensor, std: float = 0.02) -> torch.Tensor:
    """flax's ``truncated_normal(std)``: N(0, std²) cut at ±2 std."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def dense(d_in: int, d_out: int) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    trunc_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class _QVBiasAttention(nn.Module):
    """Attention with learnable q and v biases and a zero k bias (BEiT)."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv_kernel = nn.Parameter(trunc_normal_(torch.empty(dim, 3 * dim)))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = torch.addmm(bias, x.reshape(b * n, d), self.qkv_kernel)
        q, k, v = qkv.view(b, n, 3, self.num_heads, d // self.num_heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _QVBiasAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = dense(dim, int(dim * mlp_ratio))
        self.fc2 = dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class _ViTBackbone(nn.Module):
    def __init__(
        self,
        img_size: int,
        patch_size: int,
        in_chans: int,
        out_chans: int,
        out_patch_size: int = 1,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
    ) -> None:
        super().__init__()
        self.patch_size, self.out_chans, self.out_patch_size = patch_size, out_chans, out_patch_size
        n = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, embed_dim)))
        self.pos_embed = nn.Parameter(trunc_normal_(torch.empty(1, n + 1, embed_dim)))
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        fan_in = in_chans * patch_size**2  # flax Conv's lecun_normal
        trunc_normal_(self.patch_embed.weight, std=(1.0 / fan_in) ** 0.5 / 0.87962566103423978)
        nn.init.zeros_(self.patch_embed.bias)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", _Block(embed_dim, num_heads, mlp_ratio))
        self.fc_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.task1 = dense(embed_dim, embed_dim)
        self.task2 = dense(embed_dim, out_chans * out_patch_size**2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, out_chans, h·p, w·p) (p = out_patch_size)."""
        b = x.shape[0]
        x = self.patch_embed(x)
        h, w = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"pos_embed size {self.pos_embed.shape[1]} != sequence {x.shape[1]}; "
                             "convert weights with interpolation instead")
        x = x + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.task2(torch.tanh(self.task1(self.fc_norm(x[:, 1:]))))
        p, c = self.out_patch_size, self.out_chans
        x = x.reshape(b, h, w, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, h * p, w * p)


@EncoderRegistry.register()
class ViTEncoder(nn.Module):
    """VQ-KD's encoder: 224 px / 16 ViT-B -> (B, 32, 14, 14)."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        out_channels: int = 32,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        self.patch_size, self.out_channels = patch_size, out_channels
        self.backbone = _ViTBackbone(img_size, patch_size, in_channels, out_channels,
                                     embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                                     mlp_ratio=mlp_ratio)

    @property
    def downsample_factor(self) -> int:
        return self.patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)


@DecoderRegistry.register()
class ViTDecoder(nn.Module):
    """VQ-KD's decoder: the 14 x 14 code grid (patch 1) -> teacher-width
    features."""

    def __init__(
        self,
        img_size: int = 14,
        patch_size: int = 1,
        in_channels: int = 32,
        out_channels: int = 512,
        out_patch_size: int = 1,
        embed_dim: int = 768,
        depth: int = 3,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
    ) -> None:
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.backbone = _ViTBackbone(img_size, patch_size, in_channels, out_channels, out_patch_size,
                                     embed_dim, depth, num_heads, mlp_ratio)

    @staticmethod
    def last_parameter_name() -> str:
        """``task2``'s weight (the JAX decoder's ``last_parameter_path()``)."""
        return "backbone.task2.weight"

    def last_parameter(self) -> nn.Parameter:
        return self.get_parameter(self.last_parameter_name())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)
