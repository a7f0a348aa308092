"""ViT-family teachers: ``ViTTeacher``, ``CLIPTeacher``, ``DINOTeacher``,
``MAETeacher`` (port of ``vector_quantization_tpu/models/teachers/vit.py``).

One pre-LN ViT trunk, configured per family: the activation (exact GELU;
CLIP's quick-GELU ``x·sigmoid(1.702x)``), CLIP's ``ln_pre`` (and then a
patch conv without bias), ``ln_post``, an optional projection, and the
LayerNorm epsilon (1e-6; CLIP's 1e-5). The attention is flax's
``MultiHeadDotProductAttention``, its parameters kept in flax's layouts
(``query``/``key``/``value`` kernels (D, H, Dh) and biases (H, Dh),
``out`` (H, Dh, D)) and computed with ``F.scaled_dot_product_attention``.
Children keep the flax names (``patch_embed``, ``block{i}_norm1``,
``block{i}_attn``, ``ln_pre``, ``ln_post``, ``proj``; the trunk is
``backbone``), so :mod:`...utils.bridge` maps the params.

Unlike flax, the position embedding's size is fixed when the module is
built: ``img_size`` (224 by default, the shipped configs' size) sets it,
or ``image_size`` where the teacher resizes its input.
No pretrained weights are in the repository: a teacher is held to the JAX
package at random init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registries import TeacherRegistry
from ..autoencoders.vit import trunc_normal_
from .base import BaseTeacher

__all__ = ["ViTTeacher", "CLIPTeacher", "DINOTeacher", "MAETeacher"]


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _lecun_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal``."""
    return trunc_normal_(t, std=(1.0 / fan_in) ** 0.5 / 0.87962566103423978)


class _DenseGeneral(nn.Module):
    """A flax ``DenseGeneral``'s ``kernel`` and ``bias``, in its shapes."""

    def __init__(self, kernel_shape: tuple[int, ...], bias_shape: tuple[int, ...], fan_in: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(_lecun_(torch.empty(kernel_shape), fan_in))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention with flax's parameters: q, k, v projections with
    biases, ``softmax(q kᵀ / sqrt(Dh)) v``, the output projection."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads, dh = num_heads, dim // num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, _DenseGeneral((dim, num_heads, dh), (num_heads, dh), dim))
        self.out = _DenseGeneral((num_heads, dh, dim), (dim,), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape

        def heads(p: _DenseGeneral) -> torch.Tensor:
            y = F.linear(x, p.kernel.reshape(d, d).t(), p.bias.reshape(d))
            return y.view(b, n, self.num_heads, d // self.num_heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(self.query), heads(self.key), heads(self.value))
        return F.linear(o.transpose(1, 2).reshape(b, n, d), self.out.kernel.reshape(d, d).t(), self.out.bias)


def _dense(d_in: int, d_out: int) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    _lecun_(layer.weight, d_in)
    nn.init.zeros_(layer.bias)
    return layer


class _TeacherViT(nn.Module):
    """The pre-LN ViT trunk: (B, H, W, 3) -> patch tokens (B, h, w, C)."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int, num_heads: int,
                 act: str = "gelu", pre_norm: bool = False, final_norm: bool = True,
                 proj_dim: int | None = None, ln_eps: float = 1e-6) -> None:
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = _quick_gelu if act == "quick_gelu" else F.gelu
        self.depth, self.pre_norm, self.final_norm = depth, pre_norm, final_norm
        n = (img_size // patch_size) ** 2
        # CLIP's patch conv has no bias
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, bias=not pre_norm)
        _lecun_(self.patch_embed.weight, 3 * patch_size**2)
        if self.patch_embed.bias is not None:
            nn.init.zeros_(self.patch_embed.bias)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)
        self.pos_embed = nn.Parameter(torch.randn(1, n + 1, embed_dim) * 0.02)
        self.ln_pre = nn.LayerNorm(embed_dim, eps=ln_eps) if pre_norm else None
        for i in range(depth):
            self.add_module(f"block{i}_norm1", nn.LayerNorm(embed_dim, eps=ln_eps))
            self.add_module(f"block{i}_attn", MultiHeadDotProductAttention(embed_dim, num_heads))
            self.add_module(f"block{i}_norm2", nn.LayerNorm(embed_dim, eps=ln_eps))
            self.add_module(f"block{i}_fc1", _dense(embed_dim, 4 * embed_dim))
            self.add_module(f"block{i}_fc2", _dense(4 * embed_dim, embed_dim))
        self.ln_post = nn.LayerNorm(embed_dim, eps=ln_eps) if final_norm else None
        self.proj = None if proj_dim is None else nn.Parameter(torch.randn(embed_dim, proj_dim) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        h, w = x.shape[2:]
        x = torch.cat([self.cls_token.expand(b, -1, -1), x.flatten(2).transpose(1, 2)], dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"pos_embed size {self.pos_embed.shape[1]} != sequence {x.shape[1]}: "
                             "build the teacher with the image's img_size")
        x = x + self.pos_embed
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for i in range(self.depth):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            x = x + blk("attn")(blk("norm1")(x))
            x = x + blk("fc2")(self.act(blk("fc1")(blk("norm2")(x))))
        if self.ln_post is not None:
            x = self.ln_post(x)
        tokens = x[:, 1:]
        if self.proj is not None:
            tokens = tokens @ self.proj
        return tokens.reshape(b, h, w, -1)


@TeacherRegistry.register()
class ViTTeacher(BaseTeacher):
    """A frozen ViT feature teacher (torchvision ViT-B/16 defaults)."""

    defaults = dict(normalization="imagenet", act="gelu", pre_norm=False, final_norm=True,
                    proj_dim=None, ln_eps=1e-6)

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, img_size: int = 224, **kwargs) -> None:
        opts = {**self.defaults, **kwargs}
        super().__init__(opts.pop("normalization"), opts.pop("image_size", None),
                         opts.pop("output_size", None))
        self.patch_size = patch_size
        self._out_channels = opts["proj_dim"] or embed_dim
        # the backbone sees the resized input where ``image_size`` is set
        self.backbone = _TeacherViT(self.image_size or img_size, patch_size, embed_dim, depth, num_heads,
                                    **opts)

    @property
    def out_channels(self) -> int:
        return self._out_channels

    @property
    def downsample_factor(self) -> int:
        return self.patch_size

    def backbone_forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.backbone(image)


@TeacherRegistry.register()
class CLIPTeacher(ViTTeacher):
    """CLIP ViT-B/16's visual tower: quick-GELU, ``ln_pre``, LayerNorm eps
    1e-5, a projection to the joint space (``proj_dim`` 512; None: without)."""

    defaults = dict(normalization="clip", act="quick_gelu", pre_norm=True, final_norm=True,
                    proj_dim=512, ln_eps=1e-5)


@TeacherRegistry.register()
class DINOTeacher(ViTTeacher):
    """DINO ViT-B/16."""


@TeacherRegistry.register()
class MAETeacher(ViTTeacher):
    """MAE ViT-B/16's encoder."""
