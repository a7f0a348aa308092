"""GPT-2-style AR decoder (port of
``vector_quantization_tpu/models/transformers/gpt2.py``).

Learned position embeddings ``wpe``; pre-LN blocks (LayerNorm eps 1e-5 ->
a fused ``c_attn`` with bias -> attention -> ``c_proj``; LayerNorm ->
``mlp_fc`` -> GELU, flax's default tanh approximation -> ``mlp_proj``); a
final ``ln_f``; the head tied to the token embedding ``wte`` and computed in
f32 (``x.float() @ wte.T``).

The attention is the reference's einsum form with an additive -1e9 mask
(not ``-inf``, not a causal SDPA): f32 scores, an f32 softmax, the
probabilities cast to ``dtype`` before the product with v; masked and
not-yet-written cache columns weigh exactly 0. The decode interface is
the port's Llama one (``models/transformers/llama.py``): ``forward(tokens)``
is the cache-free training forward (logits (B, T, V) f32);
``forward(tokens, cache)`` decodes over the dense :class:`KVCache` at the
scalar offset ``cache.length`` (f32/bf16 or INT8 KV, whose per-(position,
head) scales multiply the scores and the probabilities);
``forward(tokens (B, 1), cache, slot_positions=(B,))`` writes and reads at
each row's own column. ``init_cache(batch, dtype, device, rows)`` makes
the dense cache. So ``tasks/sequence_modeling.generate`` and the dense
``ARServer`` take it unchanged. The learned positions are absolute, so
``ARServer`` serves it through the per-row scatter, not the shared-column
engine; there is no paged cache path, as in the JAX package.

The JAX GPT-2 reaches no Pallas kernel (its attention is einsum, not the
flash attention of Llama's training path), so the port adds no flash path
either. Its f32 products (``_Dense`` and the head) go through
``ops/f32_gemm.py``: at training's many rows a hand-written Hopper kernel
on the tensor cores at f32 accuracy, elsewhere ``torch.matmul``.
``supports_fused_ce`` is false: ``ARAlgorithm`` trains it through the
dense head and ``next_token_ce``.

Parameter names and layouts follow the flax module (``h{i}.ln_1.scale``,
``h{i}.c_attn.kernel`` (in, out), ``wte``, ``wpe``, ...), so
``utils/bridge.py`` maps a flax param tree one to one.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.f32_gemm import dense, tied_head
from ...registries import TransformerRegistry
from .llama import _NEG_MASK, KVCache, _dense_cache_attention, _einsum_attention, make_dense_cache, resolve_dtype

__all__ = ["GPT2Transformer"]


class _LayerNorm(nn.Module):
    """flax ``LayerNorm``: statistics in f32, ``scale``/``bias`` params,
    the output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, self.eps)
        return y.to(self.dtype)


class _Dense(nn.Module):
    """flax ``Dense`` with bias: ``kernel`` (in, out) and ``bias`` f32,
    the product in ``dtype``."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.to(self.dtype), self.kernel.to(self.dtype), self.bias.to(self.dtype))


class _GPT2Block(nn.Module):
    def __init__(self, d: int, num_heads: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.ln_1 = _LayerNorm(d, dtype)
        self.c_attn = _Dense(d, 3 * d, dtype)
        self.c_proj = _Dense(d, d, dtype)
        self.ln_2 = _LayerNorm(d, dtype)
        self.mlp_fc = _Dense(d, 4 * d, dtype)
        self.mlp_proj = _Dense(4 * d, d, dtype)

    def forward(self, x, mask=None, layer=None, offset=None):
        """``layer``: this layer's dense cache ((k, v) or with the INT8
        scales), written in place at ``offset`` (a host int or (B,)
        positions); None: the cache-free causal forward."""
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = (a.reshape(b, t, h, d // h) for a in self.c_attn(self.ln_1(x)).split(d, dim=-1))
        if layer is None:
            attn = _einsum_attention(q, k, v, self.dtype, mask)
        else:
            attn = _dense_cache_attention(q, k, v, layer, offset, mask, self.dtype)
        x = x + self.c_proj(attn.reshape(b, t, d))
        y = self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)), approximate="tanh"))
        return x + y


@TransformerRegistry.register()
class GPT2Transformer(nn.Module):
    """GPT-2 (small = 12L/12H/768d, the defaults; the configs' medium is
    24L/16H/1024d). Weights start as the reference initialises them
    (N(0, 0.02) kernels and embeddings, zero biases, unit LayerNorm scales)
    from ``seed``."""

    supports_fused_ce = False

    def __init__(
        self,
        vocabulary_size: int,
        hidden_size: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        max_length: int = 1024,
        dtype: Any = torch.float32,
        seed: int = 0,
    ) -> None:
        super().__init__()
        self.vocabulary_size = vocabulary_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.dtype = resolve_dtype(dtype)
        self.wte = nn.Parameter(torch.zeros(vocabulary_size, hidden_size))
        self.wpe = nn.Parameter(torch.zeros(max_length, hidden_size))
        for i in range(num_layers):
            self.add_module(f"h{i}", _GPT2Block(hidden_size, num_heads, self.dtype))
        self.ln_f = _LayerNorm(hidden_size, self.dtype)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name in ("wte", "wpe") or name.endswith(".kernel"):
                    p.normal_(0.0, 0.02, generator=gen)

    def blocks(self) -> list[_GPT2Block]:
        return [getattr(self, f"h{i}") for i in range(self.num_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        cache: KVCache | None = None,
        slot_positions: torch.Tensor | None = None,
    ):
        b, t = tokens.shape
        if slot_positions is not None:
            if cache is None or t != 1:
                raise ValueError("slot_positions requires a cache and single-token decode")
            pos = self.wpe[slot_positions.long()][:, None]
            offset = slot_positions
            col = torch.arange(cache.window, device=tokens.device)
            mask = torch.where(col <= slot_positions[:, None, None, None], 0.0, _NEG_MASK)
        else:
            offset = 0 if cache is None else cache.length
            if offset + t > self.max_length:
                raise ValueError(f"positions [{offset}, {offset + t}) exceed max_length {self.max_length}")
            pos = self.wpe[offset:offset + t][None]
            if cache is None:
                mask = None  # the causal T x T mask
            else:
                col = torch.arange(cache.window, device=tokens.device)
                row = torch.arange(t, device=tokens.device) + offset
                mask = torch.where(col[None, :] <= row[:, None], 0.0, _NEG_MASK)[None, None]
        x = (self.wte[tokens.long()] + pos).to(self.dtype)
        int8_cache = cache is not None and cache.k_scale is not None
        for i, block in enumerate(self.blocks()):
            layer = None
            if cache is not None:
                layer = (cache.k[i], cache.v[i])
                if int8_cache:
                    layer += (cache.k_scale[i], cache.v_scale[i])
            x = block(x, mask, layer, offset)
        logits = tied_head(self.ln_f(x).float(), self.wte)  # the tied head, f32
        if cache is None:
            return logits
        return logits, cache._replace(length=cache.length + t)

    def init_cache(
        self,
        batch: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
        rows: int | None = None,
    ) -> KVCache:
        """A zeroed dense cache of ``rows`` (default ``max_length``) columns
        per row on ``device`` (default: the embedding's)."""
        return make_dense_cache(
            self.num_layers, batch, self.max_length if rows is None else rows, self.num_heads,
            self.hidden_size // self.num_heads, dtype, self.wte.device if device is None else device,
        )

