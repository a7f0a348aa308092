"""Llama-style AR decoder: the training forward and the paged decode path.

Port of ``vector_quantization_tpu/models/transformers/llama.py``: RMSNorm,
rotate-half RoPE, SwiGLU FFN, no biases; float or INT8 weight-only
projections (``Int8Dense``), optional fused qkv / gate+up projections,
INT8 lm head.

- The cache-free training forward: causal attention over the whole
  sequence, either the einsum attention (f32 scores of the operands as
  given, softmax in f32, probabilities cast to ``dtype`` before the product
  with v) or, with ``flash=True`` and T > 1, the flash attention kernels
  (``ops/flash_attention.py``); per-block rematerialisation with
  ``torch.utils.checkpoint`` (``remat=True``); logits from the f32 (or
  ``head_dtype``) head, or with ``fused_ce_targets`` the scalar
  teacher-forced CE of the logits-free head (``ops/fused_ce.py``).
- Single-token decode with per-row ``slot_positions`` over a paged KV pool
  (``ops/paged_kv.py``) read by the paged decode attention kernel
  (``ops/paged_attention.py``).

Parameter names and layouts follow the flax module: projection weights are
``(in, out)`` (``kernel`` or ``w_int8`` + ``scale``), the embedding and
norms are f32, so ``utils/bridge.py`` maps a flax param tree one to one.
The dense KV cache, the shared-column decode, the INT8 cache-free forward
and ``remat_policy="dots"`` are later slices: calls that need them raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import flash_attention
from ...ops.fused_ce import fused_next_token_ce
from ...ops.int8_matmul import int8_matmul
from ...ops.paged_attention import paged_decode_attention
from ...ops.paged_kv import PagedKVCache, init_paged_cache, paged_update
from ...registries import TransformerRegistry

__all__ = [
    "LlamaTransformer",
    "LlamaBlock",
    "Int8Dense",
    "Dense",
    "RMSNorm",
    "quantize_params_int8",
    "fuse_llama_params",
    "resolve_dtype",
]

_REMAT_DOTS = "ROADMAP.md queue A: remat_policy='dots' (selective checkpointing)"
_DENSE_SLICE = "ROADMAP.md queue A: the dense shared-column engine and generate()"
_W8A8_SLICE = "ROADMAP.md queue A: int8_matmul_w8a8"
_NEG_MASK = -1e9  # the reference's additive causal mask

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Any) -> torch.dtype | None:
    """A torch dtype from a torch dtype, a name ("bfloat16"), or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


class Int8Dense(nn.Module):
    """Weight-only INT8 linear (no bias): an int8 ``(in, out)`` weight and a
    per-output f32 scale; ``int8_matmul`` dequantises inside the product.
    Returns the input's dtype, as the flax module does."""

    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.register_buffer("w_int8", torch.zeros(in_features, features, dtype=torch.int8))
        self.register_buffer("scale", torch.full((features,), 0.01, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.w_int8, self.scale).to(x.dtype)


class Dense(nn.Module):
    """Float linear (no bias) with an ``(in, out)`` f32 kernel, computed in
    ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, T, H, Dh), positions: (B, T). Frequencies
    ``theta**(-i/(Dh/2))`` in f32; the result is cast back to x's dtype."""
    dh = x.shape[-1]
    i = torch.arange(0, dh // 2, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), -i / (dh // 2))
    angles = positions[..., None].float() * freqs  # (B, T, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (B, T, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _flash_train_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Training-path causal attention through the flash attention kernels
    (q/k/v (B, T, H, Dh) post-RoPE, cast to ``dtype``). The kernels read
    the (B, T, H, Dh) layout and mask a ragged T themselves: no padding to a
    tile multiple and no transposes, unlike the TPU library call."""
    return flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype):
    """The reference's einsum attention: f32 scores of the operands as
    given (exact products of bf16 values, f32 sums), divided by sqrt(Dh),
    the additive causal mask, an f32 softmax, probabilities cast to
    ``dtype`` before the product with v."""
    t, dh = q.shape[1], q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / float(np.sqrt(dh))
    i = torch.arange(t, device=q.device)
    mask = torch.where(i[None, :] <= i[:, None], 0.0, _NEG_MASK)
    probs = torch.softmax(scores + mask, dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class LlamaBlock(nn.Module):
    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        ffn_dim: int,
        dtype: torch.dtype,
        quantize: bool,
        fused_qkv: bool,
        flash: bool = False,
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.ffn_dim = ffn_dim
        self.dtype = dtype
        self.fused_qkv = fused_qkv
        d = hidden_size

        def dense(fin, fout):
            return Int8Dense(fin, fout) if quantize else Dense(fin, fout, dtype)

        self.input_norm = RMSNorm(d, dtype)
        if fused_qkv:
            self.qkv_proj = dense(d, 3 * d)
        else:
            self.q_proj = dense(d, d)
            self.k_proj = dense(d, d)
            self.v_proj = dense(d, d)
        self.o_proj = dense(d, d)
        self.post_norm = RMSNorm(d, dtype)
        if fused_qkv:
            self.gateup_proj = dense(d, 2 * ffn_dim)
        else:
            self.gate_proj = dense(d, ffn_dim)
            self.up_proj = dense(d, ffn_dim)
        self.down_proj = dense(ffn_dim, d)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """input norm, q/k/v projections, RoPE: three (B, T, H, Dh)."""
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        y = self.input_norm(x)
        if self.fused_qkv:
            q, k, v = self.qkv_proj(y).split(d, dim=-1)  # q|k|v
        else:
            q, k, v = self.q_proj(y), self.k_proj(y), self.v_proj(y)
        q = _rope(q.reshape(b, t, h, dh), positions)
        k = _rope(k.reshape(b, t, h, dh), positions)
        return q, k, v.reshape(b, t, h, dh)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        cache: PagedKVCache | None = None,
        layer_idx: int = 0,
        offset: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Without a cache: the training block, x (B, T, D), positions
        (B, T), causal attention over the sequence. With a paged cache:
        x (B, 1, D), positions (B, 1); writes this token's k/v into the
        pool at (layer_idx, offset) in place, then attends over the pool."""
        b, t, d = x.shape
        q, k, v = self._qkv(x, positions)
        if cache is None:
            if self.flash and t > 1:
                attn = _flash_train_attention(q, k, v, self.dtype)
            else:
                attn = _einsum_attention(q, k, v, self.dtype)
            x = x + self.o_proj(attn.reshape(b, t, d))
            return self._ffn(x)
        paged_update(cache, layer_idx, offset, k[:, 0], v[:, 0])
        attn = paged_decode_attention(
            q[:, 0],
            cache.k,
            cache.v,
            cache.page_table,
            offset + 1,
            layer_idx,
            k_scale_pool=cache.k_scale,
            v_scale_pool=cache.v_scale,
        )
        attn = attn.to(self.dtype).reshape(b, 1, d)
        x = x + self.o_proj(attn)
        return self._ffn(x)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        y = self.post_norm(x)
        if self.fused_qkv:
            gate, up = self.gateup_proj(y).split(self.ffn_dim, dim=-1)  # gate|up
        else:
            gate, up = self.gate_proj(y), self.up_proj(y)
        return x + self.down_proj(nn.functional.silu(gate) * up)


@TransformerRegistry.register()
class LlamaTransformer(nn.Module):
    """Llama decoder (medium = 24L/16H/1024d/2816ffn, the defaults).

    ``forward(tokens (B, T))`` is the training forward: logits (B, T, V)
    float32, or with ``fused_ce_targets`` (B, T) the scalar teacher-forced
    CE (position t predicts targets[:, t+1]) without the logits.
    ``forward(tokens (B, 1), cache=PagedKVCache, slot_positions=(B,))``
    returns ``(logits (B, 1, V) float32, cache)``; the pool is updated in
    place. The INT8 lm head (``quantize=True``) returns f32 logits; the
    float head computes in ``head_dtype`` (None = f32) with f32 sums.

    ``quantize_mode`` "auto", "pallas" and "xla" name the JAX package's
    backends for one function; here all three run ``int8_matmul`` (the
    CUDA kernel on the card). "w8a8" is not ported and raises.

    Weights start as the reference initialises them (N(0, 0.02)
    projections and embedding, zero lm head) from ``seed``; serving loads
    converted weights over them (``utils/bridge.py``).
    """

    # the fused_ce_targets loss is wired into forward (ARAlgorithm checks)
    supports_fused_ce = True

    def __init__(
        self,
        vocabulary_size: int,
        hidden_size: int = 1024,
        num_layers: int = 24,
        num_heads: int = 16,
        ffn_dim: int = 2816,
        max_length: int = 1024,
        dtype: Any = torch.float32,
        quantize: bool = False,
        quantize_mode: str = "auto",
        fused_qkv: bool = False,
        paged_kernel: bool | None = None,
        remat: bool = False,
        remat_policy: str | None = None,
        flash: bool = False,
        head_dtype: Any = None,
        fused_ce_chunk: int = 2048,
        seed: int = 0,
    ) -> None:
        super().__init__()
        if quantize_mode == "w8a8":
            raise NotImplementedError(f"quantize_mode='w8a8': {_W8A8_SLICE}")
        if quantize_mode not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown quantize_mode {quantize_mode!r}")
        if paged_kernel is False:
            # the gather path is the kernel's plain version: the port runs
            # it on CPU tensors only, never as a choice on the card
            raise NotImplementedError(
                "paged_kernel=False (gather attention on the card): the port "
                "always uses the paged decode attention kernel on CUDA"
            )
        if remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.vocabulary_size = vocabulary_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_dim = ffn_dim
        self.max_length = max_length
        self.dtype = resolve_dtype(dtype)
        self.quantize = quantize
        self.quantize_mode = quantize_mode
        self.fused_qkv = fused_qkv
        self.paged_kernel = paged_kernel
        self.remat = remat
        self.remat_policy = remat_policy
        self.flash = flash
        self.head_dtype = resolve_dtype(head_dtype)
        self.fused_ce_chunk = fused_ce_chunk

        self.embedding = nn.Parameter(torch.zeros(vocabulary_size, hidden_size))
        for i in range(num_layers):
            self.add_module(
                f"layer{i}",
                LlamaBlock(hidden_size, num_heads, ffn_dim, self.dtype, quantize, fused_qkv, flash),
            )
        self.final_norm = RMSNorm(hidden_size, self.dtype)
        if quantize:
            self.register_buffer(
                "lm_head_int8", torch.zeros(hidden_size, vocabulary_size, dtype=torch.int8)
            )
            self.register_buffer("lm_head_scale", torch.zeros(vocabulary_size))
        else:
            self.lm_head = nn.Parameter(torch.zeros(hidden_size, vocabulary_size))
        self._init_weights(seed)

    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=gen)
            for name, p in [*self.named_parameters(), *self.named_buffers()]:
                if name.endswith(".kernel"):
                    p.normal_(0.0, 0.02, generator=gen)
                elif name.endswith(".w_int8"):
                    p.copy_(torch.randint(-127, 128, p.shape, generator=gen))

    def blocks(self) -> list[LlamaBlock]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        cache: PagedKVCache | None = None,
        slot_positions: torch.Tensor | None = None,
        row_starts: torch.Tensor | None = None,
        fused_ce_targets: torch.Tensor | None = None,
    ):
        if cache is None:
            if slot_positions is not None or row_starts is not None:
                raise ValueError("slot_positions and row_starts need a cache")
            return self._train_forward(tokens, fused_ce_targets)
        if fused_ce_targets is not None:
            raise ValueError("fused_ce_targets is a training-path loss (no cache)")
        if not isinstance(cache, PagedKVCache):
            raise NotImplementedError(f"the dense KV cache: {_DENSE_SLICE}")
        if row_starts is not None:
            raise NotImplementedError(f"row_starts (shared-column decode): {_DENSE_SLICE}")
        if slot_positions is None:
            raise ValueError("a paged cache requires slot_positions decode")
        b, t = tokens.shape
        if t != 1:
            raise ValueError("slot_positions requires single-token decode")
        x = self.embedding[tokens].to(self.dtype)
        positions = slot_positions[:, None]
        for i, block in enumerate(self.blocks()):
            x = block(x, positions, cache, i, slot_positions)
        x = self.final_norm(x)
        if self.quantize:
            xh = x.reshape(b * t, self.hidden_size).to(self.dtype)
            logits = int8_matmul(xh, self.lm_head_int8, self.lm_head_scale)
            logits = logits.reshape(b, t, self.vocabulary_size)
        else:
            hd = self.head_dtype or torch.float32
            logits = torch.matmul(x.to(hd).float(), self.lm_head.to(hd).float())
        return logits, cache

    def _train_forward(
        self, tokens: torch.Tensor, fused_ce_targets: torch.Tensor | None
    ) -> torch.Tensor:
        if self.quantize:
            raise NotImplementedError(f"the INT8 cache-free (prefill) forward: {_DENSE_SLICE}")
        b, t = tokens.shape
        x = self.embedding[tokens.long()].to(self.dtype)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        remat = self.remat and torch.is_grad_enabled()
        if remat and self.remat_policy == "dots":
            raise NotImplementedError(_REMAT_DOTS)
        for block in self.blocks():
            if remat:
                # full per-block remat: only block inputs are kept; the
                # backward re-runs the block (and its attention kernel)
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        if fused_ce_targets is not None:
            # the chunk is clamped to the vocabulary's 128-multiple, as in
            # the reference (a tiny vocabulary gets one narrow chunk)
            chunk = min(self.fused_ce_chunk, -(-self.vocabulary_size // 128) * 128)
            return fused_next_token_ce(x, self.lm_head, fused_ce_targets, chunk)
        hd = self.head_dtype or torch.float32
        return torch.matmul(x.to(hd).float(), self.lm_head.to(hd).float())

    def init_paged_cache(
        self,
        batch: int,
        num_pages: int,
        page_size: int,
        pages_per_slot: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
    ) -> PagedKVCache:
        if device is None:
            device = self.embedding.device
        return init_paged_cache(
            self.num_layers,
            num_pages,
            page_size,
            batch,
            pages_per_slot,
            self.num_heads,
            self.hidden_size // self.num_heads,
            dtype,
            device,
        )


def quantize_params_int8(params: dict) -> dict:
    """Float Llama params (nested dict, flax layout, numpy arrays) ->
    Int8Dense layout: per-output-channel symmetric max-abs int8 for every
    ``*_proj`` kernel and the lm head; embeddings and norms stay f32."""

    def quant(w):
        w = np.asarray(w, np.float32)
        scale = np.maximum(np.abs(w).max(axis=0) / 127.0, 1e-8)
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        return q, scale.astype(np.float32)

    def convert(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                if set(v) == {"kernel"} and k.endswith("_proj"):
                    q, scale = quant(v["kernel"])
                    out[k] = {"w_int8": q, "scale": scale}
                else:
                    out[k] = convert(v)
            elif k == "lm_head":
                out["lm_head_int8"], out["lm_head_scale"] = quant(v)
            else:
                out[k] = v
        return out

    return convert(params)


def fuse_llama_params(params: dict) -> dict:
    """Unfused params -> the ``fused_qkv=True`` layout: q|k|v kernels
    concatenated along the output axis into ``qkv_proj``, gate|up into
    ``gateup_proj`` (float kernels or int8 {w_int8, scale}; scales
    concatenate along F)."""

    def cat(entries):
        if "kernel" in entries[0]:
            return {"kernel": np.concatenate([np.asarray(e["kernel"]) for e in entries], axis=1)}
        return {
            "w_int8": np.concatenate([np.asarray(e["w_int8"]) for e in entries], axis=1),
            "scale": np.concatenate([np.asarray(e["scale"]) for e in entries], axis=0),
        }

    fused = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    out = {}
    for key, val in params.items():
        if isinstance(val, dict) and "q_proj" in val:
            layer = {k: v for k, v in val.items() if k not in fused}
            layer["qkv_proj"] = cat([val["q_proj"], val["k_proj"], val["v_proj"]])
            layer["gateup_proj"] = cat([val["gate_proj"], val["up_proj"]])
            out[key] = layer
        else:
            out[key] = val
    return out
