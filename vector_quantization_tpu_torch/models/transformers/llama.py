"""Llama-style AR decoder: the training forward and the decode paths.

Port of ``vector_quantization_tpu/models/transformers/llama.py``: RMSNorm,
rotate-half RoPE, SwiGLU FFN, no biases; float or INT8 weight-only
projections (``Int8Dense``), optional fused qkv / gate+up projections,
INT8 lm head.

- The cache-free forward: causal attention over the whole sequence, either
  the einsum attention (f32 scores of the operands as given, softmax in
  f32, probabilities cast to ``dtype`` before the product with v) or, with
  ``flash=True`` and T > 1, the flash attention kernels
  (``ops/flash_attention.py``); per-block rematerialisation with
  ``torch.utils.checkpoint`` (``remat=True``): the whole block re-run in
  the backward, or with ``remat_policy="dots"`` selective checkpointing
  that keeps the projections' products (``aten.mm``/``addmm``, the dots
  with no batch dimension, as JAX's ``dots_with_no_batch_dims_saveable``)
  and re-runs the rest; logits from the f32 (or
  ``head_dtype``) head, the INT8 head (``quantize=True``), or with
  ``fused_ce_targets`` the scalar teacher-forced CE of the logits-free head
  (``ops/fused_ce.py``).
- Decode over the dense per-layer cache (:class:`KVCache`): a scalar
  offset (``cache.length``, prefill of T >= 1 tokens or one step), per-row
  ``slot_positions`` (each row writes its own column), or ``row_starts``
  (the shared-column serving engine: every row writes the shared column,
  its reads masked to its own stream). The attention is the einsum form;
  an INT8 cache applies its per-(position, head) scales after the score
  product and on the probabilities. The cache's tensors are written in
  place; the returned cache carries the new length.
- Single-token decode with per-row ``slot_positions`` over a paged KV pool
  (``ops/paged_kv.py``) read by the paged decode attention kernel
  (``ops/paged_attention.py``).

Parameter names and layouts follow the flax module: projection weights are
``(in, out)`` (``kernel`` or ``w_int8`` + ``scale``), the embedding and
norms are f32, so ``utils/bridge.py`` maps a flax param tree one to one.
``quantize_mode="w8a8"`` runs the INT8 projections and head through
``int8_matmul_w8a8`` (activations quantised per row, int8 x int8 -> int32).

Tensor parallelism (:func:`shard_llama_tp`, ``parallel.sharding.TPStrategy``)
replaces the weights by one rank's shards in place, Megatron-style over a
process group: q/k/v and gate/up column-parallel (each rank holds its heads'
q, k and v and its own gate and up columns, also in the fused ``q|k|v`` and
``gate|up`` layouts, an INT8 projection's scales split with its columns),
o and down row-parallel with their outputs summed over the group; the
embedding and the lm head split over the vocabulary where it divides, the
logits gathered before sampling or the CE (the fused CE gathers the head's
weight). A module that does not divide (heads, ffn or vocabulary by the
group's size) stays replicated. Each rank runs the attention kernels on its
own heads, and its caches hold its own heads.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ...ops.flash_attention import flash_attention
from ...ops.fused_ce import fused_next_token_ce
from ...ops.int8_matmul import int8_matmul, int8_matmul_w8a8, prepare_w8a8
from ...ops.paged_attention import paged_decode_attention
from ...ops.paged_kv import PagedKVCache, init_paged_cache, paged_update, quant_kv
from ...parallel.collectives import Layout, copy_to_group, gather_from_group, reduce_from_group
from ...registries import TransformerRegistry

__all__ = [
    "KVCache",
    "LlamaTransformer",
    "LlamaBlock",
    "Int8Dense",
    "Dense",
    "RMSNorm",
    "quantize_params_int8",
    "fuse_llama_params",
    "make_dense_cache",
    "shard_llama_tp",
    "resize_rows",
    "resolve_dtype",
]

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


class KVCache(NamedTuple):
    """Dense decode cache: k/v are per-layer tuples of (B, S, H, Dh); with
    ``k_scale``/``v_scale`` (per-layer (B, S, H) f32) k/v hold INT8 values
    quantised per (position, head). ``length`` is a host int, the number of
    columns written by scalar-offset decode: slicing by it needs no device
    sync. Decode writes the tensors in place."""

    k: tuple[torch.Tensor, ...]
    v: tuple[torch.Tensor, ...]
    length: int
    k_scale: tuple[torch.Tensor, ...] | None = None
    v_scale: tuple[torch.Tensor, ...] | None = None

    @property
    def window(self) -> int:
        """Cache columns per row (the attention window)."""
        return self.k[0].shape[1]

    def map(self, fn) -> "KVCache":
        """The cache with ``fn`` applied to every per-layer tensor (k, v and
        the scales), its length kept."""
        def each(ts):
            return None if ts is None else tuple(fn(t) for t in ts)

        return self._replace(k=each(self.k), v=each(self.v), k_scale=each(self.k_scale),
                             v_scale=each(self.v_scale))


def make_dense_cache(
    num_layers: int,
    batch: int,
    rows: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> KVCache:
    """Per-layer zeroed cache of ``rows`` columns per row (INT8 when ``dtype``
    is ``torch.int8``: int8 values and f32 per-(position, head) scales)."""
    shape = (batch, rows, num_heads, head_dim)

    def zeros(shape, dt):
        return tuple(torch.zeros(shape, dtype=dt, device=device) for _ in range(num_layers))

    if dtype == torch.int8:
        return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8), 0,
                       zeros(shape[:-1], torch.float32), zeros(shape[:-1], torch.float32))
    return KVCache(zeros(shape, dtype), zeros(shape, dtype), 0)


def resize_rows(a: torch.Tensor, rows: int, shift: int = 0) -> torch.Tensor:
    """A per-layer cache tensor (B, S, ...) re-windowed to columns
    [shift, shift + rows): columns past S read as zeros (the JAX package's
    pad-then-slice): a new contiguous tensor, or ``a`` itself when the
    window does not change."""
    if shift == 0 and rows == a.shape[1]:
        return a
    out = a.new_zeros((a.shape[0], rows, *a.shape[2:]))
    n = max(0, min(a.shape[1] - shift, rows))
    out[:, :n] = a[:, shift:shift + n]
    return out


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: keep the outputs of the products with no
    batch dimension (a ``Dense`` projection reaches ``aten.mm``), re-run
    everything else (``bmm``, the flash attention's ``autograd.Function``,
    RMSNorm, RoPE, SwiGLU)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


class _W8A8Weights:
    """An int8 weight and its scale as ``int8_matmul_w8a8`` takes them
    (:func:`...ops.int8_matmul.prepare_w8a8`), made again only when either
    tensor is replaced or written (a load, a move to another device)."""

    def __init__(self) -> None:
        self._key: tuple | None = None
        self._prepared: tuple[torch.Tensor, torch.Tensor] | None = None

    def __call__(self, w_int8: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        key = (w_int8.data_ptr(), w_int8._version, scale.data_ptr(), scale._version)
        if key != self._key:
            self._key, self._prepared = key, prepare_w8a8(w_int8, scale)
        return self._prepared


class Int8Dense(nn.Module):
    """INT8 linear (no bias): an int8 ``(in, out)`` weight and a per-output
    f32 scale. ``mode`` "w8a8": ``int8_matmul_w8a8`` (x quantised per row);
    else weight-only, ``int8_matmul`` dequantising inside the product.
    Returns the input's dtype, as the flax module does."""

    def __init__(self, in_features: int, features: int, mode: str = "auto") -> None:
        super().__init__()
        self.mode = mode
        self.register_buffer("w_int8", torch.zeros(in_features, features, dtype=torch.int8))
        self.register_buffer("scale", torch.full((features,), 0.01, dtype=torch.float32))
        self._w8a8 = _W8A8Weights()
        self.tp_in = self.tp_out = None  # tensor parallel: column / row group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.tp_in)
        if self.mode == "w8a8":
            w, s = self._w8a8(self.w_int8, self.scale)
            out = int8_matmul_w8a8(x, w, s, self.scale.shape[0])
        else:
            out = int8_matmul(x, self.w_int8, self.scale)
        # a row-parallel product's partial sums are reduced in f32
        return reduce_from_group(out, self.tp_out).to(x.dtype)


class Dense(nn.Module):
    """Float linear (no bias) with an ``(in, out)`` f32 kernel, computed in
    ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.tp_in = self.tp_out = None  # tensor parallel: column / row group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.tp_in)
        return reduce_from_group(torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype)), self.tp_out)


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


def _einsum_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dtype: torch.dtype,
    mask: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference's einsum attention: f32 scores of the operands read as
    ``dtype`` (exact products of bf16 values, f32 sums), divided by
    sqrt(Dh), times the INT8 cache's key scales (B, S, H) where given, plus
    the additive ``mask`` (the causal T x T one when None); an f32 softmax,
    times the value scales where given; probabilities cast to ``dtype``
    before the product with v. q (B, T, H, Dh); k, v (B, S, H, Dh)."""
    t, dh = q.shape[1], q.shape[-1]

    def operand(a):  # a read as dtype, then widened; int8 values are exact in both
        return a.float() if a.dtype == torch.int8 else a.to(dtype).float()

    scores = torch.einsum("bthd,bshd->bhts", q.float(), operand(k)) / float(np.sqrt(dh))
    if k_scale is not None:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    if mask is None:
        i = torch.arange(t, device=q.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, _NEG_MASK)
    probs = torch.softmax(scores + mask, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhts,bshd->bthd", probs.to(dtype), v.to(dtype))


def _dense_cache_attention(q, k, v, layer, offset, mask, dtype):
    """Write this step's k/v into one layer's dense cache ``layer`` ((k, v)
    or (k, v, k_scale, v_scale), in place) at ``offset``, then attend over
    the whole window under ``mask``. ``offset``: a host int (columns
    [offset, offset + T) of every row) or a (B,) tensor (row b's column
    offset[b], T == 1)."""
    int8_kv = len(layer) == 4
    if int8_kv:
        k_all, v_all, ks_all, vs_all = layer
        (k, ks), (v, vs) = quant_kv(k), quant_kv(v)
    else:
        (k_all, v_all), ks_all, vs_all = layer, None, None
    if isinstance(offset, torch.Tensor):
        idx = (torch.arange(q.shape[0], device=q.device), offset.long())
        k, v = k[:, 0], v[:, 0]
        if int8_kv:
            ks, vs = ks[:, 0], vs[:, 0]
    else:
        if offset + q.shape[1] > k_all.shape[1]:
            raise ValueError(f"cache window {k_all.shape[1]} cannot take columns "
                             f"[{offset}, {offset + q.shape[1]})")
        idx = (slice(None), slice(offset, offset + q.shape[1]))
    k_all[idx] = k.to(k_all.dtype)
    v_all[idx] = v.to(v_all.dtype)
    if int8_kv:
        ks_all[idx] = ks
        vs_all[idx] = vs
    return _einsum_attention(q, k_all, v_all, dtype, mask, ks_all, vs_all)


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
        quantize_mode: str = "auto",
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.flash = flash
        self.ffn_dim = ffn_dim
        self.dtype = dtype
        self.fused_qkv = fused_qkv
        d = hidden_size

        def dense(fin, fout):
            return Int8Dense(fin, fout, quantize_mode) if quantize else Dense(fin, fout, dtype)

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
        """input norm, q/k/v projections, RoPE: three (B, T, H, Dh) (H this
        rank's heads under tensor parallelism)."""
        b, t, _ = x.shape
        h, dh = self.num_heads, self.head_dim
        y = self.input_norm(x)
        if self.fused_qkv:
            q, k, v = self.qkv_proj(y).split(h * dh, dim=-1)  # q|k|v
        else:
            q, k, v = self.q_proj(y), self.k_proj(y), self.v_proj(y)
        q = _rope(q.reshape(b, t, h, dh), positions)
        k = _rope(k.reshape(b, t, h, dh), positions)
        return q, k, v.reshape(b, t, h, dh)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        cache: PagedKVCache | tuple[torch.Tensor, ...] | None = None,
        layer_idx: int = 0,
        offset: torch.Tensor | int | None = None,
        mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Without a cache: the training block, x (B, T, D), positions
        (B, T), causal attention over the sequence. With a paged cache:
        x (B, 1, D), positions (B, 1); writes this token's k/v into the
        pool at (layer_idx, offset) in place, then attends over the pool.
        With this layer's dense cache (a tuple, see
        :func:`_dense_cache_attention`): writes at ``offset`` in place,
        then attends over the window under the additive ``mask``
        (B or 1, 1, T, S)."""
        b, t, _ = x.shape
        q, k, v = self._qkv(x, positions)
        if cache is None:
            if self.flash and t > 1:
                attn = _flash_train_attention(q, k, v, self.dtype)
            else:
                attn = _einsum_attention(q, k, v, self.dtype)
        elif isinstance(cache, PagedKVCache):
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
            ).to(self.dtype)
        else:
            attn = _dense_cache_attention(q, k, v, cache, offset, mask, self.dtype)
        x = x + self.o_proj(attn.reshape(b, t, self.num_heads * self.head_dim))
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
    ``forward(tokens (B, T), cache=KVCache[, slot_positions | row_starts])``
    decodes over the dense cache (:meth:`init_cache`) and returns
    ``(logits (B, T, V) float32, cache)``.
    ``forward(tokens (B, 1), cache=PagedKVCache, slot_positions=(B,))``
    returns ``(logits (B, 1, V) float32, cache)``; the pool is updated in
    place. The INT8 lm head (``quantize=True``) returns f32 logits; the
    float head computes in ``head_dtype`` (None = f32) with f32 sums.

    ``quantize_mode`` "auto", "pallas" and "xla" name the JAX package's
    backends for one function; here all three run ``int8_matmul`` (the
    CUDA kernel on the card). "w8a8" quantises the activations too: the
    projections and the INT8 head run ``int8_matmul_w8a8``.

    Weights start as the reference initialises them (N(0, 0.02)
    projections and embedding, zero lm head) from ``seed``; serving loads
    converted weights over them (``utils/bridge.py``).
    """

    # the fused_ce_targets loss is wired into forward (ARAlgorithm checks)
    supports_fused_ce = True
    # RoPE is relative, so the shared-column serving engine's recentred
    # columns keep every row's logits (ARServer checks)
    supports_shared_column = True

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
        if quantize_mode not in ("auto", "pallas", "xla", "w8a8"):
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
        # tensor parallel over the vocabulary: the group, and this rank's
        # first row of the embedding (column of the head)
        self.tp_vocab = None
        self.vocab_start = 0

        self.embedding = nn.Parameter(torch.zeros(vocabulary_size, hidden_size))
        for i in range(num_layers):
            self.add_module(
                f"layer{i}",
                LlamaBlock(hidden_size, num_heads, ffn_dim, self.dtype, quantize, fused_qkv, flash,
                           quantize_mode),
            )
        self.final_norm = RMSNorm(hidden_size, self.dtype)
        if quantize:
            self.register_buffer(
                "lm_head_int8", torch.zeros(hidden_size, vocabulary_size, dtype=torch.int8)
            )
            self.register_buffer("lm_head_scale", torch.zeros(vocabulary_size))
            self._w8a8_head = _W8A8Weights()
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
        cache: KVCache | PagedKVCache | None = None,
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
        if isinstance(cache, PagedKVCache):
            return self._paged_forward(tokens, cache, slot_positions, row_starts)
        return self._dense_forward(tokens, cache, slot_positions, row_starts)

    @property
    def local_heads(self) -> int:
        """The heads this rank's attention and caches hold (all of them
        without tensor parallelism)."""
        return self.blocks()[0].num_heads

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in ``dtype``; split over the vocabulary, each
        rank looks up its own rows and the group sums them."""
        if self.tp_vocab is None:
            return self.embedding[tokens.long()].to(self.dtype)
        local = tokens.long() - self.vocab_start
        mine = (local >= 0) & (local < self.embedding.shape[0])
        x = self.embedding[torch.where(mine, local, 0)] * mine[..., None]
        return reduce_from_group(x, self.tp_vocab).to(self.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden states (B, T, D) -> logits (B, T, V) float32: the
        INT8 head through ``int8_matmul`` (``int8_matmul_w8a8`` under
        "w8a8"), else the float head in ``head_dtype`` (None = f32) with f32
        sums. Split over the vocabulary, each rank's columns are gathered."""
        b, t = x.shape[:2]
        x = copy_to_group(x, self.tp_vocab)
        if self.quantize:
            xh = x.reshape(b * t, self.hidden_size).to(self.dtype)
            cols = self.lm_head_scale.shape[0]
            if self.quantize_mode == "w8a8":
                w, s = self._w8a8_head(self.lm_head_int8, self.lm_head_scale)
                logits = int8_matmul_w8a8(xh, w, s, cols)
            else:
                logits = int8_matmul(xh, self.lm_head_int8, self.lm_head_scale)
            logits = logits.reshape(b, t, cols)
        else:
            hd = self.head_dtype or torch.float32
            logits = torch.matmul(x.to(hd).float(), self.lm_head.to(hd).float())
        return gather_from_group(logits, self.tp_vocab, -1)

    def _paged_forward(self, tokens, cache, slot_positions, row_starts):
        if row_starts is not None or slot_positions is None:
            raise ValueError("a paged cache requires slot_positions decode")
        b, t = tokens.shape
        if t != 1:
            raise ValueError("slot_positions requires single-token decode")
        x = self._embed(tokens)
        positions = slot_positions[:, None]
        for i, block in enumerate(self.blocks()):
            x = block(x, positions, cache, i, slot_positions)
        return self._head(self.final_norm(x)), cache

    def _dense_forward(self, tokens, cache, slot_positions, row_starts):
        """Decode over the dense cache. Scalar offset ``cache.length``: the
        T new tokens take columns [length, length + T) of every row and
        attend causally to all columns up to their own; with ``row_starts``
        (B,) row b also masks the columns before ``row_starts[b]`` (its
        stream began there; RoPE rotates by the shared column, so the logits
        equal the per-row path's up to rounding). ``slot_positions`` (B,),
        T == 1: row b writes and reads at its own column. Returns (logits,
        the cache with ``length + T``)."""
        b, t = tokens.shape
        col = torch.arange(cache.window, device=tokens.device)
        if slot_positions is not None:
            if row_starts is not None:
                raise ValueError("row_starts requires the scalar-offset cache decode")
            if t != 1:
                raise ValueError("slot_positions requires single-token decode")
            positions = slot_positions[:, None]
            offset = slot_positions
            mask = torch.where(col <= slot_positions[:, None, None, None], 0.0, _NEG_MASK)
        else:
            offset = cache.length
            pos = torch.arange(t, device=tokens.device) + offset
            positions = pos.expand(b, t)
            mask = torch.where(col[None, :] <= pos[:, None], 0.0, _NEG_MASK)[None, None]
            if row_starts is not None:
                mask = torch.where(col >= row_starts[:, None, None, None], mask, _NEG_MASK)
        int8_cache = cache.k_scale is not None
        x = self._embed(tokens)
        for i, block in enumerate(self.blocks()):
            layer = (cache.k[i], cache.v[i])
            if int8_cache:
                layer += (cache.k_scale[i], cache.v_scale[i])
            x = block(x, positions, layer, i, offset, mask)
        logits = self._head(self.final_norm(x))
        return logits, cache._replace(length=cache.length + t)

    def _train_forward(
        self, tokens: torch.Tensor, fused_ce_targets: torch.Tensor | None
    ) -> torch.Tensor:
        b, t = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        remat = self.remat and torch.is_grad_enabled()
        # "dots": selective checkpointing, the projections' products kept
        contexts = {"context_fn": _DOTS_CONTEXTS} if self.remat_policy == "dots" else {}
        if fused_ce_targets is not None and self.quantize:
            raise ValueError("fused_ce_targets is a training-path loss (float head)")
        for block in self.blocks():
            if remat:
                # per-block remat: the block inputs are kept (and under
                # "dots" the projections' outputs); the backward re-runs
                # the rest of the block, its attention kernel included
                x = checkpoint(block, x, positions, use_reentrant=False, **contexts)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        if fused_ce_targets is not None:
            # the chunk is clamped to the vocabulary's 128-multiple, as in
            # the reference (a tiny vocabulary gets one narrow chunk)
            chunk = min(self.fused_ce_chunk, -(-self.vocabulary_size // 128) * 128)
            head = gather_from_group(self.lm_head, self.tp_vocab, 1)
            return fused_next_token_ce(x, head, fused_ce_targets, chunk)
        return self._head(x)

    def init_cache(
        self,
        batch: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
        rows: int | None = None,
    ) -> KVCache:
        """A zeroed dense cache of ``rows`` (default ``max_length``) columns
        per row on ``device`` (default: the embedding's)."""
        dh = self.hidden_size // self.num_heads
        return make_dense_cache(
            self.num_layers, batch, self.max_length if rows is None else rows,
            self.local_heads, dh, dtype, self.embedding.device if device is None else device,
        )

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
            self.local_heads,
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


def shard_llama_tp(model: LlamaTransformer, group, rank: int, size: int) -> list[tuple[nn.Module, str, Layout]]:
    """``model``'s full weights replaced in place by rank ``rank``'s shards
    of ``size`` over ``group``; returns (module, tensor name, layout) of
    every tensor split. Attention is split by heads where ``size`` divides
    them (q/k/v columns, o rows), the FFN where it divides ``ffn_dim``, the
    embedding and lm head where it divides the vocabulary; the rest stays
    replicated."""
    entries: list[tuple[nn.Module, str, Layout]] = []

    def split(dense: nn.Module, dim: int, parts: int = 1) -> None:
        for key in ("kernel", "w_int8", "scale"):
            if not hasattr(dense, key):
                continue
            d = 0 if (key == "scale" and dim == 1) else dim
            if key == "scale" and dim == 0:
                continue  # a row-parallel product's scale is its output's
            layout = Layout(d, rank, size, group, parts)
            full = getattr(dense, key)
            local = layout.local(full.detach()).clone()
            if isinstance(full, nn.Parameter):
                full.data = local
            else:
                dense._buffers[key] = local
            entries.append((dense, key, layout))
        if dim == 1:
            dense.tp_in = group
        else:
            dense.tp_out = group

    with torch.no_grad():
        for block in model.blocks():
            if block.num_heads % size == 0:
                if block.fused_qkv:
                    split(block.qkv_proj, 1, 3)
                else:
                    for name in ("q_proj", "k_proj", "v_proj"):
                        split(getattr(block, name), 1)
                split(block.o_proj, 0)
                block.num_heads //= size
            if block.ffn_dim % size == 0:
                if block.fused_qkv:
                    split(block.gateup_proj, 1, 2)
                else:
                    split(block.gate_proj, 1)
                    split(block.up_proj, 1)
                split(block.down_proj, 0)
                block.ffn_dim //= size
        if model.vocabulary_size % size == 0:
            n = model.vocabulary_size // size
            model.tp_vocab, model.vocab_start = group, rank * n
            layouts = [("embedding", Layout(0, rank, size, group))]
            if model.quantize:
                layouts += [("lm_head_int8", Layout(1, rank, size, group)),
                            ("lm_head_scale", Layout(0, rank, size, group))]
            else:
                layouts.append(("lm_head", Layout(1, rank, size, group)))
            for key, layout in layouts:
                full = getattr(model, key)
                local = layout.local(full.detach()).clone()
                if isinstance(full, nn.Parameter):
                    full.data = local
                else:
                    model._buffers[key] = local
                entries.append((model, key, layout))
    return entries
