"""Paged KV cache: one page pool shared by the decode slots of the server.

The layout of ``vector_quantization_tpu/ops/paged_kv.py``:

- pool: k/v ``(L, num_pages, page_size, H, Dh)``;
- ``page_table`` ``(B, pages_per_slot)`` int32: page ids per slot in logical
  order (entries beyond a slot's allocation are 0, the scratch page);
- position ``p`` of slot ``b`` lives at
  ``pool[layer, page_table[b, p // ps], p % ps]``.

INT8 pool (``dtype=torch.int8``): k/v hold int8 values with per-(position,
head) f32 max-abs scales in ``k_scale``/``v_scale`` ``(L, P, ps, H)``.

Unlike the JAX version, :func:`paged_update` writes into the pool tensors
in place and returns the same cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PagedKVCache", "init_paged_cache", "paged_update", "paged_gather", "quant_kv"]


class PagedKVCache(NamedTuple):
    k: torch.Tensor  # (L, num_pages, page_size, H, Dh)
    v: torch.Tensor
    page_table: torch.Tensor  # (B, pages_per_slot) int32
    k_scale: torch.Tensor | None = None  # (L, num_pages, page_size, H) f32
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def logical_length(self) -> int:
        return self.page_table.shape[1] * self.k.shape[2]


def init_paged_cache(
    num_layers: int,
    num_pages: int,
    page_size: int,
    batch: int,
    pages_per_slot: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> PagedKVCache:
    shape = (num_layers, num_pages, page_size, num_heads, head_dim)
    table = torch.zeros((batch, pages_per_slot), dtype=torch.int32, device=device)
    if dtype == torch.int8:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            page_table=table,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        page_table=table,
    )


def quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> int8 values + per-(...) f32 max-abs scales (round half
    to even, clipped to +-127): one scale per (position, head)."""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc


def paged_update(
    cache: PagedKVCache,
    layer: int,
    positions: torch.Tensor,  # (B,) int - write position per slot
    k: torch.Tensor,  # (B, H, Dh)
    v: torch.Tensor,
) -> PagedKVCache:
    """Scatter one token's k/v per slot into the page pool, quantising on
    the way in when the pool is INT8. Writes IN PLACE into ``cache``'s pool
    tensors and returns ``cache``. Idle rows may share (page 0, offset):
    duplicate indices are expected there."""
    ps = cache.page_size
    rows = torch.arange(positions.shape[0], device=positions.device)
    pos = positions.long()
    # a page index past the table's width reads its last entry, as the JAX
    # gather clamps
    col = torch.clamp(pos // ps, max=cache.page_table.shape[1] - 1)
    page = cache.page_table[rows, col].long()
    offset = pos % ps
    if cache.k_scale is not None:
        k, k_sc = quant_kv(k)
        v, v_sc = quant_kv(v)
        cache.k_scale[layer, page, offset] = k_sc
        cache.v_scale[layer, page, offset] = v_sc
    cache.k[layer, page, offset] = k.to(cache.k.dtype)
    cache.v[layer, page, offset] = v.to(cache.v.dtype)
    return cache


def paged_gather(
    cache: PagedKVCache, layer: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Logical (B, S, H, Dh) keys/values for every slot (S = pages * ps),
    plus (B, S, H) scales when the pool is INT8 (else None, None)."""
    b, p = cache.page_table.shape
    ps, h, dh = cache.k.shape[2:]
    idx = cache.page_table.long()
    k = cache.k[layer][idx].reshape(b, p * ps, h, dh)
    v = cache.v[layer][idx].reshape(b, p * ps, h, dh)
    if cache.k_scale is None:
        return k, v, None, None
    return (
        k,
        v,
        cache.k_scale[layer][idx].reshape(b, p * ps, h),
        cache.v_scale[layer][idx].reshape(b, p * ps, h),
    )
