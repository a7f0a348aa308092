"""Paged decode attention: single-token attention over a page pool.

``paged_decode_attention(q (B, H, Dh), k_pool/v_pool (L, P, ps, H, Dh),
page_table (B, P_cap), lengths (B,), layer) -> (B, H*Dh) float32``, the
function of ``vector_quantization_tpu/ops/paged_attention.py``: row ``b``
attends to its positions ``< lengths[b]`` read through ``page_table[b]``
(never past its ``P_cap`` pages); rows of length 0 give 0. INT8 pools pass
``k_scale_pool``/``v_scale_pool`` (L, P, ps, H) f32: the k scale multiplies
the scores, the v scale is folded into the probabilities after the softmax
denominator is summed.

A CUDA tensor goes through the hand-written Hopper kernel
(``csrc/paged_attention.cu``); a CPU tensor through the plain version
:func:`paged_decode_attention_reference`. The choice is made by the tensor's
device alone.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .paged_kv import PagedKVCache, paged_gather

__all__ = ["paged_decode_attention", "paged_decode_attention_reference"]

_NEG = -1.0e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: gather the rows' pages, then the kernel's arithmetic
    (f32 scores of the Dh^-0.5-scaled query, k scale on the scores, masked
    softmax, v scale folded into the probabilities, divide by max(l, 1e-9))."""
    if q.is_cuda:
        paged_decode_attention_reference.cuda_calls += 1
    b, h, dh = q.shape
    k, v, ksc, vsc = paged_gather(
        PagedKVCache(k_pool, v_pool, page_table, k_scale_pool, v_scale_pool), layer
    )
    qf = q.float() * (1.0 / dh**0.5)
    scores = torch.einsum("bhd,bshd->bhs", qf, k.float())
    if ksc is not None:
        scores = scores * ksc.transpose(1, 2)
    pos = torch.arange(scores.shape[-1], device=q.device)
    valid = pos[None, None, :] < lengths.long()[:, None, None]
    scores = torch.where(valid, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(valid, torch.exp(scores - m), 0.0)
    denom = torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
    if vsc is not None:
        probs = probs * vsc.transpose(1, 2)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float()) / denom
    return out.reshape(b, h * dh)


paged_decode_attention_reference.cuda_calls = 0


def _check(q, k_pool, v_pool, page_table, lengths, layer, ksc, vsc):
    b, h, dh = q.shape
    if k_pool.dim() != 5 or k_pool.shape[3:] != (h, dh) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools must be (L, P, ps, {h}, {dh}), got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
        )
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if dh not in (32, 64, 128):
        raise ValueError(f"the CUDA kernel takes head_dim 32, 64 or 128, got {dh}")
    int8 = k_pool.dtype == torch.int8
    if int8 != (ksc is not None) or (ksc is None) != (vsc is None):
        raise ValueError("int8 pools need both scale pools; float pools take none")
    if int8 and (ksc.shape != k_pool.shape[:4] or vsc.shape != ksc.shape
                 or ksc.dtype != torch.float32 or vsc.dtype != torch.float32):
        raise ValueError("scale pools must be float32 (L, P, ps, H)")
    if page_table.dim() != 2 or page_table.shape[0] != b or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be int32 ({b}, P_cap)")
    if page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},)")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's {k_pool.shape[0]} layers")
    tensors = [q, k_pool, v_pool, page_table, lengths] + ([ksc, vsc] if int8 else [])
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must be on one CUDA device")
    for t in (k_pool, v_pool) + ((ksc, vsc) if int8 else ()):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("pools must be contiguous and 16-byte aligned")


def _kernel():
    fn = _build.load("paged_attention").vqt_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, i, p, p, i, p, p, p, ctypes.c_longlong, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, p]
    return fn


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> torch.Tensor:
    """See the module docstring. CUDA tensors launch the Hopper kernel (and
    raise if it cannot run); CPU tensors take the plain version."""
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, page_table, lengths, layer,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
        )
    _check(q, k_pool, v_pool, page_table, lengths, layer, k_scale_pool, v_scale_pool)
    b, h, dh = q.shape
    _, num_pages, ps = k_pool.shape[:3]
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h * dh), dtype=torch.float32, device=q.device)
    int8 = k_scale_pool is not None
    err = _kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype],
        k_pool.data_ptr(), v_pool.data_ptr(), _DTYPE_CODE[k_pool.dtype],
        k_scale_pool.data_ptr() if int8 else None,
        v_scale_pool.data_ptr() if int8 else None,
        page_table.data_ptr(), page_table.stride(0), lengths.data_ptr(),
        out.data_ptr(), b, h, dh, num_pages, ps, page_table.shape[1], layer,
        1.0 / dh**0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
