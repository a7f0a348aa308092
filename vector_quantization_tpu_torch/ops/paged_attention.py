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
(``csrc/paged_attention.cu``, split over pages as :func:`decode_plan` says);
a CPU tensor through the plain version
:func:`paged_decode_attention_reference`. The choice is made by the tensor's
device alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .device import card
from .paged_kv import PagedKVCache, paged_gather

__all__ = ["DecodePlan", "decode_occupancy", "decode_plan", "paged_decode_attention",
           "paged_decode_attention_reference"]

_NEG = -1.0e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEADS = 16  # warps per block, one per head (csrc/paged_attention.cu MAX_HEADS)
_MAX_ROUNDS = 4  # positions per lane per chunk (MAX_ROUNDS)
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
STAGE_BYTES = 40 << 10  # target bytes of one shared-memory stage of the kernel's ring
STAGES = 2  # stages of the ring (at most 4)
BLOCKS_PER_SM = 4  # the grid aims at this many (split, row, head group) blocks per SM


class DecodePlan(NamedTuple):
    """How the kernel cuts one call: ``splits`` runs of ``pages_per_split``
    pages per row, heads in groups of ``heads_per_group`` (one block per
    (split, row, group)), pages streamed in chunks of ``chunk`` positions
    whose head rows sit ``pitch`` bytes apart in shared memory, through a
    ring of ``stages`` stages of ``stage_bytes``; ``workspace`` f32 values
    for the splits' partial sums (0 with one split)."""

    splits: int
    pages_per_split: int
    heads_per_group: int
    groups: int
    chunk: int
    pitch: int
    stage_bytes: int
    stages: int
    smem_bytes: int
    workspace: int


@functools.lru_cache(maxsize=None)  # the decode step asks once per layer for the same plan
def decode_plan(b: int, h: int, dh: int, p_cap: int, ps: int, pool_dtype: torch.dtype,
                num_sms: int, stage_bytes: int = STAGE_BYTES,
                stages: int = STAGES) -> DecodePlan:
    """The kernel's plan from shapes alone (never the lengths, which live on
    the device): split each row's ``p_cap`` pages into as many runs as bring
    the grid to about ``BLOCKS_PER_SM`` blocks per SM, and pick the
    position chunk that fills a stage of about ``stage_bytes``."""
    groups = -(-h // _MAX_HEADS)
    hg = -(-h // groups)
    row = dh * torch.empty((), dtype=pool_dtype).element_size()
    pieces = row // 16  # lanes per position
    g = 32 // pieces  # positions per warp round
    # pad a position's heads so that consecutive positions start `pieces`
    # 16-byte bank groups apart: a quarter warp's reads hit distinct banks
    pitch = hg * row + (16 * ((pieces - hg * pieces) % 8) if pieces < 8 else 0)
    scales = 8 * hg if pool_dtype == torch.int8 else 0  # k and v scale per head
    per_pos = 2 * pitch + scales
    want = min(p_cap, max(1, -(-BLOCKS_PER_SM * num_sms // (b * groups))))
    pps = -(-p_cap // want)
    splits = -(-p_cap // pps)
    chunk = max(1, min(_MAX_ROUNDS * g, ps, stage_bytes // per_pos))
    if chunk > g:
        chunk -= chunk % g
    stages = max(1, min(stages, pps * -(-ps // chunk)))  # no more than a split's chunks
    chunk = max(1, min(chunk, (_SMEM_LIMIT // stages - 16) // per_pos))
    stage = -(-(chunk * per_pos) // 16) * 16
    workspace = b * splits * h * (dh + 2) if splits > 1 else 0
    return DecodePlan(splits, pps, hg, groups, chunk, pitch, stage, stages, stages * stage,
                      workspace)


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


def decode_occupancy(plan: DecodePlan, q_dtype: torch.dtype, pool_dtype: torch.dtype,
                     dh: int) -> int:
    """Resident blocks per SM of the kernel under ``plan`` (the card's own
    occupancy calculator; builds the kernel)."""
    fn = _build.load("paged_attention").vqt_paged_decode_attention_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6
    blocks = fn(_DTYPE_CODE[q_dtype], _DTYPE_CODE[pool_dtype], dh, plan.heads_per_group,
                plan.stage_bytes, plan.stages)
    if blocks < 0:
        raise RuntimeError(f"paged_decode_attention occupancy query failed: CUDA error {-blocks}")
    return blocks


def _kernel():
    fn = _build.load("paged_attention").vqt_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, i, p, p, i, p, p, p, ctypes.c_longlong, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, i, i, i, p]
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
    p_cap = page_table.shape[1]
    plan = decode_plan(b, h, dh, p_cap, ps, k_pool.dtype, card(q.device).sms)
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h * dh), dtype=torch.float32, device=q.device)
    work = (torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
            if plan.workspace else None)
    int8 = k_scale_pool is not None
    err = _kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype],
        k_pool.data_ptr(), v_pool.data_ptr(), _DTYPE_CODE[k_pool.dtype],
        k_scale_pool.data_ptr() if int8 else None,
        v_scale_pool.data_ptr() if int8 else None,
        page_table.data_ptr(), page_table.stride(0), lengths.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(),
        b, h, dh, num_pages, ps, p_cap, layer, 1.0 / dh**0.5,
        plan.heads_per_group, plan.chunk, plan.pitch, plan.pages_per_split, plan.splits,
        plan.stage_bytes, plan.stages, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
