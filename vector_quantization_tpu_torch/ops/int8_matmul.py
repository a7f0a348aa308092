"""Weight-only INT8 matmul for the memory-bound AR decode step.

``int8_matmul(x (..., D), w_int8 (D, F), scale (F,)) -> (..., F) float32``:
x is cast to bf16, multiplied by the int8 weight converted to bf16 with f32
accumulation, and the per-output-channel scale is applied to the f32 sum
(the function of ``vector_quantization_tpu/ops/int8_matmul.py``
``int8_matmul``, both its Pallas and its XLA path).

A CUDA tensor goes through a hand-written Hopper kernel, chosen per shape by
:func:`plan` (no timing at run time): the wide design
(``csrc/int8_matmul_wide.cu``) where x's and w's rows are 16-byte aligned
and a block's share fits, the split-K design (``csrc/int8_matmul.cu``)
elsewhere. A CPU tensor goes through the plain version
:func:`int8_matmul_reference`, which repeats the kernels' arithmetic step by
step. The choice is made by the tensor's device alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .device import H100, Card, card

__all__ = [
    "DESIGNS", "H100", "Card", "Plan", "card", "int8_matmul", "int8_matmul_reference",
    "occupancy", "plan", "plan_for", "split_k", "split_k_plan", "wide_plan",
]

_BN, _BM, _BK = 128, 64, 32  # the split-K kernel's tile sizes (csrc/int8_matmul.cu)
_MIN_K_TILES = 8  # 256 of depth per block at least
_RESERVED = 1024  # shared memory a Hopper SM keeps aside per resident block


def int8_matmul_reference(
    x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Plain version: bf16 x, exact bf16*int8 products summed in f32, then
    the scale."""
    if x.is_cuda:
        int8_matmul_reference.cuda_calls += 1
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).float()
    out = torch.matmul(x2, w_int8.float()) * scale.float()
    return out.reshape(*lead, -1)


int8_matmul_reference.cuda_calls = 0


# each design's kernel: its source, csrc/<source>.cu (the name ``_build.load``
# takes and the kernel's name in reports), and the kernel function in it
DESIGNS = {"split_k": ("int8_matmul", "w8a16_kernel"),
           "wide": ("int8_matmul_wide", "w8a16_wide_kernel")}


class Plan(NamedTuple):
    """How one call is launched.

    ``design``: ``"split_k"`` (``csrc/int8_matmul.cu``: a block per 128
    columns and ``k_chunk`` of depth, the ``split`` partial sums of a column
    added by f32 atomics into a zeroed output, 32-deep tiles prefetched into
    registers) or ``"wide"`` (``csrc/int8_matmul_wide.cu``: a block per 128
    columns over a 1/``split`` share of D, each block's rows pushed to the
    block of the cluster that stores them; x's share, ``k_chunk`` deep at
    most, held whole in shared memory, the weight's 64-deep tiles through a
    ring of ``stages``; x's and w's rows 16-byte aligned). Both take 64
    rows of x per block."""

    design: str
    n: int
    split: int
    kt: int
    stages: int
    k_chunk: int

    @property
    def source(self) -> str:
        """The kernel's source: ``csrc/<source>.cu``."""
        return DESIGNS[self.design][0]

    def grid(self, b: int, d: int, f: int) -> tuple[int, int, int]:
        """The launch's grid; in the wide design a cluster is ``split``
        blocks along x, in the split-K design D's splits are grid y."""
        if self.design == "split_k":
            return -(-f // self.n), -(-d // self.k_chunk), -(-b // 64)
        return -(-f // self.n) * self.split, -(-b // 64), 1

    def blocks(self, b: int, d: int, f: int) -> list[tuple[int, int, int, int]]:
        """Each block's (first row, first column, first depth, end depth),
        as the kernel derives them from its block index; its columns are
        [first column, first column + ``n``) within F."""
        out = []
        for m0 in range(0, b, 64):
            for n0 in range(0, f, self.n):
                if self.design == "split_k":
                    out += [(m0, n0, k0, min(d, k0 + self.k_chunk))
                            for k0 in range(0, d, self.k_chunk)]
                    continue
                tiles = -(-d // self.kt)
                for rank in range(self.split):
                    kb, ke = rank * tiles // self.split, (rank + 1) * tiles // self.split
                    out.append((m0, n0, kb * self.kt, min(d, ke * self.kt)))
        return out

    def smem(self) -> int:
        """Shared memory per block, in bytes (the kernels' own reckoning)."""
        if self.design == "split_k":
            return _BM * (_BK + 8) * 2 + _BK * (_BN + 16)  # static x and w tiles
        # x's share, the weight ring, the cluster's copies of its rows
        recv = 64 * 128 * 4 if self.split > 1 else 0
        return 1024 + self.k_chunk // 64 * 64 * 128 + self.stages * 64 * 128 + recv


def split_k(b: int, d: int, f: int, num_sms: int) -> int:
    """Depth per block (a multiple of 32): split D until the grid (F tiles
    x D splits x B tiles) holds about two blocks per SM, but give each block
    at least 256 of depth. Shallower splits measured slower at the Llama-
    medium decode shapes on an H100: the split partial sums' atomics and the
    per-block load latency outweigh the extra blocks (PERF.md)."""
    k_tiles = -(-d // _BK)
    blocks = -(-f // _BN) * -(-b // _BM)
    splits = min(k_tiles, max(1, -(-2 * num_sms // blocks)))
    return min(max(-(-k_tiles // splits), _MIN_K_TILES), k_tiles) * _BK


def split_k_plan(b: int, d: int, f: int, num_sms: int) -> Plan:
    """The split-K design's plan: :func:`split_k`'s depth per block."""
    k_chunk = split_k(b, d, f, num_sms)
    return Plan("split_k", _BN, -(-d // k_chunk), _BK, 1, k_chunk)


def wide_plan(b: int, d: int, f: int, card: Card) -> Plan | None:
    """The wide design's plan, for operands read 16 bytes at a time: 128
    columns per block; D split over the largest cluster of 1, 2, 4 or 8
    whose grid runs in one wave at two blocks per SM (at most one block per
    64-deep tile); every weight tile of a block's share in the ring (2-8),
    fewer where they would not fit beside the blocks an SM must hold. None
    where even 2 do not. Each rule is the best of the sweep at all four
    aligned decode shapes (PERF.md): clusters of 3, 5, 6
    or 7 were slower than 4 or 8, fewer than 132 blocks slower than up to
    264, and 128 columns faster than 64 (NVIDIA H100 80GB HBM3, 700 W)."""
    tiles = -(-d // 64)
    stripes = -(-f // 128) * -(-b // 64)
    split = max(k for k in (1, 2, 4, 8)
                if k == 1 or (k <= tiles and stripes * k <= 2 * card.sms))
    share, per_sm = -(-tiles // split), -(-stripes * split // card.sms)
    for stages in range(min(max(share, 2), 8), 1, -1):
        p = Plan("wide", 128, split, 64, stages, share * 64)
        if p.smem() <= card.smem_block and per_sm * (p.smem() + _RESERVED) <= card.smem_sm:
            return p
    return None


@functools.lru_cache(maxsize=None)
def plan(b: int, d: int, f: int, card: Card, aligned: bool) -> Plan:
    """The design and its parameters for one call, from the shape, the card
    and the operands' alignment (``aligned``: the bases of x and w and their
    row pitches, 2 D and F bytes, are multiples of 16 bytes). The wide
    design where they are and its shares fit; the split-K design elsewhere
    (the lm head's F = 17385 among them)."""
    return (aligned and wide_plan(b, d, f, card)) or split_k_plan(b, d, f, card.sms)


def plan_for(x: torch.Tensor, w_int8: torch.Tensor) -> Plan:
    """The plan of a call on x (B, D) bf16 and w_int8 (D, F), both
    contiguous and on one CUDA device, as :func:`int8_matmul` launches it."""
    (b, d), f = x.shape, w_int8.shape[1]
    aligned = (x.data_ptr() % 16 == 0 and (2 * d) % 16 == 0
               and w_int8.data_ptr() % 16 == 0 and f % 16 == 0)
    return plan(b, d, f, card(x.device), aligned)


def occupancy(p: Plan, b: int, d: int, f: int) -> dict:
    """A wide plan's dynamic shared memory per block, resident blocks per
    SM and clusters of its grid that run at once on the current card, as
    the kernel reckons them."""
    if p.design != "wide":
        raise ValueError(f"occupancy: a wide plan, got {p.design!r}")
    smem, per_sm, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _build.load(p.source).vqt_int8_matmul_wide_occupancy(
        b, d, f, p.split, p.stages, ctypes.byref(smem), ctypes.byref(per_sm),
        ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"int8_matmul occupancy query failed: CUDA error {err}")
    return {"dynamic_smem": smem.value, "blocks_per_sm": per_sm.value,
            "clusters_at_once": clusters.value}


@functools.lru_cache(maxsize=None)
def _entry(source: str, name: str, n_int: int):
    """A kernel's C entry: 4 pointers, ``n_int`` ints, the stream."""
    fn = getattr(_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    return fn


def _launch(x2: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            p: Plan | None = None) -> torch.Tensor:
    """One launch on x2 (B, D): under :func:`plan_for`'s plan, or under
    ``p`` (the card tests force each design this way)."""
    b, d = x2.shape
    f = w.shape[1]
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w_int8 must be int8 ({d}, F), got {w.dtype} {tuple(w.shape)}")
    if scale.shape != (f,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32 ({f},), got {scale.dtype} {tuple(scale.shape)}")
    if not (w.is_cuda and scale.is_cuda) or w.device != x2.device or scale.device != x2.device:
        raise ValueError("int8_matmul: x, w_int8 and scale must be on one CUDA device")
    x2 = x2.to(torch.bfloat16).contiguous()
    w = w.contiguous()
    scale = scale.contiguous()
    if p is None:
        p = plan_for(x2, w)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ptrs = (x2.data_ptr(), w.data_ptr(), scale.data_ptr())
    if p.design == "split_k":
        # split partial sums are added atomically into a zeroed output
        out = (torch.zeros if p.split > 1 else torch.empty)(
            (b, f), dtype=torch.float32, device=x2.device)
        err = _entry(p.source, "vqt_int8_matmul", 4)(
            *ptrs, out.data_ptr(), b, d, f, p.k_chunk, stream)
    elif p.design == "wide":
        out = torch.empty((b, f), dtype=torch.float32, device=x2.device)
        err = _entry(p.source, "vqt_int8_matmul_wide", 5)(
            *ptrs, out.data_ptr(), b, d, f, p.split, p.stages, stream)
    else:
        raise ValueError(f"int8_matmul: unknown design {p.design!r}")
    if err != 0:
        raise RuntimeError(f"int8_matmul {p.design} kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    int8_matmul.design_launches[p.design] += 1
    return out


def int8_matmul(
    x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """(..., D) @ int8 (D, F) * scale (F,) -> (..., F) float32.

    CUDA tensors launch the kernel that :func:`plan` picks, and raise if it
    cannot run; CPU tensors take :func:`int8_matmul_reference`.
    """
    if not x.is_cuda:
        return int8_matmul_reference(x, w_int8, scale)
    lead = x.shape[:-1]
    out = _launch(x.reshape(-1, x.shape[-1]), w_int8, scale)
    return out.reshape(*lead, -1)


int8_matmul.launches = 0  # every launch
int8_matmul.design_launches = dict.fromkeys(DESIGNS, 0)  # the launches of each design
