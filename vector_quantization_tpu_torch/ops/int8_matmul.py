"""Weight-only INT8 matmul for the memory-bound AR decode step.

``int8_matmul(x (..., D), w_int8 (D, F), scale (F,)) -> (..., F) float32``:
x is cast to bf16, multiplied by the int8 weight converted to bf16 with f32
accumulation, and the per-output-channel scale is applied to the f32 sum
(the function of ``vector_quantization_tpu/ops/int8_matmul.py``
``int8_matmul``, both its Pallas and its XLA path).

A CUDA tensor goes through a hand-written Hopper kernel, chosen per shape by
:func:`plan` (no timing at run time): the tiled design
(``csrc/int8_matmul_tiled.cu``, wgmma tiles of 256 rows) at
``TILED_MIN_ROWS`` rows or more, where the product is bound by operations;
below it the wide design (``csrc/int8_matmul_wide.cu``) where x's and w's
rows are 16-byte aligned and a block's share fits, the ragged design
(``csrc/int8_matmul_ragged.cu``) where x's rows are aligned and w's are not
(the decode lm head's F = 17385), the split-K design (``csrc/int8_matmul.cu``)
elsewhere. A CPU tensor goes through the plain version
:func:`int8_matmul_reference`, which repeats the kernels' arithmetic step by
step. The choice is made by the tensor's device alone.

``int8_matmul_w8a8`` is the JAX package's dynamic-activation variant: x
quantised per row to int8, an int8 x int8 -> int32 product, rescaled by the
row and column scales. JAX computes that product with ``lax.dot_general``,
outside any Pallas kernel, so on the card it is ``torch._int_mm`` (the int8
tensor cores through cuBLASLt), and its plain version the exact int32 sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .device import H100, Card, card

__all__ = [
    "DESIGNS", "H100", "TILED_MIN_ROWS", "Card", "Plan", "W8A8_ALIGN", "W8A8_MIN_ROWS", "card",
    "int8_matmul", "int8_matmul_reference", "int8_matmul_w8a8", "int8_mm", "int8_mm_reference",
    "occupancy", "plan", "plan_for", "prepare_w8a8", "quantize_rows_int8", "ragged_plan", "split_k",
    "split_k_plan", "tiled_plan", "wide_plan",
]

_BN, _BM, _BK = 128, 64, 32  # the split-K kernel's tile sizes (csrc/int8_matmul.cu)
_MIN_K_TILES = 8  # 256 of depth per block at least
_RESERVED = 1024  # shared memory a Hopper SM keeps aside per resident block
# the tiled kernel's tile (csrc/int8_matmul_tiled.cu): columns, rows of x,
# depth per stage, ring stages; and its shared memory: 1024 bytes of
# alignment slack and the mbarriers, then per stage x's tile, the weight's
# int8 tile and the words that cover an unaligned one
_TN, _TM, _TK, _TILED_STAGES = 128, 256, 64, 4
_TILED_STAGE = _TM * _TK * 2 + _TK * _TN + _TK * 144
_TILED_FIXED = 1024 + 1024
# rows of x from which plan() takes the tiled design: the fewest of
# int8_matmul_probe.py's sweep (B = 128 ... 8256) at which it was no slower
# than the plan below at every Llama-medium width; at 1024 rows it lost at
# o (17.77-17.89 us against the wide design's 16.90-17.16), at 2048 it won
# at all five (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
TILED_MIN_ROWS = 2048
# the ragged kernel (csrc/int8_matmul_ragged.cu): its column tiles (16 U
# columns, U = 8 or 9: the kernel's two instantiations), the stages of each
# warp's ring, and its shared memory: 1024 bytes of alignment slack and a
# header (x's mbarriers, the stripe's scale), two 32 KB buffers of x, a bf16
# B tile for each of the 4 warpgroups (N = 16 (U // 2) + 8 (U % 2) rows of
# 128 bytes), then per warp (16) a ring of its 16 weight rows' covering
# words (16 (W + 1) bytes a row, W = U / 2 rounded up) and two stages of the
# rows shifted into place (pitch 16 (W | 1)); the tile's two f32 images
# (pitch 16 U + 4 or + 20 floats) reuse all of it
_RAGGED_WIDTHS = (128, 144)
_RAGGED_STAGES = 3
_RAGGED_FIXED = 1024 + 1024
_RAGGED_X = 2 * 4 * 64 * 64 * 2


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
           "wide": ("int8_matmul_wide", "w8a16_wide_kernel"),
           "tiled": ("int8_matmul_tiled", "w8a16_tiled_kernel"),
           "ragged": ("int8_matmul_ragged", "w8a16_ragged_kernel")}


class Plan(NamedTuple):
    """How one call is launched.

    ``design``: ``"split_k"`` (``csrc/int8_matmul.cu``: a block per 128
    columns and ``k_chunk`` of depth, the ``split`` partial sums of a column
    added by f32 atomics into a zeroed output, 32-deep tiles prefetched into
    registers) or ``"wide"`` (``csrc/int8_matmul_wide.cu``: a block per 128
    columns over a 1/``split`` share of D, each block's rows pushed to the
    block of the cluster that stores them; x's share, ``k_chunk`` deep at
    most, held whole in shared memory, the weight's 64-deep tiles through a
    ring of ``stages``; x's and w's rows 16-byte aligned) or ``"ragged"``
    (``csrc/int8_matmul_ragged.cu``: a block per ``n`` = 128 or 144 columns
    over all of D, ``split`` 1; x in 256-deep chunks, each warp's weight rows
    as the aligned words that cover them through a ring of ``stages`` of its
    own; x's rows 16-byte aligned, w's at any offset). The three take 64
    rows of x per block. ``"tiled"`` (``csrc/int8_matmul_tiled.cu``): a tile
    of ``n`` columns x 256 rows over all of D (``k_chunk``), wgmma with the
    widened weight in registers, x's ``kt``-deep tiles by TMA through a
    ring of ``stages``; persistent blocks, one an SM, walk the tiles."""

    design: str
    n: int
    split: int
    kt: int
    stages: int
    k_chunk: int

    @property
    def rows(self) -> int:
        """Rows of x per block (the tiled design: per tile)."""
        return _TM if self.design == "tiled" else 64

    @property
    def source(self) -> str:
        """The kernel's source: ``csrc/<source>.cu``."""
        return DESIGNS[self.design][0]

    def grid(self, b: int, d: int, f: int) -> tuple[int, int, int]:
        """The launch's grid; in the wide design a cluster is ``split``
        blocks along x (the ragged design's: the same, unsplit), in the
        split-K design D's splits are grid y. The
        tiled design's is its tiles (column tiles, row tiles), which
        min(tiles, SMs) persistent blocks walk in :meth:`blocks`' order."""
        if self.design == "tiled":
            return -(-f // self.n), -(-b // self.rows), 1
        if self.design == "split_k":
            return -(-f // self.n), -(-d // self.k_chunk), -(-b // 64)
        return -(-f // self.n) * self.split, -(-b // 64), 1

    def blocks(self, b: int, d: int, f: int) -> list[tuple[int, int, int, int]]:
        """Each block's (first row, first column, first depth, end depth),
        as the kernel derives them from its block index; its columns are
        [first column, first column + ``n``) within F, its rows [first row,
        first row + :attr:`rows`) within B. The tiled design's entries are
        its tiles, columns fastest, in the order its blocks take them."""
        if self.design == "tiled":
            return [(m0, n0, 0, d) for m0 in range(0, b, self.rows) for n0 in range(0, f, self.n)]
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
        if self.design == "tiled":
            return _TILED_FIXED + self.stages * _TILED_STAGE
        if self.design == "ragged":
            u = self.n // 16
            wu = u // 2 + u % 2  # the 16-column units of a column group's rows
            b_tiles = 4 * (16 * (u // 2) + 8 * (u % 2)) * 128
            rings = 16 * (self.stages * 16 * 16 * (wu + 1) + 2 * 16 * 16 * (wu | 1))
            images = 2 * 64 * (16 * u + (20 if u % 2 else 4)) * 4
            return _RAGGED_FIXED + max(_RAGGED_X + b_tiles + rings, images)
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


def ragged_plan(b: int, d: int, f: int, card: Card) -> Plan | None:
    """The ragged design's plan, for an x read 16 bytes at a time and a
    weight whose rows lie at any offset: the fewer columns a block (128,
    then 144) whose grid of 64-row stripes runs in one wave at one block per
    SM (the widest where none does), all of D a block (``split`` 1), a ring
    of 3 stages a warp (the most 144 columns fit). None where its shared
    memory does not fit a block. At the head (B 1-1024)
    int8_matmul_probe.py measured it faster than split-K at every B, and 144
    columns faster than 128 (two waves) (NVIDIA H100 80GB HBM3, 700 W)."""
    for n in _RAGGED_WIDTHS:
        if -(-f // n) * -(-b // 64) <= card.sms:
            break
    p = Plan("ragged", n, 1, 64, _RAGGED_STAGES, -(-d // 64) * 64)
    return p if p.smem() <= card.smem_block else None


def tiled_plan(b: int, d: int, f: int) -> Plan:
    """The tiled design's plan: 128-column tiles over all of D, the
    kernel's ring of 4 stages (a constant of the kernel)."""
    return Plan("tiled", _TN, 1, _TK, _TILED_STAGES, -(-d // _TK) * _TK)


@functools.lru_cache(maxsize=None)
def plan(b: int, d: int, f: int, card: Card, x_aligned: bool, w_aligned: bool) -> Plan:
    """The design and its parameters for one call, from the shape, the card
    and the operands' alignment (``x_aligned``: x's base and its row pitch,
    2 D bytes, are multiples of 16 bytes; ``w_aligned``: w's base and its
    row pitch, F bytes, are). The tiled design at ``TILED_MIN_ROWS`` rows or
    more where its shared memory fits (any alignment: it shifts an
    unaligned weight's rows into place, and the wrapper pads an unaligned
    x); below, where x's rows are aligned, the wide design where w's are
    too and its shares fit, the ragged design where w's are not (the decode
    lm head's F = 17385); the split-K design elsewhere (x's rows unaligned,
    or an aligned depth whose share does not fit, D = 20000)."""
    tiled = tiled_plan(b, d, f)
    if b >= TILED_MIN_ROWS and tiled.smem() <= card.smem_block:
        return tiled
    if x_aligned:
        below = wide_plan(b, d, f, card) if w_aligned else ragged_plan(b, d, f, card)
        if below is not None:
            return below
    return split_k_plan(b, d, f, card.sms)


def plan_for(x: torch.Tensor, w_int8: torch.Tensor) -> Plan:
    """The plan of a call on x (B, D) bf16 and w_int8 (D, F), both
    contiguous and on one CUDA device, as :func:`int8_matmul` launches it."""
    (b, d), f = x.shape, w_int8.shape[1]
    return plan(b, d, f, card(x.device), x.data_ptr() % 16 == 0 and (2 * d) % 16 == 0,
                w_int8.data_ptr() % 16 == 0 and f % 16 == 0)


def occupancy(p: Plan, b: int, d: int, f: int) -> dict:
    """A wide plan's dynamic shared memory per block, resident blocks per
    SM and clusters of its grid that run at once on the current card, as
    the kernel reckons them; a ragged or tiled plan's shared memory and
    blocks per SM."""
    smem, per_sm, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if p.design == "tiled":
        err = _build.load(p.source).vqt_int8_matmul_tiled_occupancy(
            ctypes.byref(smem), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"int8_matmul occupancy query failed: CUDA error {err}")
        return {"dynamic_smem": smem.value, "blocks_per_sm": per_sm.value}
    if p.design == "ragged":
        err = _build.load(p.source).vqt_int8_matmul_ragged_occupancy(
            p.n, p.stages, ctypes.byref(smem), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"int8_matmul occupancy query failed: CUDA error {err}")
        return {"dynamic_smem": smem.value, "blocks_per_sm": per_sm.value}
    if p.design != "wide":
        raise ValueError(f"occupancy: a wide, ragged or tiled plan, got {p.design!r}")
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
    elif p.design == "ragged":
        out = torch.empty((b, f), dtype=torch.float32, device=x2.device)
        err = _entry(p.source, "vqt_int8_matmul_ragged", 5)(
            *ptrs, out.data_ptr(), b, d, f, p.n, p.stages, stream)
    elif p.design == "tiled":
        # TMA reads x's rows: a base or a pitch (2 D bytes) off 16 bytes
        # takes a zero-padded copy
        ldx = -(-d // 8) * 8
        if x2.data_ptr() % 16 or ldx != d:
            xp = torch.zeros((b, ldx), dtype=torch.bfloat16, device=x2.device)
            xp[:, :d] = x2
            x2 = xp
        out = torch.empty((b, f), dtype=torch.float32, device=x2.device)
        err = _entry(p.source, "vqt_int8_matmul_tiled", 5)(
            x2.data_ptr(), *ptrs[1:], out.data_ptr(), b, d, f, ldx, card(x2.device).sms, stream)
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


# -- dynamic-activation INT8 (w8a8) ---------------------------------------------

# torch._int_mm on CUDA takes more than 16 rows, and a depth and a width
# that are multiples of 8; the weight's width is padded to 16 (cuBLASLt
# refused a (17, 64) x (64, 40) product on the H100)
W8A8_MIN_ROWS, W8A8_ALIGN = 17, 16


def quantize_rows_int8(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D) -> (int8 (B, D), f32 scales (B, 1)): per row ``xs = max(max|x|
    / 127, 1e-8)`` and ``clip(round(x / xs), -127, 127)``, rounding half to
    even, in f32."""
    x2 = x2.float()
    xs = torch.clamp_min(x2.abs().amax(dim=1, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8), xs


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: int8 (M, K) x int8 (K, N) -> the exact int32 sums,
    computed in float64 (every partial sum, at most 127² K, is an integer
    below 2^53, so exact in any order)."""
    if a.is_cuda:
        int8_mm_reference.cuda_calls += 1
    return torch.matmul(a.double(), b.double()).to(torch.int32)


int8_mm_reference.cuda_calls = 0


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N). CUDA tensors go through
    ``torch._int_mm`` (the int8 tensor cores, through cuBLASLt), their rows
    padded with zeros to ``W8A8_MIN_ROWS`` where fewer; K and N must be
    multiples of 8 (:func:`prepare_w8a8` pads a weight's N and lays it out
    once). CPU tensors take :func:`int8_mm_reference`."""
    if not a.is_cuda:
        return int8_mm_reference(a, b)
    m = a.shape[0]
    if m < W8A8_MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, W8A8_MIN_ROWS - m))
    out = torch._int_mm(a.contiguous(), b)
    int8_mm.calls += 1
    return out[:m]


int8_mm.calls = 0  # torch._int_mm calls


def prepare_w8a8(w_int8: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A weight (D, F) and its scale (F,) as :func:`int8_matmul_w8a8` takes
    them: F padded by zero columns to a multiple of ``W8A8_ALIGN``, and the
    weight stored column-major (a (D, F) view of its contiguous transpose),
    the layout cuBLASLt's int8 kernels read fastest (3.7-10.8x row-major's
    time at the serving shapes on the H100). Done once per weight, never
    per call; :func:`int8_matmul_w8a8` slices the output back to F."""
    pad = -w_int8.shape[1] % W8A8_ALIGN
    if pad:
        w_int8 = torch.nn.functional.pad(w_int8, (0, pad))
        scale = torch.nn.functional.pad(scale, (0, pad))
    return w_int8.t().contiguous().t(), scale


def int8_matmul_w8a8(
    x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor, features: int | None = None
) -> torch.Tensor:
    """Dynamic-activation INT8 matmul (``vector_quantization_tpu/ops/
    int8_matmul.py`` ``int8_matmul_w8a8``): x (..., D) quantised per row by
    :func:`quantize_rows_int8`, an int8 x int8 -> int32 product
    (:func:`int8_mm`), then ``acc.float() * xs * scale`` in that order ->
    (..., F) float32. ``features``: the output's F where ``w_int8`` and
    ``scale`` carry :func:`prepare_w8a8`'s padding."""
    lead = x.shape[:-1]
    xq, xs = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
    out = int8_mm(xq, w_int8).float() * xs * scale
    if features is not None and features != out.shape[1]:
        out = out[:, :features]
    return out.reshape(*lead, -1)
