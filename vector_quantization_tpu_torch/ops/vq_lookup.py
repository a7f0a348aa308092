"""Nearest-codebook lookup: the tokenizer's encode step.

``nearest_codes(x (N, D), codebook (K, D), metric="l2") -> (N,) int32``:
for each row, the argmin over codes of ``0.5·‖e_k‖² − x·e_k`` (the argmin of
``‖x − e_k‖²``), an exact tie to the lowest index; ``metric="cosine"``
normalises both sides first. It is the function of
``vector_quantization_tpu/ops/vq_lookup.py`` ``nearest_codes`` (its Pallas
kernel ``_nearest_codes_pallas`` and its XLA path).

A CUDA tensor goes through the hand-written Hopper kernel
(``csrc/vq_lookup.cu``) at every code width D: products on the tensor cores
in TF32, an f32 operand split into two TF32 parts (three passes for f32 x
f32, one for bf16 x bf16), f32 sums, the argmin taken on the accumulators.
Two launches per call: a prologue that writes ``‖e‖²/2`` and the split
codebook into a workspace, then the lookup. :func:`plan` sizes the launch
from the shapes, the card's SM count and a block's shared memory. A CPU
tensor goes through the plain version :func:`nearest_codes_reference`. The
device alone decides: the JAX package's choice between Pallas and XLA by
code width was measured on a TPU and is not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.debug import span
from . import _build
from .device import Card, card
from .distances import normalize

__all__ = [
    "NEAR_TIE_REL_TOL",
    "LookupPlan",
    "compare_codes",
    "lookup_scores",
    "nearest_codes",
    "nearest_codes_reference",
    "blocks_per_sm",
    "plan",
    "vq_quantize",
]

# the kernel's shape (csrc/vq_lookup.cu): rows per block (two warpgroups),
# codes per codebook tile (the wgmma's N), 8-wide k-steps per ring stage
# (D > 8), ring stages (D <= 8, D > 8), and the bytes of the ring's barriers
_BM, _BN, _KC, _STAGES_REG, _STAGES, _BAR = 128, 128, 2, 8, 4, 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# two lookups may disagree only where the plain scores of both codes lie
# within this fraction of max|score| of the row's best: f32 sums taken in
# another order or in parts (the kernel's TF32 splits, a BLAS dot, XLA's
# ‖x‖²−2x·e+‖e‖²)
NEAR_TIE_REL_TOL = 1e-5


def _prepare(x: torch.Tensor, codebook: torch.Tensor, metric: str):
    x, codebook = x.detach(), codebook.detach()
    if metric == "cosine":
        return normalize(x), normalize(codebook)
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    return x, codebook


def _half_sq_norms(codebook: torch.Tensor) -> torch.Tensor:
    e = codebook.float()
    return 0.5 * torch.sum(e * e, dim=1)


def lookup_scores(x: torch.Tensor, codebook: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(N, K) f32 scores ``0.5·‖e‖² − x·e`` the lookup minimises (the N×K
    matrix: for the plain version and for comparisons only)."""
    x, codebook = _prepare(x, codebook, metric)
    return _half_sq_norms(codebook)[None, :] - x.float() @ codebook.float().T


def nearest_codes_reference(
    x: torch.Tensor, codebook: torch.Tensor, metric: str = "l2"
) -> torch.Tensor:
    """Plain version: the full score matrix, then the first argmin."""
    if x.is_cuda:
        nearest_codes_reference.cuda_calls += 1
    return torch.argmin(lookup_scores(x, codebook, metric), dim=1).to(torch.int32)


nearest_codes_reference.cuda_calls = 0


class LookupPlan(NamedTuple):
    """How one call is launched (mirrors ``csrc/vq_lookup.cu``)."""

    k_steps: int  # D padded to a multiple of 8, over 8
    reg_x: bool  # one k-step: each warp holds its x fragments in registers
    x_resident: bool  # the block's x tile stays in shared memory for the whole loop
    row_tiles: int  # blocks along N (128 rows each)
    splits: int  # blocks along the codebook
    tiles_per_split: int  # 128-code tiles each of those blocks walks
    smem_bytes: int  # dynamic shared memory per block
    workspace_bytes: int  # keys, counters, esq, the split codebook (and x's chunks)


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def _pitch(dims: int, size: int) -> int:
    """Shared-memory row pitch in elements: 4 mod 8 words (conflict-free
    mma fragment reads)."""
    words = dims * size // 4
    return (words + (4 - words) % 8) * 4 // size


@functools.lru_cache(maxsize=None)
def plan(n: int, k: int, d: int, x_bf16: bool, e_bf16: bool, card: Card) -> LookupPlan:
    """The launch for (N, K, D) and the operands' types on ``card`` (its SM
    count, and the shared memory one block may take).

    The codebook is split across blocks so that the grid (row tiles x
    splits) fills whole waves of the card's block slots best, the fewest
    splits among equals: at N = 16384 every 128-row tile then runs on its
    own slot in one wave. Deterministic: from the shapes and the card
    only, never from timing."""
    ks = -(-d // 8)
    reg = ks == 1
    k_tiles, row_tiles = -(-k // _BN), -(-n // _BM)
    ew, xsize = (2 if e_bf16 else 4), (2 if x_bf16 else 4)
    kc = 1 if reg else _KC  # k-steps per ring stage
    ksp = -(-ks // kc) * kc  # whole chunks: the workspace's k-steps
    e_stage = kc * (2 if ew == 4 else 1) * _BN * 8 * 4  # B tiles (hi, lo) of one (tile, chunk)
    x_chunk = _BM * _pitch(8 * kc, xsize) * xsize
    x_tile = _BM * _pitch(8 * ksp, xsize) * xsize
    stages = _STAGES_REG if reg else _STAGES
    q_tile = _BN * 8 * 4  # esq as a B tile
    x_res = reg or _BAR + stages * (e_stage + q_tile) + x_tile <= card.smem_block
    stage = e_stage + q_tile + (0 if x_res else x_chunk)
    smem = _BAR + stages * stage + (x_tile if x_res and not reg else 0)
    slots = card.sms  # one block an SM: its ring takes most of the shared memory
    best = None
    for s in range(1, min(k_tiles, 4 * -(-slots // row_tiles)) + 1):
        per = -(-k_tiles // s)
        splits = -(-k_tiles // per)
        blocks = row_tiles * splits
        fill = blocks / (-(-blocks // slots) * slots)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, splits, per)
    _, splits, per = best
    kp = k_tiles * _BN
    workspace = (_round16(n * 8) + _round16(row_tiles * 4) + k_tiles * q_tile
                 + k_tiles * (ksp // kc) * e_stage + (0 if x_res else row_tiles * (ksp // kc) * x_chunk))
    return LookupPlan(ks, reg, x_res, row_tiles, splits, per, smem, workspace)


def blocks_per_sm(p: LookupPlan, x_bf16: bool, e_bf16: bool) -> int:
    """Resident blocks per SM of the lookup kernel launched under ``p`` with
    these operand types, from the CUDA occupancy calculator (builds the
    kernel; needs a GPU)."""
    fn = _build.load("vq_lookup").vqt_nearest_blocks_per_sm
    i = ctypes.c_int
    fn.restype, fn.argtypes = i, [i, i, i, i, ctypes.POINTER(i)]
    blocks = i(0)
    err = fn(int(x_bf16), int(e_bf16), int(p.reg_x), p.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"nearest_codes occupancy query failed: CUDA error {err}")
    return blocks.value


def _kernel():
    fn = _build.load("vq_lookup").vqt_nearest_codes
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, i, p, i, p, ctypes.c_longlong, p, i, i, i, i, i, p]
    return fn


def _launch(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"x must be (N, D) and codebook (K, D), got {tuple(x.shape)} / {tuple(codebook.shape)}"
        )
    if x.dtype not in _DTYPE_CODE or codebook.dtype not in _DTYPE_CODE:
        raise ValueError(f"x and codebook must be float32 or bfloat16, got {x.dtype}/{codebook.dtype}")
    if not codebook.is_cuda or codebook.device != x.device:
        raise ValueError("nearest_codes: x and codebook must be on one CUDA device")
    n, d = x.shape
    k = codebook.shape[0]
    if min(n, k, d) < 1 or max(n, k + _BN, d + 8) >= 2**31:
        raise ValueError(f"nearest_codes: sizes N={n}, K={k}, D={d} outside [1, 2^31)")
    x = x.contiguous()
    codebook = codebook.contiguous()
    p = plan(n, k, d, x.dtype == torch.bfloat16, codebook.dtype == torch.bfloat16, card(x.device))
    workspace = torch.empty((p.workspace_bytes,), dtype=torch.uint8, device=x.device)
    codes = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = _kernel()(
        x.data_ptr(), _DTYPE_CODE[x.dtype], codebook.data_ptr(), _DTYPE_CODE[codebook.dtype],
        workspace.data_ptr(), p.workspace_bytes, codes.data_ptr(), n, k, d,
        p.tiles_per_split, int(p.x_resident), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nearest_codes kernel launch failed: CUDA error {err}")
    nearest_codes.launches += 1
    return codes


def nearest_codes(x: torch.Tensor, codebook: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Nearest-codebook assignment. x: (N, D), codebook: (K, D) -> (N,) int32.

    CUDA tensors launch the Hopper kernel (and raise if it cannot run); CPU
    tensors take :func:`nearest_codes_reference`. The CUDA path runs inside
    the span ``vq.nearest_codes``; the function object stays this plain
    one, so a caller's replacement of the module attribute is what the
    quantizer calls.
    """
    if not x.is_cuda:
        return nearest_codes_reference(x, codebook, metric)
    with span("vq.nearest_codes"):
        return _launch(*_prepare(x, codebook, metric))


nearest_codes.launches = 0


def vq_quantize(
    x: torch.Tensor, codebook: torch.Tensor, metric: str = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign + gather: (codes (N,), z = codebook[codes] (N, D)). The gather
    is PyTorch indexing, differentiable with respect to the codebook; apply
    :func:`..ste.ste` on (z, x) for the straight-through forward."""
    codes = nearest_codes(x, codebook, metric)
    return codes, torch.index_select(codebook, 0, codes)


@torch.no_grad()
def compare_codes(
    x: torch.Tensor,
    codebook: torch.Tensor,
    got: torch.Tensor,
    want: torch.Tensor,
    metric: str = "l2",
    rel_tol: float = NEAR_TIE_REL_TOL,
) -> dict:
    """The one rule by which two lookups of the same (x, codebook) are held
    against each other. A row may differ only as a near-tie: the plain
    scores of both its codes lie within ``rel_tol·max|score|`` of the row's
    best. Returns the counts, the largest gap between the plain score of
    ``got``'s code and the row's best, and ``ok``."""
    scores = lookup_scores(x, codebook, metric)
    tol = rel_tol * float(scores.abs().max())
    best = scores.min(dim=1).values
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    if scores.shape[1] > 1:
        two = torch.topk(scores, 2, dim=1, largest=False).values
        near_ties = int(((two[:, 1] - two[:, 0]) <= tol).sum())
    else:
        near_ties = 0
    differ = got != want
    s_got = scores.gather(1, got[:, None])[:, 0]
    s_want = scores.gather(1, want[:, None])[:, 0]
    excused = differ & (s_got - best <= tol) & (s_want - best <= tol)
    return {
        "rows": int(got.numel()), "differ": int(differ.sum()), "excused": int(excused.sum()),
        "near_tie_rows": near_ties, "tol": tol, "max_score_gap": float((s_got - best).max()),
        "ok": bool(torch.equal(differ, excused)),
    }
