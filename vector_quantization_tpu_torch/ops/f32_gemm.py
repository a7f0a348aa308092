"""f32 matrix products on the tensor cores at f32 accuracy: GPT-2's dense
layers and its tied head, and every projection of the DeepSeek-V3 prior
(``models/transformers/deepseek_v3.py``), its experts' ragged groups of
rows included.

``product(x (..., K), w, bias=None, transposed=False, name=...)`` is
``x @ w (+ bias)`` for ``w`` (K, N), or ``x @ w.T`` for ``w`` (N, K) where
``transposed``; ``dense(x, kernel (K, N), bias (N,))`` is ``x @ kernel +
bias`` and ``tied_head(h (..., C), wte (V, C))`` is ``h @ wte.T``, both in
the range ``gpt2.gemm``. Where the call is
f32 on a CUDA device with at least ``MIN_ROWS`` rows and K and N multiples
of 4, it runs through :class:`Product`, an autograd function whose forward
and both backward products go through the hand-written Hopper kernel
(``csrc/f32_gemm.cu``): each f32 operand split into two TF32 parts, three
TF32 products on ``wgmma`` with f32 sums, promoted into an f32 accumulator
every 128 of depth. Elsewhere (the decode step's 1-64 rows, a bf16 GPT-2,
CPU tensors) the call is ``torch.matmul`` as before: the plain version.
The JAX package leaves these products to XLA; no TPU kernel stands behind
them.

:func:`matmul` is the product itself: ``a (M, K) @ b (K, N) (+ bias)`` for
2-D operands that are each contiguous or the transpose of a contiguous
tensor (a weight gradient's ``x.T``). The kernel reads one operand (A) as
it lies and the other (B) as TF32 parts that a prologue launch writes
K-major into a workspace; :func:`plan` makes B the smaller side (computing
``(b.T @ a.T).T`` and storing it transposed where ``a`` is less than half
of ``b``) and splits the sum over K across blocks where the output's tiles
do not fill the card. Every product of :func:`product` runs inside the
profiler range its caller names (``utils/debug.py`` ``span``: only while a
profiler records; ``gpt2.gemm`` for :func:`dense` and :func:`tied_head`):
the forward, whether the kernel or ``torch.matmul`` computes it, and
:class:`Product`'s two backward products. (``torch.matmul``'s own backward
runs on autograd's engine outside it.) ``matmul.launches`` counts the
product kernel's launches, ``matmul.split_launches`` the prologue's.
:func:`matmul_reference` is the plain product that tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.debug import span
from . import _build
from .device import card

__all__ = ["MIN_ROWS", "RANGE", "GemmPlan", "Product", "dense", "matmul", "matmul_reference", "plan",
           "product", "takes_kernel", "tied_head"]

# the range of GPT-2's products (the benchmark's gpt2_gemm_ms.train reads it)
RANGE = "gpt2.gemm"

# the kernel's tile (csrc/f32_gemm.cu): rows and columns of C, depth per stage
_BM, _BN, _BK = 128, 128, 32
# rows from which a call takes the kernel: gemm_probe.py --sweeps, the four
# dense widths' forwards at 128 ... 8192 rows against torch.mm (NVIDIA H100
# 80GB HBM3, 700 W): at 128 rows the kernel lost at 1024 -> 1024 (23.4-25.0 us
# against 17.0-19.8), at 256 it won there by 4%, at 512 by 23% or more at
# every width (PERF.md)
MIN_ROWS = 512
# what the split-K planner assumes of one SM and of the card's memory: the
# three passes' TF32 rate it reaches, and the bytes a second it moves
_SM_FLOPS = 2.0e12
_HBM = 2.5e12
_MAX_SPLITS = 16
_MIN_SPLIT_DEPTH = 256


class GemmPlan(NamedTuple):
    """How one product ``a (M, K) @ b (K, N)`` is launched."""

    swap: bool  # C.T = b.T @ a.T: a is split (B), b read as it lies (A), C stored transposed
    splits: int  # parts of the sum over K, each on its own tiles
    k_per_split: int  # depth of each part (a multiple of 32)
    tiles: int  # 128 x 128 tiles of C, all parts
    blocks: int  # persistent blocks: one an SM


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int) -> GemmPlan:
    """The launch for ``(M, K) @ (K, N)`` on a card of ``sms`` SMs.

    B, the operand the prologue splits, is ``b`` unless ``a`` is less than
    half its size. The sum over K is split in the number of parts that
    minimises a model of the call's time: whole waves of tiles at
    ``_SM_FLOPS`` an SM, plus the parts' traffic (each written and read
    once, the sum written) at ``_HBM``; at least ``_MIN_SPLIT_DEPTH`` deep
    each, the fewest parts among equals. Deterministic: from the shapes and
    the card only."""
    swap = 2 * m < n
    rows, cols = (n, m) if swap else (m, n)
    tiles = -(-rows // _BM) * -(-cols // _BN)
    best = None
    for s in range(1, _MAX_SPLITS + 1):
        kps = -(-(-(-k // s)) // _BK) * _BK
        if -(-k // kps) != s or (s > 1 and kps < _MIN_SPLIT_DEPTH):
            continue
        waves = -(-tiles * s // sms)
        t = waves * kps * 6 * _BM * _BN / _SM_FLOPS
        if s > 1:
            t += (2 * s + 1) * m * n * 4 / _HBM
        if best is None or t < best[0] * (1 - 1e-9):
            best = (t, s, kps)
    _, splits, kps = best
    return GemmPlan(swap, splits, kps, tiles * splits, min(tiles * splits, sms))


def _bind(lib: ctypes.CDLL):
    """The prologue's and the product's C entries of a built
    ``csrc/f32_gemm.cu``, typed."""
    split, gemm = lib.vqt_f32_split, lib.vqt_f32_gemm
    if gemm.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        split.restype = gemm.restype = i
        split.argtypes = [p, i, i, p, p, i, i, i, p]
        gemm.argtypes = [p, i, i, p, p, i, p, p, i, i, ll, i, i, i, i, i, i, p]
    return split, gemm


def _functions():
    return _bind(_build.load("f32_gemm"))


def _as_read(t: torch.Tensor) -> tuple[torch.Tensor, bool, int]:
    """(t', transposed, pitch): t (rows, cols) as the kernel reads it, rows
    ``pitch`` elements apart (or, transposed, columns), 16-byte aligned;
    where ``t`` lies otherwise (an expanded gradient, whose strides are 0,
    over an expert's ragged number of rows, say), a copy whose rows are
    padded to a multiple of 4 elements."""
    rows, cols = t.shape
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.stride(0) >= cols and t.data_ptr() % 16 == 0:
        return t, False, t.stride(0)
    if t.stride(0) == 1 and t.stride(1) % 4 == 0 and t.stride(1) >= rows and t.data_ptr() % 16 == 0:
        return t, True, t.stride(1)
    pitch = -(-cols // 4) * 4
    copy = torch.empty((rows, pitch), dtype=t.dtype, device=t.device)[:, :cols]
    copy.copy_(t)
    return copy, False, pitch


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``a (M, K) @ b (K, N) (+ bias (N,))`` in f32 through the kernel (two
    launches: the prologue, then the product; a sum of the parts where the
    plan splits K)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"f32 matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or not (a.is_cuda and b.device == a.device):
        raise ValueError("f32 matmul: a and b must be float32 on one CUDA device")
    (m, k), n = a.shape, b.shape[1]
    if min(m, k, n) < 1 or max(m, k, n) >= 2**31 - _BM:
        raise ValueError(f"f32 matmul: sizes M={m}, K={k}, N={n} outside [1, 2^31)")
    if bias is not None:
        bias = bias.contiguous()
        if bias.shape != (n,) or bias.dtype != torch.float32 or bias.device != a.device:
            raise ValueError(f"f32 matmul: bias must be ({n},) float32 on the operands' device")
    p = plan(m, k, n, card(a.device).sms)
    # C'(i, j) = sum_r A(i, r) B(j, r): C' = C (A = a, B = b.T) or C.T (A = b.T, B = a)
    A, B = (b.t(), a) if p.swap else (a, b.t())
    rows, cols = B.shape[0], k
    A, a_trans, lda = _as_read(A)
    B, b_trans, ldb = _as_read(B)
    ldd = -(-cols // 4) * 4
    parts = torch.empty((2, rows, ldd), dtype=torch.float32, device=a.device)
    split, gemm = _functions()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = split(B.data_ptr(), ldb, int(b_trans), parts[0].data_ptr(), parts[1].data_ptr(), ldd,
                rows, cols, stream)
    if err != 0:
        raise RuntimeError(f"f32 matmul: prologue launch failed: CUDA error {err}")
    matmul.split_launches += 1
    out = torch.empty((p.splits, m, n) if p.splits > 1 else (m, n), dtype=torch.float32, device=a.device)
    err = gemm(A.data_ptr(), int(a_trans), lda, parts[0].data_ptr(), parts[1].data_ptr(), ldd,
               None if bias is None else bias.data_ptr(), out.data_ptr(), n, int(p.swap), m * n,
               A.shape[0], rows, k, p.k_per_split, p.splits, p.blocks, stream)
    if err != 0:
        raise RuntimeError(f"f32 matmul: kernel launch failed: CUDA error {err}")
    matmul.launches += 1
    return out.sum(0) if p.splits > 1 else out


matmul.launches = 0
matmul.split_launches = 0


def matmul_reference(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``torch.matmul`` (+ bias), as GPT-2 computed before."""
    y = torch.matmul(a, b)
    return y if bias is None else y + bias


class Product(torch.autograd.Function):
    """``x (M, K) @ w (+ bias)`` with ``w`` (K, N), or ``x @ w.T`` with ``w``
    (N, K) where ``transposed``, through the kernel; its backward takes the
    input gradient and the weight gradient by the same kernel, inside the
    range ``name`` (``bias``'s gradient is the rows' sum)."""

    @staticmethod
    def forward(ctx, x, w, bias, transposed, name=RANGE):
        ctx.save_for_backward(x, w)
        ctx.transposed, ctx.has_bias, ctx.name = transposed, bias is not None, name
        return matmul(x, w.t() if transposed else w, bias)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        with span(ctx.name):
            if ctx.needs_input_grad[0]:
                gx = matmul(gy, w if ctx.transposed else w.t())
            if ctx.needs_input_grad[1]:
                gw = matmul(gy.t(), x) if ctx.transposed else matmul(x.t(), gy)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(0)
        return gx, gw, gb, None, None


def takes_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """The dispatch: f32 operands on a CUDA device, at least ``MIN_ROWS``
    rows of ``x`` (..., K), K and the other side of ``w`` multiples of 4
    (16-byte rows for TMA)."""
    rows = x.numel() // max(x.shape[-1], 1)
    return (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32 and rows >= MIN_ROWS
            and w.shape[0] % 4 == 0 and w.shape[1] % 4 == 0)


def product(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *, transposed: bool = False,
            name: str = RANGE) -> torch.Tensor:
    """``x (..., K) @ w (K, N) (+ bias (N,))``, or ``x @ w.T`` for ``w`` (N,
    K) where ``transposed``, inside the range ``name``: through
    :class:`Product` where :func:`takes_kernel`, else ``torch.matmul``."""
    n = w.shape[0] if transposed else w.shape[1]
    with span(name):
        if takes_kernel(x, w):
            y = Product.apply(x.reshape(-1, x.shape[-1]), w, bias, transposed, name)
            return y.reshape(*x.shape[:-1], n)
        y = torch.matmul(x, w.t() if transposed else w)
    return y if bias is None else y + bias


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ kernel (K, N) + bias`` (GPT-2's ``_Dense``)."""
    return product(x, kernel, bias)


def tied_head(h: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
    """``h (..., C) @ wte.T`` for ``wte`` (V, C) (GPT-2's tied head)."""
    return product(h, wte, transposed=True)
