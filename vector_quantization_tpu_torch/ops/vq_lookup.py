"""Nearest-codebook lookup: the tokenizer's encode step.

``nearest_codes(x (N, D), codebook (K, D), metric="l2") -> (N,) int32``:
for each row, the argmin over codes of ``0.5·‖e_k‖² − x·e_k`` (the argmin of
``‖x − e_k‖²``), products and sums in f32, an exact tie to the lowest index;
``metric="cosine"`` normalises both sides first. It is the function of
``vector_quantization_tpu/ops/vq_lookup.py`` ``nearest_codes`` (its Pallas
kernel ``_nearest_codes_pallas`` and its XLA path).

A CUDA tensor goes through the hand-written Hopper kernel
(``csrc/vq_lookup.cu``) at every code width D; a CPU tensor through the
plain version :func:`nearest_codes_reference`. The device alone decides:
the JAX package's choice between Pallas and XLA by code width was measured
on a TPU and is not carried over. ``‖e‖²/2`` is computed in PyTorch before
the launch, as the JAX package computes it outside its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .distances import normalize

__all__ = [
    "NEAR_TIE_REL_TOL",
    "compare_codes",
    "k_tiles_per_split",
    "lookup_scores",
    "nearest_codes",
    "nearest_codes_reference",
    "vq_quantize",
]

_BN, _BK = 128, 128  # the kernel's row and code tiles (csrc/vq_lookup.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# two lookups may disagree only where the plain scores of both codes lie
# within this fraction of max|score| of the row's best: f32 sums taken in
# another order (the kernel's FMA chain, a BLAS dot, XLA's ‖x‖²−2x·e+‖e‖²)
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


def k_tiles_per_split(n: int, k: int, num_sms: int) -> int:
    """Codebook tiles of 128 codes per block: split the codebook across
    blocks until the grid (row tiles x splits) holds about 16 blocks per
    SM, so that 128 row tiles (N = 16384) still fill 132 SMs with a short
    tail wave."""
    row_tiles = -(-n // _BN)
    k_tiles = -(-k // _BK)
    splits = min(k_tiles, max(1, -(-16 * num_sms // row_tiles)))
    return -(-k_tiles // splits)


def _kernel():
    fn = _build.load("vq_lookup").vqt_nearest_codes
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, i, p, i, p, p, p, i, i, i, i, p]
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
    if min(n, k, d) < 1 or max(n, k, d) >= 2**31:
        raise ValueError(f"nearest_codes: sizes N={n}, K={k}, D={d} outside [1, 2^31)")
    x = x.contiguous()
    codebook = codebook.contiguous()
    esq = _half_sq_norms(codebook)
    keys = torch.empty((n,), dtype=torch.int64, device=x.device)
    codes = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = _kernel()(
        x.data_ptr(), _DTYPE_CODE[x.dtype], codebook.data_ptr(), _DTYPE_CODE[codebook.dtype],
        esq.data_ptr(), keys.data_ptr(), codes.data_ptr(), n, k, d,
        k_tiles_per_split(n, k, torch.cuda.get_device_properties(x.device).multi_processor_count),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nearest_codes kernel launch failed: CUDA error {err}")
    nearest_codes.launches += 1
    return codes


def nearest_codes(x: torch.Tensor, codebook: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Nearest-codebook assignment. x: (N, D), codebook: (K, D) -> (N,) int32.

    CUDA tensors launch the Hopper kernel (and raise if it cannot run); CPU
    tensors take :func:`nearest_codes_reference`.
    """
    if not x.is_cuda:
        return nearest_codes_reference(x, codebook, metric)
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
