"""Weight-only INT8 matmul for the memory-bound AR decode step.

``int8_matmul(x (..., D), w_int8 (D, F), scale (F,)) -> (..., F) float32``:
x is cast to bf16, multiplied by the int8 weight converted to bf16 with f32
accumulation, and the per-output-channel scale is applied to the f32 sum
(the function of ``vector_quantization_tpu/ops/int8_matmul.py``
``int8_matmul``, both its Pallas and its XLA path).

A CUDA tensor goes through the hand-written Hopper kernel
(``csrc/int8_matmul.cu``); a CPU tensor through the plain version
:func:`int8_matmul_reference`, which repeats the kernel's arithmetic step by
step. The choice is made by the tensor's device alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_reference", "split_k"]

_BN, _BM, _BK = 128, 64, 32  # the kernel's tile sizes (csrc/int8_matmul.cu)
_MIN_K_TILES = 8  # 256 of depth per block at least
_sm_count: dict[int, int] = {}


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


def _num_sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _launch(x2: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
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
    k_chunk = split_k(b, d, f, _num_sms(x2.device))
    splits = math.ceil(d / k_chunk)
    # split partial sums are added atomically into a zeroed output
    out = (torch.zeros if splits > 1 else torch.empty)(
        (b, f), dtype=torch.float32, device=x2.device
    )
    fn = _build.load("int8_matmul").vqt_int8_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    err = fn(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, d, f, k_chunk, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


def int8_matmul(
    x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """(..., D) @ int8 (D, F) * scale (F,) -> (..., F) float32.

    CUDA tensors launch the Hopper kernel (and raise if it cannot run);
    CPU tensors take :func:`int8_matmul_reference`.
    """
    if not x.is_cuda:
        return int8_matmul_reference(x, w_int8, scale)
    lead = x.shape[:-1]
    out = _launch(x.reshape(-1, x.shape[-1]), w_int8, scale)
    return out.reshape(*lead, -1)


int8_matmul.launches = 0
