"""Causal flash attention for the training forward, with its backward.

``flash_attention(q, k, v) -> o``: q, k, v (B, T, H, Dh) post-RoPE, o of
the same shape and type, ``o = softmax(q kᵀ · Dh^-½, causal) v`` per
(batch, head). It is the function that
``vector_quantization_tpu/models/transformers/llama.py``
``_flash_train_attention`` computes through the Pallas TPU library kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``: a forward and two
backward kernels). ``flash_attention`` is a ``torch.autograd.Function``:
the forward keeps (q, k, v, o, lse) and the backward computes dq, dk, dv
from them. ``di = Σ o·dO``, which the library takes in XLA outside its
kernels, is computed on the card by K4-dq, which runs first and writes it
for K4-dkv; the plain version takes it with :func:`_di`.

A CUDA tensor goes through the hand-written Hopper kernels
(``csrc/flash_attention.cu``: K4-fwd, K4-dkv, K4-dq); a CPU tensor through
the plain versions :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`. The choice is made by the tensor's
device alone. The kernels take bfloat16 at Dh 32, 64 or 128 and raise on
anything else: an f32 CUDA input is refused, never cast. Every kernel
refuses (``RuntimeError``) a q, k, v or dO whose data does not start on a
16-byte boundary (they read them through TMA tensor maps), and K4-dq an o
that does not (it reads o 16 bytes at a time).

The arithmetic, in both versions: scores in f32 from the operands as given,
times the scale; the probabilities ``exp(s − m)`` summed in f32 and rounded
to the input type before the product with v; in the backward ``P = exp(s −
lse)``, ``dS = P ∘ (dP − di) · scale``, and P and dS rounded to the input
type before the products that take them, as the TPU kernels round them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "excess_over_bf16_step",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plan",
    "flash_bwd_dq",
    "flash_bwd_dq_plan",
    "flash_fwd_plan",
]

_HEAD_DIMS = (32, 64, 128)


def _causal(t: int, device) -> torch.Tensor:
    """(T, T) bool, True where the key column lies after the query row."""
    i = torch.arange(t, device=device)
    return i[None, :] > i[:, None]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, T, T) f32 scaled scores, future columns at -inf."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    return s.masked_fill(_causal(q.shape[1], q.device), float("-inf"))


def flash_attention_reference(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4-fwd: (o (B, T, H, Dh) in q's type, lse (B, H, T)
    f32)."""
    if q.is_cuda:
        flash_attention_reference.cuda_calls += 1
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(q.dtype).float() / l, v.float())
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


flash_attention_reference.cuda_calls = 0


def _di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Σ_d o·dO in f32, (B, H, T) contiguous."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do):
    """Plain version of K4-dkv and K4-dq: (dq, dk, dv) in q's type from the
    forward's residuals (o, lse) and the output's cotangent dO."""
    if q.is_cuda:
        flash_attention_bwd_reference.cuda_calls += 1
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k) - lse[..., None])  # (B, H, T, T), 0 above the diagonal
    dof = do.float()
    dv = torch.einsum("bhts,bthd->bshd", p.to(dt).float(), dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, v.float())
    ds = (p * (dp - _di(o, do)[..., None]) * scale).to(dt).float()
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


flash_attention_bwd_reference.cuda_calls = 0


def excess_over_bf16_step(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far two bf16 results differ beyond rounding: max over elements of
    ``max(0, |got − want| − one bf16 step at |want|)``, over
    ``max(1, max|want|)``. Two versions that each round an f32 result to
    bf16 once may land on neighbouring bf16 values; that step is no error."""
    want = want.float()
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    excess = ((got.float() - want).abs() - step).clamp(min=0)
    return float(excess.max()) / max(1.0, float(want.abs().max()))


def _check(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"flash attention takes (B, T, H, Dh), got {tuple(q.shape)}")
    for t in tensors[1:4]:
        if t.shape != q.shape:
            raise ValueError(f"q/k/v/dO shapes differ: {tuple(q.shape)} vs {tuple(t.shape)}")
    for t in tensors[:4]:
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"the CUDA flash attention kernels take bfloat16, got {t.dtype} "
                "(cast explicitly; the kernels never cast)"
            )
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim {_HEAD_DIMS}, got {q.shape[-1]}")
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash attention: all tensors must be on one CUDA device")


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p] * n_ptr + [i, i, i, i, ctypes.c_float, p]
    return fn


def _launch(fn, ptrs, q: torch.Tensor, what: str) -> None:
    b, t, h, dh = q.shape
    err = fn(*ptrs, b, t, h, dh, dh**-0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """K4-fwd: (o, lse). CUDA tensors launch the kernel (and raise if it
    cannot run); CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, t, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ptrs = [x.data_ptr() for x in (q, k, v, o, lse)]
    _launch(_fn("vqt_flash_fwd", 5), ptrs, q, "flash attention forward")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _plan(entry: str, t: int, dh: int) -> dict:
    fn = getattr(_build.load("flash_attention"), entry)
    i = ctypes.c_int
    fn.restype, fn.argtypes = i, [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    smem, blocks = i(), i()
    err = fn(t, dh, ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return {"dynamic_smem": smem.value, "blocks_per_sm": blocks.value}


def flash_fwd_plan(t: int, dh: int) -> dict:
    """K4-fwd's launch at length ``t`` and head dim ``dh`` on the current
    card: dynamic shared memory per block and resident blocks per SM."""
    return _plan("vqt_flash_fwd_plan", t, dh)


def flash_bwd_dkv_plan(t: int, dh: int) -> dict:
    """K4-dkv's launch at length ``t`` and head dim ``dh``, as
    :func:`flash_fwd_plan`."""
    return _plan("vqt_flash_bwd_dkv_plan", t, dh)


def flash_bwd_dq_plan(t: int, dh: int) -> dict:
    """K4-dq's launch at length ``t`` and head dim ``dh``, as
    :func:`flash_fwd_plan`."""
    return _plan("vqt_flash_bwd_dq_plan", t, dh)


def _bwd_inputs(q, k, v, do, *rows):
    """q, k, v, dO (bf16 (B, T, H, Dh)) and f32 (B, H, T) rows, contiguous."""
    _check(q, k, v, do, *rows)
    b, t, h, _ = q.shape
    for x in rows:
        if x.shape != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"lse and di must be float32 ({b}, {h}, {t})")
    return [x.contiguous() for x in (q, k, v, do, *rows)]


def flash_bwd_dkv(q, k, v, do, lse, di) -> tuple[torch.Tensor, torch.Tensor]:
    """K4-dkv on CUDA tensors: (dk, dv)."""
    ins = _bwd_inputs(q, k, v, do, lse, di)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    ptrs = [x.data_ptr() for x in (*ins, dk, dv)]
    _launch(_fn("vqt_flash_bwd_dkv", 8), ptrs, ins[0], "flash attention dK/dV")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, o, do, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """K4-dq on CUDA tensors: (dq, di), di = Σ_d o·dO (B, H, T) f32, which
    K4-dkv takes."""
    q, k, v, do, lse = _bwd_inputs(q, k, v, do, lse)
    _check(q, o)
    o = o.contiguous()
    b, t, h, _ = q.shape
    di = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, di, dq)]
    _launch(_fn("vqt_flash_bwd_dq", 8), ptrs, q, "flash attention dQ")
    flash_bwd_dq.launches += 1
    return dq, di


flash_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv): on CUDA, K4-dq (which also computes ``di``), then
    K4-dkv; on the CPU, the plain version."""
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, o, lse, do)
    dq, di = flash_bwd_dq(q, k, v, o, do, lse)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention with its backward; see the module docstring."""
    return _FlashAttention.apply(q, k, v)
