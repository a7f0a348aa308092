"""Fused (logits-free) softmax cross-entropy over a large vocabulary.

Port of ``vector_quantization_tpu/ops/fused_ce.py``: the AR trainer's
teacher-forced loss over V = 17385 at N = B·(T−1) rows without the (N, V)
logits. The forward walks the vocabulary in chunks with an online
logsumexp; the backward recomputes each chunk's logits from the saved
(x, w, lse). Products take bf16 operands with f32 sums and f32 results, as
the reference's ``preferred_element_type=f32`` dots do (a bf16 matmul that
returned bf16 logits would round them).

The JAX package computes this outside any Pallas kernel (XLA), so the
chunk products here are library matmuls, not a kernel of the port.
A ragged last chunk is sliced, not padded: the reference's padded columns
score -1e30 and add nothing to the sums.
"""

from __future__ import annotations

import torch

__all__ = ["f32_matmul", "fused_ce", "fused_next_token_ce"]


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result for bf16 operands: on CUDA
    the tensor-core product with ``out_dtype``; on the CPU f32 products of
    the bf16 values (exact) summed in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        n, v = x.shape[0], w.shape[1]
        xb = x.to(torch.bfloat16)
        targets = targets.long()
        m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tlog = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for c0 in range(0, v, chunk):
            logits = f32_matmul(xb, w[:, c0:c0 + chunk].to(torch.bfloat16))
            width = logits.shape[1]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            in_c = (targets >= c0) & (targets < c0 + width)
            idx = (targets - c0).clamp(0, width - 1)
            tlog = torch.where(in_c, logits.gather(1, idx[:, None])[:, 0], tlog)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return (lse - tlog).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        n, v = x.shape[0], w.shape[1]
        xb = x.to(torch.bfloat16)
        scale = g / n
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, v, ctx.chunk):
            wi = w[:, c0:c0 + ctx.chunk].to(torch.bfloat16)
            logits = f32_matmul(xb, wi)
            cols = torch.arange(c0, c0 + logits.shape[1], device=x.device)
            p = torch.exp(logits - lse[:, None])
            onehot = (targets[:, None] == cols[None, :]).float()
            dlog = ((p - onehot) * scale).to(torch.bfloat16)
            dx += f32_matmul(dlog, wi.T)
            dw[:, c0:c0 + ctx.chunk] = f32_matmul(xb.T, dlog)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def fused_ce(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, chunk: int = 2048):
    """Mean CE of softmax(x @ w) against integer ``targets``: x (N, D),
    w (D, V), targets (N,) in [0, V); a scalar, without the (N, V) logits."""
    return _FusedCE.apply(x, w, targets, chunk)


def fused_next_token_ce(
    hidden: torch.Tensor, w: torch.Tensor, tokens: torch.Tensor, chunk: int = 2048
) -> torch.Tensor:
    """Teacher-forced next-token CE from the pre-head hidden states
    (B, T, D): position t predicts tokens[:, t+1]."""
    b, t, d = hidden.shape
    x = hidden[:, :-1].reshape(b * (t - 1), d)
    targets = tokens[:, 1:].reshape(b * (t - 1))
    return fused_ce(x, w, targets, chunk)
