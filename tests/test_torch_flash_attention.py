"""The port's flash attention (plain forward, plain backward, the
``autograd.Function``) against the JAX package's ``_flash_train_attention``
(the Pallas TPU library kernel, forward and custom-VJP backward, run in
interpret mode on the CPU) and against a masked einsum softmax.

Tolerances: f32 within 1e-5 of max(1, max|ref|) (the same f32 arithmetic
in another order). bf16 within 1.6e-2 (o) and 2.4e-2 (dq, dk, dv) of
max(1, max|ref|): both sides round P and dS to bf16 and their outputs to
bf16, but from f32 values that differ in the last bits (the TPU kernel
rescales P by a running max per 128-column block; the port by the row's
max), so an element may land one bf16 step (2^-8 relative) away, and a
flipped P or dS moves a sum by about that much of one term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vector_quantization_tpu.models.transformers.llama import _flash_train_attention
from vector_quantization_tpu_torch.ops import flash_attention as fa

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 2.4e-2)}


def _inputs(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh), dtype=np.float32) for _ in range(4)]


def _err(got, want):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _jax_flash(q, k, v, do, dtype):
    cast = [jnp.asarray(x).astype(_JNP[dtype]) for x in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: _flash_train_attention(a, b, c, _JNP[dtype]), *cast[:3])
        grads = vjp(cast[3])
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _naive(q, k, v):
    """Masked einsum softmax attention, f32, differentiable."""
    t, dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q, k) / dh**0.5
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v), torch.logsumexp(s, -1)


@pytest.mark.parametrize(
    "t,dh,dtype",
    [(1, 64, "float32"), (65, 64, "float32"), (130, 64, "float32"), (65, 32, "float32"),
     (1, 64, "bfloat16"), (65, 64, "bfloat16"), (130, 64, "bfloat16"), (65, 32, "bfloat16"),
     (257, 64, "float32"), (257, 64, "bfloat16")],
)
def test_flash_attention_matches_jax(t, dh, dtype):
    # the training path's length (257) with one batch row keeps the Pallas
    # kernel's interpret-mode run short
    q, k, v, do = _inputs(1 if t == 257 else 2, t, 2, dh, seed=t + dh)
    want = _jax_flash(q, k, v, do, dtype)
    tq, tk, tv = [torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(tq, tk, tv)
    assert o.dtype == _TORCH[dtype] and o.shape == tq.shape
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(_TORCH[dtype]))
    tol_o, tol_g = _TOL[dtype]
    assert _err(o.detach(), want[0]) <= tol_o
    for g, w in zip(grads, want[1:]):
        assert g.dtype == _TORCH[dtype]
        assert _err(g, w) <= tol_g


@pytest.mark.parametrize("t,dh", [(1, 64), (65, 64), (130, 32)])
def test_plain_versions_match_naive_attention(t, dh):
    q, k, v, do = [torch.from_numpy(x) for x in _inputs(3, t, 2, dh, seed=7 * t)]
    o, lse = fa.flash_attention_reference(q, k, v)
    qn, kn, vn = [x.clone().requires_grad_() for x in (q, k, v)]
    on, lse_n = _naive(qn, kn, vn)
    assert _err(o, on.detach()) <= 1e-5
    assert _err(lse, lse_n.detach()) <= 1e-5
    assert lse.shape == (3, 2, t) and lse.dtype == torch.float32
    # the plain backward, written out, equals torch autograd of the naive form
    want = torch.autograd.grad(on, (qn, kn, vn), do)
    got = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert _err(g, w) <= 1e-5


def test_cuda_kernels_refuse_what_they_do_not_take():
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="float32"):  # never cast silently
        fa._check(x, x, x)
    y = torch.zeros(1, 4, 2, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(y, y, y)
    z = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa._check(z, z, z)
