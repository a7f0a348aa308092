"""Dynamic-activation INT8 (``quantize_mode="w8a8"``) against the JAX
package, on the CPU.

``int8_matmul_w8a8``: the same x and int8 weight through
``vector_quantization_tpu/ops/int8_matmul.py``'s function and the port's
(the plain version: exact int32 sums). The row scales and int8 codes equal
JAX's, the int32 accumulator equals JAX's ``dot_general`` exactly, and the
f32 output lies within 1 ulp of JAX's; also at a ragged F (the weight
padded once by ``prepare_w8a8``, the output sliced) and with a row of zeros
(the 1e-8 scale floor). The card's row padding (``torch._int_mm`` takes
more than 16 rows) is held in ``tests/test_torch_cuda.py``.

The Llama with ``quantize=True, quantize_mode="w8a8"``: the INT8 cache-free
forward (every projection and the INT8 head through w8a8) and the dense
INT8-cache decode, step by step, against JAX's at the same weights. f32
models within 1e-4 of max|ref| (f32 in another order); bf16 models within 1e-2 of max|ref| with 90% of the rows'
argmax equal, as the port's other bf16 models are held
(``tests/test_torch_llama_dense.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.models.transformers.llama import (
    LlamaTransformer as JaxLlama,
    fuse_llama_params as jax_fuse,
    quantize_params_int8 as jax_quantize,
)
from vector_quantization_tpu.ops.int8_matmul import int8_matmul_w8a8 as jax_w8a8
from vector_quantization_tpu_torch.models.transformers.llama import Int8Dense, LlamaTransformer
from vector_quantization_tpu_torch.ops.int8_matmul import (
    W8A8_ALIGN,
    W8A8_MIN_ROWS,
    int8_matmul_w8a8,
    int8_mm,
    prepare_w8a8,
    quantize_rows_int8,
)
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

TINY = dict(vocabulary_size=37, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64, max_length=16)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_codes(x):
    """JAX's quantisation and int32 accumulator, as ``int8_matmul_w8a8``
    computes them."""
    x2 = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(x2), axis=1, keepdims=True) / 127.0, 1e-8)
    return jnp.clip(jnp.round(x2 / xs), -127, 127).astype(jnp.int8), xs


def _operands(seed, lead, d, f, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, d)) * 3.0).astype(np.float32)
    x.reshape(-1, d)[1] = 0.0  # a row at all zeros: the 1e-8 scale floor
    w = rng.integers(-127, 128, (d, f), dtype=np.int8)
    scale = rng.uniform(1e-3, 2e-2, f).astype(np.float32)
    xt = torch.from_numpy(x).to(DTYPES[dtype][1])
    return xt, jnp.asarray(xt.float().numpy()).astype(DTYPES[dtype][0]), w, scale


@pytest.mark.parametrize("dtype,lead,d,f", [
    ("float32", (5,), 64, 48),
    ("bfloat16", (3, 7), 64, 48),
    ("float32", (20,), 96, 45),  # ragged F: padded to 48 once, sliced back
    ("bfloat16", (2, 3), 32, 13),
])
def test_w8a8_matmul_matches_jax(dtype, lead, d, f):
    x, jx, w, scale = _operands(d + f, lead, d, f, dtype)
    jq, jxs = _jax_codes(jx)
    xq, xs = quantize_rows_int8(x.reshape(-1, d))
    assert xq.dtype == torch.int8 and np.array_equal(xq.numpy(), np.asarray(jq))
    assert np.array_equal(xs.numpy(), np.asarray(jxs))
    assert float(xs[1]) == np.float32(1e-8) and not xq[1].any()
    jacc = jax.lax.dot_general(jq, jnp.asarray(w), (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    acc = int8_mm(xq, torch.from_numpy(w))
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(jacc))
    wt, st = torch.from_numpy(w), torch.from_numpy(scale)
    wp, sp = prepare_w8a8(wt, st)
    assert wp.shape[1] % W8A8_ALIGN == 0 and torch.equal(wp[:, :f], wt) and not wp[:, f:].any()
    assert wp.stride() == (1, d) and torch.equal(sp[:f], st) and not sp[f:].any()  # column-major
    got = int8_matmul_w8a8(x, wp, sp, f)
    want = np.asarray(jax_w8a8(jx, jnp.asarray(w), jnp.asarray(scale)))
    assert got.dtype == torch.float32 and got.shape == (*lead, f) == want.shape
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert not got.reshape(-1, f)[1].any()


def test_int8_mm_pads_few_rows_only_on_the_card():
    """On the CPU the plain version takes any row count; the row padding
    (``W8A8_MIN_ROWS``) is ``torch._int_mm``'s rule, applied on CUDA
    tensors only (``tests/test_torch_cuda.py`` runs it)."""
    a = torch.randint(-127, 128, (3, 16), dtype=torch.int8)
    b = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    want = a.long() @ b.long()
    assert torch.equal(int8_mm(a, b).long(), want) and W8A8_MIN_ROWS == 17


def test_int8_dense_w8a8_matches_jax_and_follows_loads():
    rng = np.random.default_rng(3)
    w = rng.integers(-127, 128, (32, 21), dtype=np.int8)
    scale = rng.uniform(1e-3, 2e-2, 21).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    dense = Int8Dense(32, 21, mode="w8a8")
    dense.load_state_dict({"w_int8": torch.from_numpy(w), "scale": torch.from_numpy(scale)})
    want = np.asarray(jax_w8a8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale)))
    np.testing.assert_array_max_ulp(dense(torch.from_numpy(x)).numpy(), want, maxulp=1)
    # new weights loaded in place: the padded copy is made again
    dense.load_state_dict({"w_int8": torch.from_numpy(-w), "scale": torch.from_numpy(scale)})
    want = np.asarray(jax_w8a8(jnp.asarray(x), jnp.asarray(-w), jnp.asarray(scale)))
    np.testing.assert_array_max_ulp(dense(torch.from_numpy(x)).numpy(), want, maxulp=1)


def _float_params():
    params = JaxLlama(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.default_rng(9)
    params["lm_head"] = (rng.standard_normal(params["lm_head"].shape) * 0.1).astype(np.float32)
    return params


def _pair(dtype, fused):
    params = jax.tree_util.tree_map(np.asarray, jax_quantize(_float_params()))
    if fused:
        params = jax.tree_util.tree_map(np.asarray, jax_fuse(params))
    jt = JaxLlama(**TINY, dtype=DTYPES[dtype][0], quantize=True, quantize_mode="w8a8", fused_qkv=fused)
    tt = LlamaTransformer(**TINY, dtype=dtype, quantize=True, quantize_mode="w8a8", fused_qkv=fused)
    tt.load_state_dict(llama_params_from_flax(params))
    return jt, jax.tree_util.tree_map(jnp.asarray, params), tt.eval()


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-4 * scale
        return
    assert np.abs(got - want).max() <= 1e-2 * scale
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("dtype,fused", [("float32", False), ("float32", True), ("bfloat16", True)])
def test_w8a8_llama_forward_and_decode_match_jax(dtype, fused):
    jt, params, tt = _pair(dtype, fused)
    toks = np.random.default_rng(4).integers(0, TINY["vocabulary_size"], (3, 9)).astype(np.int32)
    want = jt.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tt(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, dtype)
    jc = jt.init_cache(3, dtype=jnp.int8)
    tc = tt.init_cache(3, dtype=torch.int8, device="cpu")
    toks = toks[:, :3]
    with torch.inference_mode():
        for _ in range(6):  # a prefill of 3, then single steps
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc)
            tl, tc = tt(torch.from_numpy(toks), tc)
            assert tl.shape == jl.shape and tc.length == int(jc.length)
            _close(tl, jl, dtype)
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
