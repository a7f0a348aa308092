"""The port's Llama decode over the dense KV cache against the JAX model:
the same flax weights (through utils/bridge.py), tokens and positions,
step by step; the shared-column (``row_starts``) decode against the per-row
path; the INT8 cache-free forward against JAX's.

Tolerances. f32 models: logits within 1e-4 abs/rel at every step (f32 in
another order). bf16 models: within 1e-2 of max|ref| with at least 90% of
the rows' argmax equal. XLA:CPU and torch evaluate rsqrt, sin, cos, exp
and silu with results up to one f32 ulp apart, and a bf16 rounding turns
such a difference into a whole bf16 step (2^-8 relative) now and then; the
port's cache-free bf16 forward, unchanged here, sits at 3.2e-3 of max|ref|
from JAX's on these weights. INT8 cache codes differ by at most 1: in f32
models at rounding boundaries only (as the paged pool's,
``tests/test_torch_llama_decode.py``), scales within 1e-6; in bf16 models,
whose k/v differ by bf16 steps, scales within 1e-2 relative.
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
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

TINY = dict(
    vocabulary_size=32, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64, max_length=16
)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _float_params():
    params = JaxLlama(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.default_rng(9)
    params["lm_head"] = (rng.standard_normal(params["lm_head"].shape) * 0.1).astype(np.float32)
    return params


def _pair(dtype="float32", int8=False, fused=False):
    params = _float_params()
    if int8:
        params = jax.tree_util.tree_map(np.asarray, jax_quantize(params))
    if fused:
        params = jax.tree_util.tree_map(np.asarray, jax_fuse(params))
    # quantize_mode="xla": the JAX Int8Dense's weight-only XLA path, the
    # same arithmetic as its Pallas kernel
    jt = JaxLlama(**TINY, dtype=DTYPES[dtype][0], quantize=int8, quantize_mode="xla",
                  fused_qkv=fused)
    tt = LlamaTransformer(**TINY, dtype=dtype, quantize=int8, fused_qkv=fused)
    tt.load_state_dict(llama_params_from_flax(params))
    return jt, jax.tree_util.tree_map(jnp.asarray, params), tt.eval()


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * scale
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def _same_cache(tc, jc, cache_dtype, dtype="float32"):
    f32 = dtype == "float32"
    for i in range(TINY["num_layers"]):
        if cache_dtype == "int8":
            # codes differ by at most 1; in an f32 model at rounding
            # boundaries only (a bf16 model's k/v differ by bf16 steps)
            for t, j in ((tc.k[i], jc.k[i]), (tc.v[i], jc.v[i])):
                diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
                assert diff.max() <= 1 and (not f32 or (diff > 0).mean() < 1e-2)
            for t, j in ((tc.k_scale[i], jc.k_scale[i]), (tc.v_scale[i], jc.v_scale[i])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                           rtol=0 if f32 else 1e-2)
        else:
            for t, j in ((tc.k[i], jc.k[i]), (tc.v[i], jc.v[i])):
                np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                           atol=1e-2, rtol=1e-2)


CASES = [  # (model dtype, int8 weights, fused, cache dtype)
    ("float32", False, False, "float32"),
    ("float32", False, False, "bfloat16"),
    ("float32", False, True, "int8"),
    ("float32", True, False, "bfloat16"),
    ("float32", True, True, "int8"),
    ("bfloat16", False, False, "bfloat16"),
    ("bfloat16", True, True, "int8"),
]


@pytest.mark.parametrize("dtype,int8,fused,cache_dtype", CASES)
def test_scalar_offset_decode_matches_jax(dtype, int8, fused, cache_dtype):
    # prefill of 3 tokens, then single steps through the scalar offset
    jt, params, tt = _pair(dtype, int8, fused)
    b = 3
    jc = jt.init_cache(b, dtype=DTYPES[cache_dtype][0])
    tc = tt.init_cache(b, dtype=DTYPES[cache_dtype][1], device="cpu")
    toks = np.random.default_rng(1).integers(0, TINY["vocabulary_size"], (b, 3)).astype(np.int32)
    with torch.inference_mode():
        for _ in range(6):
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc)
            tl, tc = tt(torch.from_numpy(toks), tc)
            assert tl.dtype == torch.float32 and tl.shape == jl.shape
            assert tc.length == int(jc.length)
            _close(tl, jl, dtype)
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    _same_cache(tc, jc, cache_dtype, dtype)


@pytest.mark.parametrize("dtype,int8,fused,cache_dtype", CASES[1::2])
def test_slot_positions_decode_matches_jax(dtype, int8, fused, cache_dtype):
    # continuous batching: every row at its own column, staggered
    jt, params, tt = _pair(dtype, int8, fused)
    b = 3
    jc = jt.init_cache(b, dtype=DTYPES[cache_dtype][0])
    tc = tt.init_cache(b, dtype=DTYPES[cache_dtype][1], device="cpu")
    toks = np.asarray([[3], [5], [7]], np.int32)
    with torch.inference_mode():
        for step in range(6):
            pos = np.asarray([step, step + 4, step], np.int32)
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc,
                              slot_positions=jnp.asarray(pos))
            tl, tc = tt(torch.from_numpy(toks), tc, slot_positions=torch.from_numpy(pos))
            _close(tl, jl, dtype)
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    _same_cache(tc, jc, cache_dtype, dtype)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_row_starts_decode_matches_per_row_path(cache_dtype):
    # row 1 is admitted at column 3: the shared-column decode (RoPE by the
    # shared column, reads masked from the row's start) gives the per-row
    # path's logits up to rounding (JAX TestSharedColumnDecode's bound)
    _, _, tt = _pair()
    steps, start1 = 8, 3
    toks = np.asarray([[5, 7, 2, 9, 4, 1, 8, 3], [0, 0, 0, 6, 2, 7, 1, 5]], np.int32)
    starts = torch.tensor([0, start1], dtype=torch.int32)
    dt = DTYPES[cache_dtype][1]
    cache_sc = tt.init_cache(2, dtype=dt, device="cpu")
    cache_pr = tt.init_cache(2, dtype=dt, device="cpu")
    positions = np.zeros(2, np.int32)
    sc, pr = [], []
    with torch.inference_mode():
        for c in range(steps):
            tok = torch.from_numpy(toks[:, c : c + 1])
            lg, cache_sc = tt(tok, cache_sc._replace(length=c), row_starts=starts)
            sc.append(lg[:, 0].numpy())
            if c == start1:
                positions[1] = 0  # the per-row path restarts row 1 at 0
            lg2, cache_pr = tt(tok, cache_pr, slot_positions=torch.from_numpy(positions))
            pr.append(lg2[:, 0].numpy())
            positions += 1
    sc, pr = np.stack(sc), np.stack(pr)
    np.testing.assert_allclose(sc[:, 0], pr[:, 0], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(sc[start1:, 1], pr[start1:, 1], atol=2e-3, rtol=2e-3)


def test_row_starts_decode_matches_jax():
    jt, params, tt = _pair("float32", True, True)
    jc = jt.init_cache(2, dtype=jnp.int8)
    tc = tt.init_cache(2, dtype=torch.int8, device="cpu")
    starts = np.asarray([0, 2], np.int32)
    toks = np.asarray([[5], [0]], np.int32)
    with torch.inference_mode():
        for _ in range(5):
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc,
                              row_starts=jnp.asarray(starts))
            tl, tc = tt(torch.from_numpy(toks), tc, row_starts=torch.from_numpy(starts))
            _close(tl, jl, "float32")
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    _same_cache(tc, jc, "int8")


@pytest.mark.parametrize("dtype,fused", [("float32", False), ("float32", True), ("bfloat16", True)])
def test_int8_cache_free_forward_matches_jax(dtype, fused):
    jt, params, tt = _pair(dtype, int8=True, fused=fused)
    toks = np.random.default_rng(3).integers(0, TINY["vocabulary_size"], (2, 9)).astype(np.int32)
    want = jt.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tt(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, dtype)


def test_cache_free_forward_equals_prefill():
    # the same tokens through the cache-free forward and as one prefill
    _, _, tt = _pair("float32", True, True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 32, (2, 7)).astype(np.int32))
    with torch.inference_mode():
        free = tt(toks)
        pre, cache = tt(toks, tt.init_cache(2, dtype=torch.float32, device="cpu"))
    torch.testing.assert_close(pre, free, atol=1e-5, rtol=1e-5)
    assert cache.length == 7 and cache.window == TINY["max_length"]


def test_dense_cache_overflow_and_bad_calls_raise():
    _, _, tt = _pair()
    cache = tt.init_cache(1, dtype=torch.float32, device="cpu", rows=4)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="window"):
            tt(torch.zeros((1, 5), dtype=torch.int32), cache)
        with pytest.raises(ValueError, match="single-token"):
            tt(torch.zeros((1, 2), dtype=torch.int32), cache,
               slot_positions=torch.zeros(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="scalar-offset"):
            tt(tok, cache, slot_positions=torch.zeros(1, dtype=torch.int32),
               row_starts=torch.zeros(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="training-path"):
            tt(tok, cache, fused_ce_targets=tok)
