"""The port's Llama paged decode against the JAX model: the same flax
weights (through utils/bridge.py), tokens and positions, step by step."""

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
from vector_quantization_tpu_torch.models.transformers.llama import (
    LlamaTransformer,
    fuse_llama_params,
    quantize_params_int8,
)
from vector_quantization_tpu_torch.registries import TransformerRegistry
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

TINY = dict(
    vocabulary_size=32, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64, max_length=16
)


def _float_params():
    params = JaxLlama(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.default_rng(9)
    params["lm_head"] = (rng.standard_normal(params["lm_head"].shape) * 0.1).astype(np.float32)
    return params


def _pair(int8, fused):
    params = _float_params()
    if int8:
        params = jax.tree_util.tree_map(np.asarray, jax_quantize(params))
    if fused:
        params = jax.tree_util.tree_map(np.asarray, jax_fuse(params))
    # quantize_mode="xla": the JAX Int8Dense never interprets its Pallas
    # kernel off-TPU; the XLA path is the same weight-only arithmetic
    jt = JaxLlama(**TINY, quantize=int8, quantize_mode="xla", fused_qkv=fused, paged_kernel=True)
    tt = LlamaTransformer(**TINY, quantize=int8, fused_qkv=fused)
    tt.load_state_dict(llama_params_from_flax(params))
    return jt, jax.tree_util.tree_map(jnp.asarray, params), tt.eval()


@pytest.mark.parametrize(
    "int8,fused,cache_dtype",
    [(True, True, "int8"), (True, False, "int8"), (False, True, "float32")],
)
def test_paged_decode_matches_jax(int8, fused, cache_dtype):
    jt, params, tt = _pair(int8, fused)
    b = 3
    jdt = {"int8": jnp.int8, "float32": jnp.float32}[cache_dtype]
    tdt = {"int8": torch.int8, "float32": torch.float32}[cache_dtype]
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    jc = jt.init_paged_cache(b, num_pages=13, page_size=4, pages_per_slot=4, dtype=jdt)
    jc = jc._replace(page_table=jnp.asarray(table))
    tc = tt.init_paged_cache(b, 13, 4, 4, dtype=tdt, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    toks = np.asarray([[3], [5], [7]], np.int32)
    with torch.inference_mode():
        for step in range(6):
            pos = np.asarray([step, step + 2, step], np.int32)  # staggered rows
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc,
                              slot_positions=jnp.asarray(pos))
            tl, tc = tt(torch.from_numpy(toks), tc, slot_positions=torch.from_numpy(pos))
            assert tl.dtype == torch.float32 and tl.shape == (b, 1, TINY["vocabulary_size"])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    if cache_dtype == "int8":
        # codes differ by at most 1, at rounding boundaries only
        for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
            diff = np.abs(np.asarray(jp, np.int32) - tp.numpy().astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        for jp, tp in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-5)


def test_quantize_and_fuse_match_jax():
    params = _float_params()
    want = jax.tree_util.tree_map(np.asarray, jax_fuse(jax_quantize(params)))
    got = fuse_llama_params(quantize_params_int8(params))
    flat_w = llama_params_from_flax(want)
    flat_g = llama_params_from_flax(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert flat_w[k].dtype == flat_g[k].dtype, k
        torch.testing.assert_close(flat_g[k], flat_w[k], rtol=0, atol=0)


def test_registry_builds_config_dict():
    # the dict configs/ar/transformers/llama.py + algorithms/ar.py build
    model = TransformerRegistry.build(
        dict(_delete_=True, type="LlamaTransformer", dtype="bfloat16", remat=True,
             hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64),
        vocabulary_size=40, max_length=17,
    )
    assert isinstance(model, LlamaTransformer)
    assert model.dtype == torch.bfloat16 and model.remat and model.max_length == 17


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(remat_policy="dots"),  # no cache: selective checkpointing
    ],
)
def test_paths_of_later_slices_raise(kwargs):
    tt = LlamaTransformer(**TINY, remat=True, **kwargs)
    tokens = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt(tokens, fused_ce_targets=tokens)


@pytest.mark.parametrize("kwargs", [dict(quantize_mode="w8a8"), dict(paged_kernel=False)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        LlamaTransformer(**TINY, **kwargs)
