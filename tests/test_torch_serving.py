"""The slice as a whole: the JAX paged INT8 CFG ARServer against the port's
ARServer on the CPU, with the same (bridged) weights and near-greedy
sampling, so the code streams must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.models.transformers.llama import (
    LlamaTransformer as JaxLlama,
    fuse_llama_params,
    quantize_params_int8,
)
from vector_quantization_tpu.tasks.sequence_modeling import TokenCodebook as JaxCodebook
from vector_quantization_tpu.tasks.serving import ARServer as JaxServer
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
from vector_quantization_tpu_torch.tasks.serving import ARServer
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

TINY = dict(
    vocabulary_size=32, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64, max_length=16
)
RECIPE = dict(
    image_tokens=6, batch_slots=4, sampler={"temperature": 1e-4}, cfg_alpha=1.75,
    uncond_token=10, steps_per_sync=3, paged=True, page_size=4,
)
KEYS = {"syncs", "row_steps_active", "row_steps_idle", "tokens_delivered", "device_s",
        "host_s", "idle_lane_frac", "overshoot_frac", "useful_frac", "host_frac"}


def _params():
    params = JaxLlama(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    params["lm_head"] = (
        np.random.default_rng(9).standard_normal(params["lm_head"].shape) * 0.1
    ).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, fuse_llama_params(quantize_params_int8(params)))


def _port_server(params, **kw):
    return ARServer(
        LlamaTransformer(**TINY, quantize=True, fused_qkv=True),
        llama_params_from_flax(params), TokenCodebook(11, 16),
        cache_dtype=torch.int8, device="cpu", **{**RECIPE, **kw},
    )


def test_streams_match_jax_server():
    params = _params()
    jt = JaxLlama(**TINY, quantize=True, quantize_mode="xla", fused_qkv=True)
    js = JaxServer(jt, jax.tree_util.tree_map(jnp.asarray, params), JaxCodebook(11, 16),
                   cache_dtype=jnp.int8, **RECIPE)
    ts = _port_server(params)
    # 4 requests on 2 CFG pairs: slots turn over
    for s in (js, ts):
        for c in (2, 7, 5, 1):
            s.submit(category=c)
    want = dict(js.run_until_drained())
    got = dict(ts.run_until_drained())
    assert got.keys() == want.keys() == {0, 1, 2, 3}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert len(ts._free_pages) == ts._total_pages and ts._pages_reserved == 0
    rep = ts.efficiency_report()
    assert set(rep) == KEYS
    for key in ("syncs", "row_steps_active", "row_steps_idle", "tokens_delivered"):
        assert rep[key] == js.efficiency_report()[key]


def test_undersized_pool_queues_requests():
    params = _params()
    server = _port_server(params)
    per_request = server.lanes * server.pages_per_slot
    small = _port_server(params, num_pages=1 + per_request)
    for c in (1, 2, 3):
        small.submit(category=c)
    done = small.run_until_drained()
    assert sorted(r for r, _ in done) == [0, 1, 2]
    assert len(small._free_pages) == small._total_pages and small._pages_reserved == 0


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(paged=False), NotImplementedError),
        (dict(strategy=object()), NotImplementedError),
        (dict(num_pages=2), ValueError),
        (dict(batch_slots=3), ValueError),
        (dict(uncond_token=None), ValueError),
    ],
)
def test_rejected_configurations(kw, exc):
    with pytest.raises(exc):
        _port_server(_params(), **kw)
