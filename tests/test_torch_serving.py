"""The servers as a whole: the JAX paged and dense (shared-column and
per-row scatter) INT8 CFG ARServers against the port's on the CPU, with the
same (bridged) weights and near-greedy sampling, so the code streams must be
identical; then the port's engines against one another (the analogues of
``tests/test_serving.py``'s dense-engine tests)."""

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _drain(server, categories):
    """Submit ``categories`` at once and drain: {request_id: codes}."""
    for c in categories:
        server.submit(category=c)
    return dict(server.run_until_drained())


@pytest.mark.parametrize(
    "engine", [dict(), dict(paged=False), dict(paged=False, aligned=False)],
    ids=["paged", "shared_column", "dense_scatter"],
)
def test_streams_match_jax_server(engine):
    params = _params()
    jt = JaxLlama(**TINY, quantize=True, quantize_mode="xla", fused_qkv=True)
    js = JaxServer(jt, jax.tree_util.tree_map(jnp.asarray, params), JaxCodebook(11, 16),
                   cache_dtype=jnp.int8, **{**RECIPE, **engine})
    ts = _port_server(params, **engine)
    assert ts._shared_col == js._shared_col == ("aligned" not in engine and "paged" in engine)
    # 5 requests on 2 CFG pairs: slots turn over
    want = _drain(js, (2, 7, 5, 1, 3))
    got = _drain(ts, (2, 7, 5, 1, 3))
    assert got.keys() == want.keys() == {0, 1, 2, 3, 4}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    if ts.paged:
        assert len(ts._free_pages) == ts._total_pages and ts._pages_reserved == 0
    rep = ts.efficiency_report()
    assert set(rep) == KEYS
    for key in ("syncs", "row_steps_active", "row_steps_idle", "tokens_delivered"):
        assert rep[key] == js.efficiency_report()[key]


def test_shared_column_matches_scatter_under_staggered_arrivals():
    params = _params()
    outs = {}
    for aligned in (None, False):
        s = _port_server(params, paged=False, aligned=aligned)
        s.submit(2)
        s.step()  # stream 0 mid-flight
        s.submit(7)
        s.submit(4)
        outs[aligned] = dict(s.run_until_drained())
    assert outs[None].keys() == outs[False].keys() == {0, 1, 2}
    for rid in outs[None]:
        np.testing.assert_array_equal(outs[None][rid], outs[False][rid])


def test_compaction_over_many_waves():
    # 30 sequential waves on one row: the shared column crosses several
    # 64-column blocks, so compaction shifts run; the streams must equal the
    # scatter engine's, which has no shared column space
    params = _params()
    kw = dict(paged=False, batch_slots=2, cfg_alpha=None, uncond_token=None)
    outs = {}
    for aligned in (None, False):
        server = _port_server(params, aligned=aligned, **kw)
        rids = [server.submit(c % 7) for c in range(30)]
        outs[aligned] = dict(server.run_until_drained())
        assert sorted(outs[aligned]) == rids
        if aligned is None:
            assert server.col <= server._sc_cap
            s = server.stats
            total = s["row_steps_active"] + s["row_steps_idle"]
            assert total == s["syncs"] * server.steps_per_sync * server.batch_slots
            assert s["tokens_delivered"] == 30 * RECIPE["image_tokens"]
    for rid in outs[None]:
        np.testing.assert_array_equal(outs[None][rid], outs[False][rid])


@pytest.mark.parametrize("aligned", [None, False])
def test_chunked_matches_unchunked(aligned):
    # sampled (top-k) streams: one draw per step whatever the chunking;
    # the scatter engine's window regrows mid-sync across 64-column buckets
    params = _params()
    tiny = dict(TINY, max_length=200)
    outs = []
    for chunk in (None, 2, 64):
        server = ARServer(
            LlamaTransformer(**tiny, quantize=True, fused_qkv=True),
            llama_params_from_flax(params), TokenCodebook(11, 16), cache_dtype=torch.int8,
            device="cpu", image_tokens=130, batch_slots=4, sampler={"top_k": 5},
            steps_per_sync=65, sync_chunk=chunk, aligned=aligned)
        outs.append(_drain(server, (2, 7, 9)))
    for other in outs[1:]:
        assert other.keys() == outs[0].keys() == {0, 1, 2}
        for rid in other:
            np.testing.assert_array_equal(other[rid], outs[0][rid])


@pytest.mark.parametrize("aligned", [None, False])
def test_multi_step_sync_equals_single_step(aligned):
    params = _params()
    outs = [_drain(_port_server(params, paged=False, aligned=aligned, steps_per_sync=k),
                   (2, 7, 5))
            for k in (1, 4)]
    assert outs[0].keys() == outs[1].keys() == {0, 1, 2}
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def test_dense_int8_server_matches_paged_int8_server():
    params = _params()
    paged = _drain(_port_server(params), (2, 7, 5, 1))
    dense = _drain(_port_server(params, paged=False), (2, 7, 5, 1))
    assert paged.keys() == dense.keys() == {0, 1, 2, 3}
    for rid in paged:
        np.testing.assert_array_equal(dense[rid], paged[rid])


def test_waste_accounting_nonzero_when_staggered():
    # a lone request leaves the other CFG pair idle throughout
    server = _port_server(_params(), paged=False)
    assert server._shared_col
    _drain(server, (1,))
    rep = server.efficiency_report()
    assert rep["idle_lane_frac"] > 0 and rep["useful_frac"] > 0


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
        (dict(sync_chunk=0), ValueError),
        (dict(strategy=object()), NotImplementedError),
        (dict(num_pages=2), ValueError),
        (dict(batch_slots=3), ValueError),
        (dict(uncond_token=None), ValueError),
    ],
)
def test_rejected_configurations(kw, exc):
    with pytest.raises(exc):
        _port_server(_params(), **kw)
