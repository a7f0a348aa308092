"""The port's top-k/top-p filter and CFG mix against the JAX functions on
the same logits (the filter is deterministic, so the kept sets must be
equal); sampling itself is checked for range and near-greedy behaviour,
since torch.Generator and jax.random give different streams by design."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.models.transformers.sampling import (
    cfg_mix as jax_cfg_mix,
    top_k_top_p_filter as jax_filter,
)
from vector_quantization_tpu_torch.models.transformers.sampling import (
    cfg_mix,
    sample_tokens,
    top_k_top_p_filter,
)

V = 257


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("top_k", [1, 5, V])
@pytest.mark.parametrize("top_p", [0.5, 0.92, 1.0])
def test_filter_keeps_the_jax_set(top_k, top_p):
    logits = np.random.default_rng(top_k * 10 + int(top_p * 100)).normal(size=(6, V)).astype(np.float32) * 3
    want = np.asarray(jax_filter(jnp.asarray(logits), top_k, top_p))
    got = top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got > -1e9, want > -1e9)
    kept = want > -1e9
    np.testing.assert_array_equal(got[kept], want[kept])
    assert np.all(got[~kept] == -1e10)


def test_cfg_mix_halves():
    logits = np.random.default_rng(0).normal(size=(4, 9)).astype(np.float32)
    np.testing.assert_allclose(
        cfg_mix(torch.from_numpy(logits), 1.75).numpy(),
        np.asarray(jax_cfg_mix(jnp.asarray(logits), 1.75)),
        rtol=1e-6, atol=1e-6,
    )


def test_sample_tokens_range_and_near_greedy():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 40)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    tok = sample_tokens(gen, logits, 10, 30, temperature=1.0, top_k=5, top_p=0.9)
    assert tok.dtype == torch.int32 and bool(((tok >= 10) & (tok < 30)).all())
    # only the 5 largest in range can be drawn
    top5 = torch.topk(logits[:, 10:30], 5).indices + 10
    assert bool((tok[:, None] == top5).any(dim=1).all())
    greedy = sample_tokens(gen, logits, 10, 30, temperature=1e-4)
    torch.testing.assert_close(greedy, (logits[:, 10:30].argmax(-1) + 10).to(torch.int32))
