"""The port's logits-free fused CE against the JAX package's
``ops/fused_ce.py`` (forward and custom-VJP backward), with a ragged last
vocabulary chunk and targets inside it, and ``fused_next_token_ce`` against
``next_token_ce`` of dense logits.

Tolerances: the loss within 1e-6 relative (bf16 operands in both, f32
sums in another order); dx and dw within 1e-3 of max|ref| (both round the
logits' cotangent to bf16 before the products, from f32 values that differ
in the last bits, so an element may sit one bf16 step apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops.fused_ce import fused_ce as jax_fused_ce
from vector_quantization_tpu.tasks.sequence_modeling import next_token_ce as jax_next_token_ce
from vector_quantization_tpu_torch.ops.fused_ce import fused_ce, fused_next_token_ce
from vector_quantization_tpu_torch.tasks.sequence_modeling import next_token_ce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("n,d,v,chunk", [(48, 32, 300, 128), (33, 16, 75, 128), (20, 8, 256, 64)])
def test_fused_ce_matches_jax(n, d, v, chunk):
    rng = np.random.default_rng(n + v)
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    targets[:4] = [v - 1, v - 2, (v // chunk) * chunk, 0]  # in the last (ragged) chunk
    jloss, jgrads = jax.value_and_grad(
        lambda a, b: jax_fused_ce(a, b, jnp.asarray(targets), chunk), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_ce(tx, tw, torch.from_numpy(targets), chunk)
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert _rel(dx, jgrads[0]) <= 1e-3
    assert _rel(dw, jgrads[1]) <= 1e-3


def test_fused_next_token_ce_matches_dense_head():
    # bf16-rounded hidden states and head: the dense f32 logits are then the
    # fused path's own products, so the two losses differ only by sum order
    rng = np.random.default_rng(3)
    b, t, d, v = 3, 9, 16, 75
    hidden = torch.from_numpy(rng.standard_normal((b, t, d), dtype=np.float32)).bfloat16().float()
    w = torch.from_numpy(rng.standard_normal((d, v), dtype=np.float32) * 0.3).bfloat16().float()
    tokens = torch.from_numpy(rng.integers(0, v, (b, t)).astype(np.int32))
    fused = fused_next_token_ce(hidden, w, tokens, chunk=32)
    dense = next_token_ce(hidden @ w, tokens)
    jdense = jax_next_token_ce(jnp.asarray((hidden @ w).numpy()), jnp.asarray(tokens.numpy()))
    assert abs(float(fused) - float(dense)) <= 1e-5 * float(dense)
    assert abs(float(dense) - float(jdense)) <= 1e-6 * float(jdense)
