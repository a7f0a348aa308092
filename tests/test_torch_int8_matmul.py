"""The port's int8_matmul (plain version on CPU) against the JAX function:
its Pallas kernel in interpret mode and its XLA path, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul, split_k


def _inputs(b, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = rng.integers(-127, 128, (d, f), dtype=np.int8)
    scale = rng.uniform(0.001, 0.02, f).astype(np.float32)
    return x, w, scale


@pytest.mark.parametrize(
    "b,d,f,use_pallas",
    [
        (4, 64, 48, True), (4, 64, 48, False),
        (16, 1024, 2816, True), (16, 1024, 2816, False),
        (3, 96, 101, True), (3, 96, 101, False),  # ragged F
    ],
)
def test_matches_jax(b, d, f, use_pallas):
    # both sides multiply exact bf16 products and sum in f32: only the
    # summation order differs (tolerance relative to the output scale)
    x, w, scale = _inputs(b, d, f)
    want = np.asarray(
        jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                        use_pallas=use_pallas, interpret=use_pallas)
    )
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=1e-4 * np.abs(want).max()
    )


def test_leading_dims_and_bf16_input():
    x, w, scale = _inputs(6, 32, 8, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16).reshape(2, 3, 32)
    got = int8_matmul(xb, torch.from_numpy(w), torch.from_numpy(scale))
    want = np.asarray(
        jax_int8_matmul(jnp.asarray(x, jnp.bfloat16).reshape(2, 3, 32),
                        jnp.asarray(w), jnp.asarray(scale), use_pallas=False)
    )
    assert got.shape == (2, 3, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize(
    "b,d,f", [(64, 1024, 1024), (64, 1024, 3072), (64, 2816, 1024), (64, 1024, 17385), (7, 100, 37)]
)
def test_split_k_covers_depth(b, d, f):
    # the kernel's grid: chunks are 32-multiples of at least 256 (or all of
    # a shallower D), cover D exactly once, and split D only while the grid
    # has fewer than two blocks per SM of a 132-SM card
    k_chunk = split_k(b, d, f, 132)
    assert k_chunk % 32 == 0 and k_chunk >= min(256, -(-d // 32) * 32)
    splits = -(-d // k_chunk)
    assert (splits - 1) * k_chunk < d <= splits * k_chunk
    tiles = -(-f // 128) * -(-b // 64)
    assert splits == 1 or tiles * (splits - 1) < 2 * 132
