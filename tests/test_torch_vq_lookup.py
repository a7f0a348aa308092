"""The port's nearest-code lookup (plain version on CPU), distances, STE and
quantizer losses against the JAX functions on the same numpy-made inputs:
the lookup against the JAX Pallas kernel in interpret mode (its own test
shapes) and against its XLA path at a wide code dimension."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops import losses as jax_losses
from vector_quantization_tpu.ops.distances import normalize as jax_normalize
from vector_quantization_tpu.ops.distances import pairwise_distance as jax_pairwise
from vector_quantization_tpu.ops.vq_lookup import nearest_codes as jax_nearest_codes
from vector_quantization_tpu.ops.vq_lookup import vq_quantize as jax_vq_quantize
from vector_quantization_tpu_torch.ops import losses
from vector_quantization_tpu_torch.ops.distances import normalize, pairwise_distance
from vector_quantization_tpu_torch.ops.ste import ste
from vector_quantization_tpu_torch.ops.vq_lookup import (
    compare_codes,
    k_tiles_per_split,
    nearest_codes,
    vq_quantize,
)

_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(n, k, d, dtype="float32", seed=0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = rng.standard_normal((k, d), dtype=np.float32)
    if ties:
        # every odd code repeats the even one before it, and every third
        # row sits on an even code: exact ties the lowest index must win
        e[1::2] = e[0::2][: k // 2]
        x[::3] = e[rng.integers(0, k // 2, x[::3].shape[0]) * 2]
    tdt, jdt = _DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), torch.from_numpy(e).to(tdt), jnp.asarray(x, jdt), jnp.asarray(e, jdt)


@pytest.mark.parametrize("n,k,d", [(100, 64, 8), (700, 300, 40)])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_pallas_interpret(n, k, d, metric, dtype):
    x, e, jx, je = _inputs(n, k, d, dtype, seed=n + d)
    want = np.array(jax_nearest_codes(jx, je, metric, use_pallas=True, interpret=True,
                                        block_n=256, block_k=128))
    got = nearest_codes(x, e, metric)
    assert got.dtype == torch.int32 and got.shape == (n,)
    rep = compare_codes(x, e, got, torch.from_numpy(want), metric)
    assert rep["ok"], rep


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_matches_jax_xla_wide_codes(metric):
    x, e, jx, je = _inputs(300, 200, 256, seed=3)
    want = np.array(jax_nearest_codes(jx, je, metric, use_pallas=False))
    rep = compare_codes(x, e, nearest_codes(x, e, metric), torch.from_numpy(want), metric)
    assert rep["ok"], rep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_ties_go_to_lowest_index(dtype):
    x, e, jx, je = _inputs(300, 64, 8, dtype, seed=5, ties=True)
    got = nearest_codes(x, e).numpy()
    want = np.array(jax_nearest_codes(jx, je, use_pallas=True, interpret=True,
                                        block_n=256, block_k=128))
    # rows on a planted code: the even (lower) copy, exactly, on both sides
    planted = np.arange(0, 300, 3)
    assert (got[planted] % 2 == 0).all()
    np.testing.assert_array_equal(got[planted], want[planted])


def test_vq_quantize_gathers_the_codes():
    x, e, jx, je = _inputs(100, 64, 8, seed=7)
    codes, z = vq_quantize(x, e)
    jcodes, jz = jax_vq_quantize(jx, je, use_pallas=True, interpret=True, block_n=256, block_k=128)
    assert compare_codes(x, e, codes, torch.from_numpy(np.array(jcodes)))["ok"]
    np.testing.assert_array_equal(z.numpy(), e.numpy()[codes.numpy()])
    same = codes.numpy() == np.asarray(jcodes)
    np.testing.assert_array_equal(z.numpy()[same], np.asarray(jz)[same])


def test_normalize_is_rsqrt_not_f_normalize():
    x, _, jx, _ = _inputs(50, 1, 8, seed=9)
    x[0] = 0.0  # rsqrt(0 + eps): finite, zero row stays zero
    jx = jnp.asarray(x.numpy())
    got = normalize(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize(jx)), rtol=0, atol=1e-7)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pairwise_distance_matches_jax(metric):
    x, e, jx, je = _inputs(40, 30, 16, seed=11)
    want = np.asarray(jax_pairwise(jx, je, metric))
    np.testing.assert_allclose(pairwise_distance(x, e, metric).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("codebook_loss", {"weight": 0.5}),
    ("commitment_loss", {}),
    ("vqgan_quantizer_loss", {"beta": 0.25}),
])
def test_quantizer_losses_match_jax(name, kwargs):
    x, e, jx, je = _inputs(64, 64, 8, seed=13)
    got = float(getattr(losses, name)(e, x, **kwargs))
    want = float(getattr(jax_losses, name)(je, jx, **kwargs))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_entropy_loss_matches_jax():
    x, e, jx, je = _inputs(64, 32, 8, seed=15)
    got = float(losses.entropy_loss(pairwise_distance(x, e, "l2"), temperature=0.5, sign=-1.0))
    want = float(jax_losses.entropy_loss(jax_pairwise(jx, je, "l2"), temperature=0.5, sign=-1.0))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_ste_forward_is_z_gradient_to_x():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    z = torch.tensor([1.5, 1.5], requires_grad=True)
    out = ste(z, x)
    out.sum().backward()
    assert out.tolist() == [1.5, 1.5]
    assert x.grad.tolist() == [1.0, 1.0] and z.grad is None


@pytest.mark.parametrize("n,k", [(16384, 16384), (1, 16384), (1000, 777), (130, 64), (16384, 100)])
def test_k_splits_cover_the_codebook(n, k):
    # the kernel's grid: each block takes a run of 128-code tiles; the runs
    # cover the codebook once, none is empty, and the grid fills a 132-SM
    # card with at least 8 blocks per SM where the codebook has the tiles
    per = k_tiles_per_split(n, k, 132)
    k_tiles = -(-k // 128)
    splits = -(-k_tiles // per)
    assert 1 <= per <= k_tiles and (splits - 1) * per < k_tiles <= splits * per
    assert splits == k_tiles or -(-n // 128) * splits >= 8 * 132
