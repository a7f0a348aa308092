"""The port's int8_matmul (plain version on CPU) against the JAX function:
its Pallas kernel in interpret mode and its XLA path, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from vector_quantization_tpu_torch.ops.int8_matmul import (
    H100, Card, Plan, int8_matmul, plan, split_k, split_k_plan, wide_plan,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# the shapes of tests/test_torch_cuda.py's kernel test; the first five are
# the decode step's (qkv, o, gate+up, down, lm head of Llama-medium)
PLAN_SHAPES = [
    (64, 1024, 3072), (64, 1024, 1024), (64, 1024, 5632), (64, 2816, 1024), (64, 1024, 17385),
    (1, 1024, 3072), (7, 2816, 1024), (3, 100, 37), (130, 96, 200),
    (64, 1000, 777), (130, 1000, 17385), (5, 100, 37), (64, 20000, 256),
]
# a card with less shared memory than the H100 (an sm_86 part's 100 KB)
SMALL_CARD = Card(84, 102_400, 101_376)


def _aligned(d, f):
    # operands at 16-byte aligned bases, as torch allocates them
    return (2 * d) % 16 == 0 and f % 16 == 0


def _plan(design, b, d, f, card=H100):
    # the design's own plan ("planned": the one plan() picks)
    if design == "split_k":
        return split_k_plan(b, d, f, card.sms)
    if design == "wide":
        return wide_plan(b, d, f, card)
    return plan(b, d, f, card, _aligned(d, f))


# (design, shape): each design at every shape it takes (the wide design
# needs aligned rows and a share that fits)
DESIGN_CASES = [(design, s) for design in ("planned", "split_k", "wide") for s in PLAN_SHAPES
                if design != "wide" or (_aligned(*s[1:]) and wide_plan(*s, H100) is not None)]


def _forced_wide(b, d, f, split):
    # the wide kernel under a cluster size plan() may not pick (the card
    # tests launch these), ring of 2
    share = -(-(-(-d // 64)) // split)
    return Plan("wide", 128, split, 64, 2, share * 64)


@pytest.mark.parametrize(
    "design,shape",
    DESIGN_CASES + [(f"wide_split{k}", s) for k in (1, 2, 4, 8)
                    for s in [(64, 1024, 1024), (130, 1000, 208), (7, 2816, 1024)]],
)
def test_plan_covers_each_column_and_depth_once(design, shape):
    # per 64-row tile, the blocks' column stripes tile [0, F) and each
    # stripe's depth runs tile [0, D), with no overlap and no gap
    b, d, f = shape
    if design.startswith("wide_split"):
        p = _forced_wide(b, d, f, int(design.removeprefix("wide_split")))
    else:
        p = _plan(design, b, d, f)
    blocks = p.blocks(b, d, f)
    gx, gy, gz = p.grid(b, d, f)
    assert len(blocks) == gx * gy * gz
    assert sorted({m0 for m0, *_ in blocks}) == list(range(0, b, 64))
    for m0 in range(0, b, 64):
        cols = sorted({n0 for r, n0, *_ in blocks if r == m0})
        assert cols == list(range(0, f, p.n))
        for n0 in cols:
            runs = sorted((k0, k1) for r, c, k0, k1 in blocks if (r, c) == (m0, n0))
            assert runs[0][0] == 0 and runs[-1][1] == d
            assert all(a[1] == c[0] and a[0] < a[1] for a, c in zip(runs, runs[1:]))


@pytest.mark.parametrize("design,shape", DESIGN_CASES)
def test_plan_launch_fits_the_card(design, shape):
    # a cluster (the blocks that split D through distributed shared memory)
    # divides grid x and is a portable size; a block's shared memory fits
    b, d, f = shape
    p = _plan(design, b, d, f)
    gx = p.grid(b, d, f)[0]
    if p.design == "wide":
        assert 1 <= p.split <= 8 and gx % p.split == 0
    assert p.smem() <= H100.smem_block


@pytest.mark.parametrize("b,d,f", PLAN_SHAPES)
def test_plan_fits_a_smaller_card(b, d, f):
    # the plan reads the card's shared memory: on a card with less, every
    # block the plan puts on an SM still fits beside the others
    p = plan(b, d, f, SMALL_CARD, _aligned(d, f))
    assert p.smem() <= SMALL_CARD.smem_block
    if p.design == "wide":
        per_sm = -(-p.grid(b, d, f)[0] * p.grid(b, d, f)[1] // SMALL_CARD.sms)
        assert per_sm * (p.smem() + 1024) <= SMALL_CARD.smem_sm


@pytest.mark.parametrize("b,d,f", [s for s in PLAN_SHAPES if s[2] % 16])
def test_plan_takes_split_k_where_w_rows_are_unaligned(b, d, f):
    p = _plan("planned", b, d, f)
    assert p.design == "split_k" and p.k_chunk == split_k(b, d, f, 132)
    assert plan(b, d, f, H100, False) == p


@pytest.mark.parametrize("b,d,f", PLAN_SHAPES[:4])
def test_plan_takes_wide_at_the_aligned_decode_shapes(b, d, f):
    # a power-of-two cluster whose grid runs in one wave at two blocks per
    # SM, the block's share whole in the ring; with x unaligned, split-K
    p = _plan("planned", b, d, f)
    assert p.design == "wide" and p.split in (1, 2, 4, 8)
    gx = p.grid(b, d, f)[0]
    assert gx <= 2 * 132 and (p.split == 8 or 2 * gx > 2 * 132)
    assert p.stages == min(p.k_chunk // 64, 8)
    assert plan(b, d, f, H100, False).design == "split_k"
