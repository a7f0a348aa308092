"""The port's nearest-code lookup (plain version on CPU), distances, STE and
quantizer losses against the JAX functions on the same numpy-made inputs:
the lookup against the JAX Pallas kernel in interpret mode (its own test
shapes) and against its XLA path at a wide code dimension. Also, on the
CPU, the Hopper kernel's arithmetic (TF32 splits, three tensor-core passes,
f32 sums) emulated in numpy against float64 scores, and its launch plan."""

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
from vector_quantization_tpu_torch.ops.device import H100, Card
from vector_quantization_tpu_torch.ops.distances import normalize, pairwise_distance
from vector_quantization_tpu_torch.ops.ste import ste
from vector_quantization_tpu_torch.ops.vq_lookup import (
    NEAR_TIE_REL_TOL,
    compare_codes,
    nearest_codes,
    plan,
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


@pytest.mark.parametrize("d", [8, 256])
@pytest.mark.parametrize("n,k", [(16384, 16384), (1, 16384), (1000, 777), (130, 64), (16384, 100)])
def test_k_splits_cover_the_codebook(n, k, d):
    # the kernel's grid: each block takes a run of 128-code tiles; the runs
    # cover the codebook once, none is empty, and at N = 16384 the grid fills
    # a 132-SM card's block slots (>= 90% of one wave) where the codebook has
    # the tiles
    p = plan(n, k, d, False, False, H100)
    k_tiles = -(-k // 128)
    assert 1 <= p.tiles_per_split <= k_tiles
    assert (p.splits - 1) * p.tiles_per_split < k_tiles <= p.splits * p.tiles_per_split
    assert p.row_tiles == -(-n // 128)
    slots = 132
    blocks = p.row_tiles * p.splits
    if n == 16384:
        assert p.splits == k_tiles or 0.9 * slots <= blocks <= slots
    assert p.splits == k_tiles or blocks >= min(0.9 * slots, p.row_tiles * k_tiles)


@pytest.mark.parametrize("d", [1, 8, 12, 40, 256, 1024, 4096])
@pytest.mark.parametrize("x_bf16,e_bf16", [(False, False), (False, True), (True, False), (True, True)])
def test_plan_fits_a_block(d, x_bf16, e_bf16):
    # one k-step holds x in registers; elsewhere x's tile stays in shared
    # memory while it fits beside the ring (every D up to 256 in f32), and
    # streams through the ring past that; a block never asks for more than
    # an H100 block's 232,448 bytes
    p = plan(16384, 16384, d, x_bf16, e_bf16, H100)
    assert p.k_steps == -(-d // 8)
    assert p.reg_x == (d <= 8)
    assert p.smem_bytes <= H100.smem_block
    if d <= 256:
        assert p.x_resident
    assert p.x_resident or d > 256
    assert p.workspace_bytes >= 16384 * 8 + 16384 * 4 + 16384 * p.k_steps * 8 * (2 if e_bf16 else 4)


@pytest.mark.parametrize("smem_block", [215_167, 160_000, 123_008])
def test_plan_streams_x_past_the_block_limit(smem_block):
    # at D = 256 in f32 the resident x tile and the ring take 215,168 bytes:
    # a card whose blocks may take less streams x's chunks through the ring
    # (123,008 bytes), with x's packed chunks in the workspace
    small = Card(H100.sms, H100.smem_sm, smem_block)
    resident = plan(16384, 16384, 256, False, False, H100)
    streamed = plan(16384, 16384, 256, False, False, small)
    assert resident.x_resident and resident.smem_bytes == 215_168
    assert not streamed.x_resident and streamed.smem_bytes == 123_008 <= smem_block
    assert streamed.workspace_bytes > resident.workspace_bytes


def _tf32(v):
    # cvt.rna.tf32.f32 on finite values: round the 13 dropped bits to
    # nearest, ties away from zero (sign and magnitude bits)
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _to_f32(v, rounding):
    # float64 -> float32, to nearest (even) or toward zero
    v = np.asarray(v, np.float64)
    r = v.astype(np.float32)
    if rounding == "toward_zero":
        away = np.abs(r.astype(np.float64)) > np.abs(v)
        r[away] = np.nextafter(r[away], np.float32(0))
    return r


def _prologue_esq(e):
    """The prologue's esq = 0.5 * ||e||^2 and its three TF32 parts: lane t
    of a quad sums dimensions 8 ks + t and 8 ks + t + 4 by fmaf (one
    rounding each), the quad adds its four sums by two shuffles, then
    hi = tf32(esq), (mid, lo) = the split of esq - hi."""
    k, d = e.shape
    ep = np.zeros((k, -(-d // 8) * 8), np.float32)
    ep[:, :d] = e

    def fma(a, s):
        return (a.astype(np.float64) * a + s).astype(np.float32)

    lanes = []
    for t in range(4):
        s = np.zeros(k, np.float32)
        for c in range(0, ep.shape[1], 8):
            s = fma(ep[:, c + t + 4], fma(ep[:, c + t], s))
        lanes.append(s)
    esq = np.float32(0.5) * ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
    hi = _tf32(esq)
    mid, lo = _split(esq - hi)
    return esq, hi, mid, lo


def _emulated_scores(x, e, rounding):
    """The Hopper kernel's scores esq - x.e in numpy: A = -x and e split into
    TF32 hi/lo; per 8-wide k-step the passes x_lo.e_hi, x_hi.e_lo and
    x_hi.e_hi (each product exact), then one more pass adding esq's three
    TF32 parts (A = 1 in three columns). Each pass sums its products and
    the accumulator exactly and rounds once to f32 (``rounding``: the
    tensor cores' rounding is not documented, so both are held)."""
    n, d = x.shape
    dp = -(-d // 8) * 8
    xp = np.zeros((n, dp), np.float32)
    ep = np.zeros((e.shape[0], dp), np.float32)
    xp[:, :d], ep[:, :d] = -x, e
    (xh, xl), (eh, el) = _split(xp), _split(ep)
    acc = np.zeros((n, e.shape[0]), np.float32)
    for s in range(0, dp, 8):
        for a, b in ((xl, eh), (xh, el), (xh, eh)):
            prod = a[:, s:s + 8].astype(np.float64) @ b[:, s:s + 8].astype(np.float64).T
            acc = _to_f32(acc + prod, rounding)
    _, hi, mid, lo = _prologue_esq(e)
    parts = hi.astype(np.float64) + mid + lo
    return _to_f32(acc + parts[None, :], rounding)


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("d", [8, 40, 256])
@pytest.mark.parametrize("rows", ["gaussian", "unit"])
def test_tf32_three_pass_scores_match_float64(d, rows, rounding):
    # the design's arithmetic lies well inside the near-tie rule: every
    # emulated score within a tenth of NEAR_TIE_REL_TOL * max|score| of the
    # float64 score; esq's three TF32 parts add up to it exactly; planted
    # duplicate codes give bit-equal scores
    rng = np.random.default_rng(d)
    x = rng.standard_normal((256, d), dtype=np.float32)
    e = rng.standard_normal((512, d), dtype=np.float32)
    if rows == "unit":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[1::2] = e[0::2]
    esq, hi, mid, lo = _prologue_esq(e)
    np.testing.assert_array_equal(((hi + mid) + lo).view(np.uint32), esq.view(np.uint32))
    np.testing.assert_array_equal(hi.astype(np.float64) + mid + lo, esq.astype(np.float64))
    got = _emulated_scores(x, e, rounding)
    x64, e64 = x.astype(np.float64), e.astype(np.float64)
    want = 0.5 * (e64 * e64).sum(axis=1)[None, :] - x64 @ e64.T
    assert np.abs(got - want).max() <= 0.1 * NEAR_TIE_REL_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got[:, 1::2], got[:, 0::2])
