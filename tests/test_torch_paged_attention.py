"""The port's paged decode attention (plain version on CPU) against the JAX
Pallas kernel in interpret mode, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from vector_quantization_tpu_torch.ops.paged_attention import decode_plan, paged_decode_attention


def _inputs(int8, *, b=6, h=2, dh=8, ps=4, n_layers=2, p_cap=3, seed=0):
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * (p_cap + 1)
    shape = (n_layers, num_pages, ps, h, dh)
    if int8:
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ksc = rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32)
        vsc = rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        ksc = vsc = None
    # non-contiguous page ids; the table is wider than the slice attended
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = table[: b * (p_cap + 1)].reshape(b, p_cap + 1)
    # lengths {0, 1, ps, ps+1, full} and one past the sliced table's reach
    lengths = np.array([0, 1, ps, ps + 1, p_cap * ps, p_cap * ps + 2], np.int32)[:b]
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    return q, k, v, ksc, vsc, table[:, :p_cap], lengths


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("layer", [0, 1])
def test_matches_jax_kernel(int8, layer):
    q, k, v, ksc, vsc, table, lengths = _inputs(int8)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = np.asarray(
        jax_paged_decode_attention(
            j(q), j(k), j(v), j(table), j(lengths), layer,
            k_scale_pool=j(ksc), v_scale_pool=j(vsc), interpret=True,
        )
    )
    got = paged_decode_attention(
        t(q), t(k), t(v), t(table), t(lengths), layer,
        k_scale_pool=t(ksc), v_scale_pool=t(vsc),
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got.numpy()[0] == 0)  # length-0 row


def test_sliced_table_view():
    # a page table that is a column slice of a wider one (the server's live
    # bucket) gives the same result as a compact copy
    q, k, v, ksc, vsc, table, lengths = _inputs(True, seed=3)
    wide = torch.from_numpy(np.concatenate([table, np.zeros_like(table)], axis=1))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    kw = dict(k_scale_pool=torch.from_numpy(ksc), v_scale_pool=torch.from_numpy(vsc))
    a = paged_decode_attention(*args, wide[:, : table.shape[1]], torch.from_numpy(lengths), 1, **kw)
    b = paged_decode_attention(*args, torch.from_numpy(table), torch.from_numpy(lengths), 1, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "b,h,dh,p_cap,ps,dtype",
    [
        (64, 16, 64, 5, 64, torch.int8),  # the serving decode step
        (64, 16, 64, 40, 16, torch.int8),
        (8, 16, 64, 1, 64, torch.int8),
        (1, 2, 64, 64, 16, torch.int8),
        (64, 16, 32, 5, 64, torch.int8),
        (16, 16, 128, 9, 16, torch.bfloat16),
        (16, 20, 64, 12, 4, torch.float32),
        (6, 2, 32, 3, 4, torch.float32),
        (3, 40, 128, 1000, 1, torch.float32),
    ],
)
def test_decode_plan_covers_pages(b, h, dh, p_cap, ps, dtype):
    # the CUDA kernel's plan (shapes only): every page of a row lies in
    # exactly one split, no split starts at or past p_cap, head groups cover
    # the heads, the chunk fits the kernel's score registers and the stages
    # fit shared memory, and the workspace is what the kernel indexes
    plan = decode_plan(b, h, dh, p_cap, ps, dtype, 132)
    pages = [p for s in range(plan.splits)
             for p in range(s * plan.pages_per_split, min((s + 1) * plan.pages_per_split, p_cap))]
    assert pages == list(range(p_cap))
    assert all(s * plan.pages_per_split < p_cap for s in range(plan.splits))
    assert plan.groups * plan.heads_per_group >= h > (plan.groups - 1) * plan.heads_per_group
    assert plan.heads_per_group <= 16
    row = dh * torch.empty((), dtype=dtype).element_size()
    lanes_per_pos = row // 16
    assert 1 <= plan.chunk <= min(ps, 4 * 32 // lanes_per_pos)
    assert plan.pitch % 16 == 0 and plan.pitch >= plan.heads_per_group * row
    scales = 8 * plan.heads_per_group if dtype == torch.int8 else 0
    assert plan.stage_bytes % 16 == 0 and plan.stage_bytes >= plan.chunk * (2 * plan.pitch + scales)
    assert 1 <= plan.stages <= 4
    assert plan.smem_bytes == plan.stages * plan.stage_bytes <= 232_448
    # kernel indexes: o sums (B, S, H, Dh), then (m, l) per (B, S, H)
    if plan.splits > 1:
        assert plan.workspace == b * plan.splits * h * dh + 2 * b * plan.splits * h
    else:
        assert plan.workspace == 0
