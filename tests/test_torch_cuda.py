"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (decided inside the
fixture, never at import). On a GPU machine without JAX run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``tests/conftest.py`` imports JAX).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vector_quantization_tpu_torch.models.transformers.gpt2 import GPT2Transformer
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.ops import f32_gemm as fg
from vector_quantization_tpu_torch.ops import flash_attention as fa
from vector_quantization_tpu_torch.ops import int8_matmul as im
from vector_quantization_tpu_torch.ops.int8_matmul import (
    int8_matmul,
    int8_matmul_reference,
)
from vector_quantization_tpu_torch.ops.paged_attention import (
    decode_plan,
    paged_decode_attention,
    paged_decode_attention_reference,
)
from vector_quantization_tpu_torch.ops.vq_lookup import (
    compare_codes,
    nearest_codes,
    nearest_codes_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _forced_plan(design, x, w):
    # the design's own plan at this shape, whatever plan() would pick; None
    # where the wide or ragged design does not take the shape
    (b, d), f = x.shape, w.shape[1]
    card = im.card(x.device)
    if design == "split_k":
        return im.split_k_plan(b, d, f, card.sms)
    x_aligned = x.data_ptr() % 16 == 0 and d % 8 == 0
    if design == "ragged":
        return im.ragged_plan(b, d, f, card) if x_aligned else None
    aligned = x_aligned and w.data_ptr() % 16 == 0 and f % 16 == 0
    return im.wide_plan(b, d, f, card) if aligned else None


def _int8_inputs(dev, b, d, f, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, f).astype(np.float32)).to(dev)
    return x, w, s


@pytest.mark.parametrize("design", ["split_k", "wide"])
@pytest.mark.parametrize(
    "b,d,f",
    [
        (64, 1024, 3072), (64, 1024, 1024), (64, 1024, 5632),
        (64, 2816, 1024), (64, 1024, 17385),
        (1, 1024, 3072), (7, 2816, 1024), (3, 100, 37), (130, 96, 200),
        # D not a multiple of the 128-row stage; B over one 64-row tile;
        # ragged F (rows not 16-byte aligned); D deeper than the x window
        (64, 1000, 777), (130, 1000, 17385), (5, 100, 37), (64, 20000, 256),
    ],
)
def test_int8_matmul_kernel_matches_plain(dev, design, b, d, f):
    # bf16 inputs, exact bf16*int8 products, f32 sums in another order; each
    # design forced at every shape it takes; where the wide design does not
    # take the shape (rows not 16-byte aligned, or a share too deep for
    # shared memory), a wide launch is refused
    x, w, s = _int8_inputs(dev, b, d, f, b * 7 + d + f)
    p = _forced_plan(design, x, w)
    if p is None:
        tiles = -(-d // 64)
        forced = im.Plan("wide", 128, 8, 64, 2, -(-tiles // 8) * 64)
        with pytest.raises(RuntimeError):
            im._launch(x, w, s, forced)
        return
    before = int8_matmul.launches
    got = im._launch(x, w, s, p)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, f)
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


def test_int8_matmul_launches_the_planned_kernel(dev):
    # the public entry launches plan_for's design at each decode shape and
    # counts it under that design
    for d, f in [(1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024), (1024, 17385)]:
        x, w, s = _int8_inputs(dev, 64, d, f, d + f)
        p = im.plan_for(x, w)
        before = dict(int8_matmul.design_launches)
        got = int8_matmul(x, w, s)
        torch.cuda.synchronize()
        assert p.design == ("ragged" if f % 16 else "wide")
        assert int8_matmul.design_launches[p.design] == before[p.design] + 1
        assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize(
    "design,d,f",
    [("split_k", 1024, 3072), ("split_k", 2816, 1024), ("split_k", 1024, 17385),
     ("wide", 1024, 5632), ("wide", 1024, 1024), ("ragged", 1024, 17385), ("ragged", 1000, 777)],
)
def test_int8_matmul_graph_replays_match_plain(dev, design, d, f):
    # one call of each design (the split-K design with its zeroed output
    # at 4, 11 and 2 splits, the wide design's cluster launch, the ragged
    # design's tensor map of x) captured in a CUDA graph; x changed in place
    # between replays: each replay matches the plain version on the new x
    # (nothing carries over between launches)
    x, w, s = _int8_inputs(dev, 64, d, f, 3)
    p = _forced_plan(design, x, w)
    rng = np.random.default_rng(4)
    im._launch(x, w, s, p)  # warm-up: build
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im._launch(x, w, s, p)
    for _ in range(2):
        x.copy_(torch.from_numpy(rng.standard_normal((64, d), dtype=np.float32)))
        g.replay()
        torch.cuda.synchronize()
        assert _rel_err(out, int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize("split", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("d,f", [(1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024)])
def test_int8_matmul_plan_smem_matches_kernel(dev, split, d, f):
    # the plan's reckoning of shared memory is the kernel's, and an SM
    # holds the blocks the plan counted on (None: the shipped plan; else
    # that cluster size, ring of 2); past the card's limit the kernel
    # refuses the plan, as a launch would
    x, w, _ = _int8_inputs(dev, 64, d, f, 5)
    p = _forced_plan("wide", x, w)
    if split is not None:
        p = im.Plan("wide", 128, split, 64, 2, -(-(-(-d // 64)) // split) * 64)
    if p.smem() > im.card(dev).smem_block:
        with pytest.raises(RuntimeError):
            im.occupancy(p, 64, d, f)
        return
    occ = im.occupancy(p, 64, d, f)
    assert occ["dynamic_smem"] == p.smem()
    if split is None:
        gx, gy, gz = p.grid(64, d, f)
        assert occ["blocks_per_sm"] >= -(-gx * gy * gz // im.card(dev).sms)


@pytest.mark.parametrize("split,stages", [(1, 2), (1, 8), (2, 3), (4, 2), (4, 5), (8, 2)])
@pytest.mark.parametrize("b,d,f", [(64, 1024, 1024), (130, 1000, 208), (5, 192, 48)])
def test_int8_matmul_wide_plans_match_plain(dev, split, stages, b, d, f):
    # the wide kernel at every cluster size, with a ring shallower than a
    # block's share (slots refilled), ragged D (1000), a partial last column
    # stripe (208, 48), two row tiles (130), and more cluster blocks than
    # k tiles (192: 3 tiles)
    x, w, s = _int8_inputs(dev, b, d, f, split + stages)
    share = -(-(-(-d // 64)) // split)
    got = im._launch(x, w, s, im.Plan("wide", 128, split, 64, stages, share * 64))
    torch.cuda.synchronize()
    assert got.shape == (b, f)
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize(
    "b,d,f",
    [
        # the prefill's gate/up (unfused), head and down at 8256 rows
        (8256, 1024, 2816), (8256, 1024, 17385), (8256, 2816, 1024),
        # ragged B and F (rows not 16-byte aligned), a partial last row tile,
        # D deeper than 20,000; D = 100 (x's rows not 16-byte aligned: the
        # wrapper pads them)
        (130, 1000, 17385), (257, 96, 200), (300, 1000, 777), (129, 20000, 256), (257, 100, 37),
    ],
)
def test_int8_matmul_tiled_matches_plain(dev, b, d, f):
    # the tiled design forced at each shape: TMA-loaded weight tiles where
    # F % 16 == 0, the unaligned rows' copy-and-shift elsewhere
    x, w, s = _int8_inputs(dev, b, d, f, b * 3 + d + f)
    before = dict(int8_matmul.design_launches)
    got = im._launch(x, w, s, im.tiled_plan(b, d, f))
    torch.cuda.synchronize()
    assert int8_matmul.design_launches["tiled"] == before["tiled"] + 1
    assert got.dtype == torch.float32 and got.shape == (b, f)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


def test_int8_matmul_public_call_at_8256_rows_is_tiled(dev):
    # the prefill's rows through the public entry: planned, launched and
    # counted as the tiled design
    x, w, s = _int8_inputs(dev, 8256, 1024, 5632, 11)
    assert im.plan_for(x, w).design == "tiled"
    before = dict(int8_matmul.design_launches)
    got = int8_matmul(x.reshape(64, 129, 1024), w, s)
    torch.cuda.synchronize()
    assert got.shape == (64, 129, 5632)
    after = dict(int8_matmul.design_launches)
    assert {k: after[k] - before[k] for k in after} == {"split_k": 0, "wide": 0, "tiled": 1, "ragged": 0}
    assert _rel_err(got.reshape(8256, 5632), int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize("d,f", [(1024, 3072), (1024, 17385)])
def test_int8_matmul_tiled_graph_replays_match_plain(dev, d, f):
    # one tiled call (TMA weight tiles; the unaligned head's rows) captured
    # in a CUDA graph, x changed in place between replays: each replay
    # matches the plain version on the new x
    b = 8256
    x, w, s = _int8_inputs(dev, b, d, f, 5)
    p = im.tiled_plan(b, d, f)
    rng = np.random.default_rng(6)
    im._launch(x, w, s, p)  # warm-up: build
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = im._launch(x, w, s, p)
    for _ in range(2):
        x.copy_(torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)))
        g.replay()
        torch.cuda.synchronize()
        assert _rel_err(out, int8_matmul_reference(x, w, s)) <= 1e-3


def test_int8_matmul_tiled_smem_matches_kernel(dev):
    # the plan's reckoning of shared memory is the kernel's, and one block
    # fits an SM
    p = im.tiled_plan(8256, 1024, 2816)
    occ = im.occupancy(p, 8256, 1024, 2816)
    assert occ["dynamic_smem"] == p.smem() and occ["blocks_per_sm"] >= 1


@pytest.mark.parametrize(
    "b,d,f,n,stages",
    [
        # the decode lm head at its plan, at 1, 7, 64 and 130 rows (a second
        # row tile), and under the other column tile and a shallow ring
        (64, 1024, 17385, 144, 3), (1, 1024, 17385, 144, 3), (7, 1024, 17385, 144, 3),
        (130, 1024, 17385, 144, 3), (64, 1024, 17385, 128, 3), (64, 1024, 17385, 128, 4),
        # ragged F (a short last stripe, one stripe), D not a multiple of the
        # 256-deep x chunk or the 64-deep stage (an odd number of stages: one
        # warpgroup of a column group has one stage fewer; D = 64: none),
        # aligned rows
        (64, 1000, 777, 128, 4), (5, 1000, 37, 144, 3), (5, 104, 37, 128, 3), (3, 96, 33, 144, 3),
        (64, 2816, 1025, 144, 3), (64, 1024, 3072, 128, 3), (9, 64, 40, 144, 3),
    ],
)
def test_int8_matmul_ragged_matches_plain(dev, b, d, f, n, stages):
    # the ragged design forced: each warp's covering words shifted into
    # place, x by TMA in 256-deep chunks, the four k16 steps' images summed
    # into the output at its unaligned pitch
    x, w, s = _int8_inputs(dev, b, d, f, b + d + f + n + stages)
    p = im.Plan("ragged", n, 1, 64, stages, -(-d // 64) * 64)
    before = dict(int8_matmul.design_launches)
    got = im._launch(x, w, s, p)
    torch.cuda.synchronize()
    assert int8_matmul.design_launches["ragged"] == before["ragged"] + 1
    assert got.dtype == torch.float32 and got.shape == (b, f) and bool(torch.isfinite(got).all())
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize("base", [1, 3, 8, 15])
def test_int8_matmul_ragged_takes_any_weight_base(dev, base):
    # the head's weight as a view `base` bytes into its storage: every row at
    # another offset than in a fresh tensor
    x, w, s = _int8_inputs(dev, 64, 1024, 17385, base)
    wv = torch.empty(1024 * 17385 + base, dtype=torch.int8, device=dev)[base:].view(1024, 17385)
    wv.copy_(w)
    assert wv.data_ptr() % 16 == base % 16
    got = im._launch(x, wv, s, im.ragged_plan(64, 1024, 17385, im.card(dev)))
    torch.cuda.synchronize()
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


def test_int8_matmul_ragged_refuses_unaligned_x(dev):
    # x's rows at D = 100 (200 bytes) cannot be read by TMA: the launch is
    # refused, and plan() gives the shape to split-K
    x, w, s = _int8_inputs(dev, 5, 100, 37, 9)
    with pytest.raises(RuntimeError):
        im._launch(x, w, s, im.Plan("ragged", 128, 1, 64, 8, 128))
    assert im.plan_for(x, w).design == "split_k"


def test_int8_matmul_public_head_is_ragged(dev):
    # the decode lm head through the public entry (leading dims as the
    # model's): planned, launched and counted as the ragged design
    x, w, s = _int8_inputs(dev, 64, 1024, 17385, 21)
    assert im.plan_for(x, w) == im.ragged_plan(64, 1024, 17385, im.card(dev))
    before = dict(int8_matmul.design_launches)
    got = int8_matmul(x.reshape(64, 1, 1024), w, s)
    torch.cuda.synchronize()
    after = dict(int8_matmul.design_launches)
    assert {k: after[k] - before[k] for k in after} == {"split_k": 0, "wide": 0, "tiled": 0, "ragged": 1}
    assert got.shape == (64, 1, 17385)
    assert _rel_err(got.reshape(64, 17385), int8_matmul_reference(x, w, s)) <= 1e-3


@pytest.mark.parametrize("n,stages", [(144, 3), (144, 4), (128, 3), (128, 4), (128, 5)])
def test_int8_matmul_ragged_smem_matches_kernel(dev, n, stages):
    # the plan's reckoning of shared memory is the kernel's, and one block
    # fits an SM; past the card's limit the kernel refuses the plan, as a
    # launch would
    p = im.Plan("ragged", n, 1, 64, stages, 1024)
    if p.smem() > im.card(dev).smem_block:
        with pytest.raises(RuntimeError):
            im.occupancy(p, 64, 1024, 17385)
        return
    occ = im.occupancy(p, 64, 1024, 17385)
    assert occ["dynamic_smem"] == p.smem() and occ["blocks_per_sm"] >= 1


def _paged_inputs(dev, *, pool_dtype, q_dtype, b=64, h=16, dh=64, ps=64,
                  n_layers=3, p_cap=5, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * p_cap
    shape = (n_layers, num_pages, ps, h, dh)
    if pool_dtype == torch.int8:
        k = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        ksc = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32))
        vsc = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32))
        ksc, vsc = ksc.to(dev), vsc.to(dev)
    else:
        k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(pool_dtype)
        v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(pool_dtype)
        ksc = vsc = None
    # non-contiguous page ids, a table wider than the slice passed in
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = torch.from_numpy(np.resize(perm, b * (p_cap + 2)).reshape(b, p_cap + 2))
    if lengths is None:
        lengths = rng.integers(0, p_cap * ps + 1, b).astype(np.int32)
        lengths[:6] = [0, 1, ps, ps + 1, p_cap * ps, 2]
    lengths = np.asarray(lengths, np.int32)
    q = torch.from_numpy(rng.standard_normal((b, h, dh), dtype=np.float32)).to(q_dtype)
    return dict(
        q=q.to(dev), k=k.to(dev), v=v.to(dev), ksc=ksc, vsc=vsc,
        table=table.to(dev)[:, :p_cap], lengths=torch.from_numpy(lengths).to(dev),
    )


@pytest.mark.parametrize(
    "pool_dtype,q_dtype,dh,ps,tol",
    [
        (torch.int8, torch.bfloat16, 64, 64, 1e-4),
        (torch.int8, torch.float32, 64, 4, 1e-4),
        (torch.bfloat16, torch.bfloat16, 64, 64, 2e-3),
        (torch.float32, torch.float32, 32, 16, 1e-4),
        (torch.int8, torch.bfloat16, 128, 64, 1e-4),
    ],
)
def test_paged_attention_kernel_matches_plain(dev, pool_dtype, q_dtype, dh, ps, tol):
    t = _paged_inputs(dev, pool_dtype=pool_dtype, q_dtype=q_dtype, dh=dh, ps=ps, h=4 if dh == 128 else 16)
    kw = dict(k_scale_pool=t["ksc"], v_scale_pool=t["vsc"])
    args = (t["q"], t["k"], t["v"], t["table"], t["lengths"], 1)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_reference(*args, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))
    # length-0 rows give exactly 0
    assert torch.all(got[0] == 0)


def _paged_close(t, tol, layer=1):
    kw = dict(k_scale_pool=t["ksc"], v_scale_pool=t["vsc"])
    args = (t["q"], t["k"], t["v"], t["table"], t["lengths"], layer)
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = paged_decode_attention_reference(*args, **kw)
    assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))
    return got


@pytest.mark.parametrize(
    "pool_dtype,b,h,dh,ps,p_cap",
    [
        (torch.int8, 64, 16, 64, 16, 40),  # several pages per split
        (torch.int8, 64, 16, 64, 64, 5),  # the path shape: one page per split
        (torch.int8, 8, 16, 64, 64, 1),  # p_cap 1: one split
        (torch.int8, 1, 2, 64, 16, 64),  # one row owns every block
        (torch.int8, 64, 16, 32, 64, 5),
        (torch.bfloat16, 16, 16, 128, 16, 9),
        (torch.float32, 16, 20, 64, 4, 12),  # two head groups, ps 4
    ],
)
def test_paged_attention_split_edges_match_plain(dev, pool_dtype, b, h, dh, ps, p_cap):
    # lengths at and one past split boundaries, a split of exactly one page,
    # the whole table and past it; the row's splits combined by the second
    # launch (or written directly with one split)
    plan = decode_plan(b, h, dh, p_cap, ps, pool_dtype,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    span = plan.pages_per_split * ps
    edge = [0, 1, ps, ps + 1, span - 1, span, span + 1, 2 * span + 1, p_cap * ps, p_cap * ps + 3]
    rng = np.random.default_rng(b + p_cap)
    lengths = np.resize(np.array(edge), b) if b > 1 else np.array([p_cap * ps - 1])
    lengths = np.minimum(lengths, p_cap * ps + 3)
    lengths[len(edge):] = rng.integers(0, p_cap * ps + 1, max(0, b - len(edge)))
    t = _paged_inputs(dev, pool_dtype=pool_dtype, q_dtype=torch.bfloat16, b=b, h=h, dh=dh,
                      ps=ps, p_cap=p_cap, lengths=lengths, n_layers=2)
    got = _paged_close(t, 1e-4 if pool_dtype != torch.bfloat16 else 2e-3)
    if b > 1:
        assert torch.all(got[0] == 0)


def test_paged_attention_graph_replays_match_plain(dev):
    # one call captured in a CUDA graph; lengths and page table changed in
    # place between replays: each replay matches the plain version on the
    # new inputs (nothing carries over between launches)
    t = _paged_inputs(dev, pool_dtype=torch.int8, q_dtype=torch.bfloat16)
    kw = dict(k_scale_pool=t["ksc"], v_scale_pool=t["vsc"])
    args = (t["q"], t["k"], t["v"], t["table"], t["lengths"], 2)
    paged_decode_attention(*args, **kw)  # warm-up: build, workspace
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = paged_decode_attention(*args, **kw)
    rng = np.random.default_rng(7)
    for _ in range(2):
        n_pages = t["k"].shape[1]
        t["lengths"].copy_(torch.from_numpy(rng.integers(0, 5 * 64 + 1, 64).astype(np.int32)))
        t["table"].copy_(torch.from_numpy(
            rng.integers(1, n_pages, t["table"].shape).astype(np.int32)))
        g.replay()
        torch.cuda.synchronize()
        want = paged_decode_attention_reference(*args, **kw)
        assert float((out - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize(
    "n,k,d,dtype,e_dtype,metric,rows",
    [
        (16384, 16384, 8, _F32, _F32, "l2", "gaussian"),  # the tokenizer's lookup
        (16384, 16384, 8, _BF16, _BF16, "l2", "gaussian"),
        (16384, 16384, 8, _F32, _F32, "l2", "unit"),  # what the LlamaGen quantizer feeds
        (3072, 16384, 8, _F32, _F32, "l2", "unit"),  # the LlamaGen VQGAN train step's (batch 12)
        (3072, 16384, 8, _F32, _BF16, "l2", "unit"),  # the same with a bf16 codebook
        (4096, 256, 32, _F32, _F32, "l2", "gaussian"),  # the regression train anchor's (batch 16, 32 px)
        (16384, 16384, 256, _F32, _F32, "l2", "gaussian"),
        (1000, 777, 40, _F32, _F32, "cosine", "gaussian"),
        (1, 16384, 8, _F32, _F32, "l2", "gaussian"),
        (4096, 1000, 8, _F32, _F32, "l2", "ties"),
        (4096, 1000, 8, _BF16, _BF16, "l2", "ties"),
        (4096, 1000, 1, _F32, _F32, "l2", "gaussian"),  # D padded from 1 to 8
        (4096, 1000, 12, _F32, _F32, "l2", "gaussian"),  # two k-steps, the second half zero
        (4096, 1000, 12, _BF16, _BF16, "l2", "gaussian"),  # rows not 16-byte multiples
        (4096, 3000, 8, _F32, _BF16, "l2", "gaussian"),  # two passes
        (4096, 3000, 8, _BF16, _F32, "l2", "gaussian"),
        (4096, 1000, 40, _F32, _BF16, "l2", "ties"),
        (4096, 1000, 40, _BF16, _F32, "l2", "ties"),
        (16384, 100, 8, _F32, _F32, "l2", "gaussian"),  # fewer code tiles than the grid wants splits
        (1000, 300, 512, _F32, _F32, "l2", "gaussian"),  # x streamed through the ring
        (12544, 8192, 32, _F32, _F32, "cosine", "unit"),  # VQ-KD's step (batch 64 at 224 px)
        (12544, 8192, 32, _F32, _F32, "l2", "unit"),  # VQ-KD's lazy k-means init
        (12544, 8192, 768, _F32, _F32, "l2", "gaussian"),  # Cluster's step: x streamed
        (3072, 8192, 256, _F32, _F32, "l2", "gaussian"),  # the StyleGAN2 VQGAN's step (batch 12)
        (3072, 8192, 256, _F32, _F32, "cosine", "gaussian"),  # CVQ-VAE's step (batch 12)
        (16384, 8192, 256, _F32, _F32, "l2", "gaussian"),  # the linear probe's IR (batch 64)
    ],
)
def test_nearest_codes_kernel_matches_plain(dev, n, k, d, dtype, e_dtype, metric, rows):
    # TF32 splits and f32 sums in another order: rows may differ only as
    # near-ties (compare_codes); planted exact ties go to the lowest index
    # exactly
    rng = np.random.default_rng(n + k + d)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = rng.standard_normal((k, d), dtype=np.float32)
    if rows == "unit":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
    ties = rows == "ties"
    if ties:
        e[1::2] = e[0::2][: k // 2]
        x[::3] = e[rng.integers(0, k // 2, x[::3].shape[0]) * 2]
    x = torch.from_numpy(x).to(dev, dtype)
    e = torch.from_numpy(e).to(dev, e_dtype)
    before = nearest_codes.launches
    got = nearest_codes(x, e, metric)
    torch.cuda.synchronize()
    assert nearest_codes.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = nearest_codes_reference(x, e, metric)
    rep = compare_codes(x, e, got, want, metric)
    assert rep["ok"], rep
    if ties:
        planted = torch.arange(0, n, 3, device=dev)
        assert torch.equal(got[planted], want[planted])
        assert bool((got[planted] % 2 == 0).all())


@pytest.mark.parametrize(
    "shape",
    [(64, 257, 16, 64), (4, 1, 8, 64), (4, 63, 8, 64), (4, 129, 8, 64), (4, 300, 8, 64),
     (1, 257, 1, 64), (4, 200, 8, 32), (4, 200, 8, 128),
     # end-aligned tiles: tile 0 holds 2, 64, 1, 64 and 64 live rows (64:
     # no partial tile); T = 257 at Dh 32 and 128
     (4, 2, 8, 64), (4, 64, 8, 64), (4, 65, 8, 64), (4, 128, 8, 64), (4, 256, 8, 64),
     (4, 257, 8, 32), (4, 257, 8, 128),
     # heads longer than the forward keeps in shared memory: k/v tiles stream
     (2, 1000, 4, 64), (2, 700, 2, 128), (1, 2000, 2, 32),
     # the longest heads whose q/dO tiles the dK/dV kernel keeps resident,
     # and one row more (its q/dO tiles stream through a ring)
     (2, 640, 4, 64), (2, 641, 4, 64), (2, 256, 4, 128), (2, 1472, 2, 32), (2, 1473, 2, 32),
     # the longest head whose k/v tiles the dQ kernel keeps resident, and one row more
     (2, 704, 4, 64), (2, 705, 4, 64)],
)
def test_flash_attention_kernels_match_plain(dev, shape):
    # o: within 2e-3 of max(1, max|ref|) beyond one bf16 step per element
    # (each version rounds its f32 result once); lse within 1e-4; dq/dk/dv
    # within 1e-2 of max(1, max|ref|), both versions fed the kernel's o, lse
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
                   for _ in range(4)]
    counts = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    o, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == tuple(c + 1 for c in counts)
    ro, rl = fa.flash_attention_reference(q, k, v)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and lse.shape == (shape[0], shape[2], shape[1])
    assert fa.excess_over_bf16_step(o, ro) <= 2e-3
    assert float((lse - rl).abs().max()) <= 1e-4
    for g, r in zip(grads, fa.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - r.float()).abs().max()) <= 1e-2 * max(1.0, float(r.float().abs().max()))


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_bwd_dkv_plan_fits_at_t257(dev, dh):
    # the training length: the dK/dV kernel's shared memory fits a block
    # (227 KB on Hopper) and at least one block is resident per SM
    plan = fa.flash_bwd_dkv_plan(257, dh)
    assert 0 < plan["dynamic_smem"] <= 227 * 1024
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_bwd_dq_plan_fits_at_t257(dev, dh):
    # the dQ kernel likewise
    plan = fa.flash_bwd_dq_plan(257, dh)
    assert 0 < plan["dynamic_smem"] <= 227 * 1024
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("shape", [(64, 257, 16, 64), (4, 1, 8, 64), (4, 65, 8, 64),
                                   (2, 705, 4, 64), (4, 200, 8, 32), (2, 300, 2, 128)])
def test_flash_dq_di_matches_plain(dev, shape):
    # the dQ kernel's di = sum(o dO) against the plain _di: f32 sums of the
    # same exact bf16 products in another order, within 1e-5 of
    # max(1, max|ref|); at T 705 the k/v tiles stream through the ring
    rng = np.random.default_rng(sum(shape) + 1)
    q, k, v, do = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
                   for _ in range(4)]
    o, lse = fa.flash_attention_fwd(q, k, v)
    before = fa.flash_bwd_dq.launches
    dq, di = fa.flash_bwd_dq(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 1
    ref = fa._di(o, do)
    assert di.dtype == torch.float32 and di.shape == ref.shape == (shape[0], shape[2], shape[1])
    assert float((di - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    rq, _, _ = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    assert float((dq.float() - rq.float()).abs().max()) <= 1e-2 * max(1.0, float(rq.float().abs().max()))


def test_flash_attention_refuses_f32_on_cuda(dev):
    x = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_fwd(x, x, x)


def test_flash_attention_refuses_misaligned_inputs(dev):
    # a bf16 view one element into its buffer is contiguous but not 16-byte
    # aligned: the forward refuses it (tensor-map loads need 16-byte
    # alignment) and launches nothing
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    x = buf[1:n + 1].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    y = buf[8:].view(shape)
    before = fa.flash_attention_fwd.launches
    for args in ((x, y, y), (y, x, y), (y, y, x)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fa.flash_attention_fwd(*args)
    assert fa.flash_attention_fwd.launches == before
    o, _ = fa.flash_attention_fwd(y, y, y)  # the aligned view runs
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())


@pytest.mark.parametrize("kernel", ["flash_bwd_dkv", "flash_bwd_dq"])
def test_flash_backward_refuses_misaligned_inputs(dev, kernel):
    # the backward kernels refuse a q, k, v or dO base that is not 16-byte
    # aligned (they read them by TMA), and the dQ kernel an o that is not (it
    # reads o 16 bytes at a time), and launch nothing
    fn = getattr(fa, kernel)
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    x, y = buf[1:n + 1].view(shape), buf[8:].view(shape)
    lse = torch.zeros((1, 2, 64), device=dev)
    if kernel == "flash_bwd_dkv":  # (q, k, v, dO, lse, di)
        cases = [(x, y, y, y, lse, lse), (y, x, y, y, lse, lse), (y, y, x, y, lse, lse),
                 (y, y, y, x, lse, lse)]
        aligned = (y, y, y, y, lse, lse)
    else:  # (q, k, v, o, dO, lse)
        cases = [(x, y, y, y, y, lse), (y, x, y, y, y, lse), (y, y, x, y, y, lse),
                 (y, y, y, x, y, lse), (y, y, y, y, x, lse)]
        aligned = (y, y, y, y, y, lse)
    before = fn.launches
    for args in cases:
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(*args)
    assert fn.launches == before
    out = fn(*aligned)  # the aligned views run
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert all(bool(torch.isfinite(t.float()).all()) for t in out)


def test_llama_flash_remat_launches_kernels_only(dev):
    # per train step: the forward kernel once per block and once more per
    # block in the remat re-run; each backward kernel once per block
    model = LlamaTransformer(vocabulary_size=300, hidden_size=128, num_layers=3, num_heads=2,
                             ffn_dim=256, dtype="bfloat16", remat=True, flash=True).to(dev)
    with torch.no_grad():
        model.lm_head.normal_(0.0, 0.02)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (4, 257))).to(dev)
    before = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
              fa.flash_attention_reference.cuda_calls, fa.flash_attention_bwd_reference.cuda_calls)
    loss = model(tokens, fused_ce_targets=tokens)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
             fa.flash_attention_reference.cuda_calls, fa.flash_attention_bwd_reference.cuda_calls)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 3, 3, 0, 0)
    assert torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("b,d,f", [(64, 1024, 2816), (8256, 1024, 2816)])
def test_int8_matmul_dense_decode_shapes_match_plain(dev, b, d, f):
    # generate()'s unfused gate/up at B = 64, and the INT8 cache-free
    # forward (64 rows x 129 positions) at B * T = 8256
    x, w, s = _int8_inputs(dev, b, d, f, seed=b)
    before = int8_matmul.launches
    got = int8_matmul(x, w, s)
    want = int8_matmul_reference(x, w, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert _rel_err(got, want) <= 1e-3


def test_dense_decode_step_kernels_match_plain(dev):
    # a small-width INT8 model over the dense INT8 cache: prefill, then one
    # step, through the kernels and through the plain versions on the card
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod

    torch.manual_seed(0)
    model = LlamaTransformer(vocabulary_size=300, hidden_size=128, num_layers=2, num_heads=2,
                             ffn_dim=256, max_length=40, dtype="bfloat16", quantize=True,
                             fused_qkv=True).to(dev).eval()
    with torch.no_grad():  # the INT8 head starts at zero
        model.lm_head_int8.copy_(torch.randint(-127, 128, model.lm_head_int8.shape))
        model.lm_head_scale.uniform_(1e-3, 2e-2)
    rng = np.random.default_rng(0)
    prefix = torch.from_numpy(rng.integers(0, 300, (8, 5)).astype(np.int32)).to(dev)
    step = torch.from_numpy(rng.integers(0, 300, (8, 1)).astype(np.int32)).to(dev)

    def run():
        with torch.inference_mode():
            cache = model.init_cache(8, dtype=torch.int8)
            _, cache = model(prefix, cache)
            return model(step, cache)[0]

    before = (int8_matmul.launches, int8_matmul_reference.cuda_calls)
    got = run()
    torch.cuda.synchronize()
    # 2 prefill/step forwards x (4 projections x 2 layers + the head)
    assert (int8_matmul.launches - before[0], int8_matmul_reference.cuda_calls - before[1]) == (18, 0)
    saved = llama_mod.int8_matmul
    llama_mod.int8_matmul = int8_matmul_reference
    try:
        want = run()
    finally:
        llama_mod.int8_matmul = saved
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.9


def test_vqgan_gan_step_on_card_matches_cpu(dev):
    # a small-width VQGANAlgorithm (the smoke anchor's widths, l1 + LPIPS,
    # the spherical codebook re-normalised) with the GAN on: one train step
    # on the card against the same step with device="cpu", cuDNN's TF32
    # off (the fixture): losses within 1e-3 relative, the lookup's codes
    # equal except near-ties
    from pathlib import Path

    from vector_quantization_tpu_torch.ops.distances import normalize
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parents[1] / "configs/regression/smoke_anchor.py"))
    cfg = cfg["trainer"]["algorithm"]
    cfg.update(recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)), codebook_update=dict(type="normalize"),
               discriminator_start=10)
    cfg["model"]["quantizer"]["normalize_inputs"] = True
    torch.manual_seed(0)
    cpu = AlgorithmRegistry.build(cfg, device="cpu")
    card = AlgorithmRegistry.build(cfg, device=dev)
    for a, b in ((cpu.model, card.model), (cpu.discriminator, card.discriminator),
                 (cpu.lpips_module, card.lpips_module)):
        b.load_state_dict(a.state_dict())
    image = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        feat = cpu.model.encode(image).reshape(-1, 16)
        want = cpu.model.encode_to_quant(image)
        got = card.model.encode_to_quant(image.to(dev)).cpu()
    rep = compare_codes(normalize(feat), cpu.model.quantizer.effective_codebook(), got, want)
    assert rep["ok"], rep
    s_cpu, s_card = cpu.init_state(0), card.init_state(0)
    s_cpu.step = s_card.step = 10
    before = (nearest_codes.launches, nearest_codes_reference.cuda_calls)
    _, m_cpu = cpu.train_step(s_cpu, {"image": image})
    _, m_card = card.train_step(s_card, {"image": image.to(dev)})
    torch.cuda.synchronize()
    assert (nearest_codes.launches - before[0], nearest_codes_reference.cuda_calls - before[1]) == (1, 0)
    assert set(m_cpu) == set(m_card)
    for name, want_v in m_cpu.items():
        w, g = float(want_v), float(m_card[name])
        assert np.isfinite(g) and abs(g - w) <= 1e-3 * abs(w), (name, g, w)
    assert float(m_card["d_loss"]) > 0 and float(m_card["aglw"]) != 0.8


def test_vqkd_steps_on_card_match_cpu(dev, monkeypatch):
    # a tiny VQ-KD (configs/vqkd/clip_8192_imagenet_ddp.py's algorithm, the
    # models cut to img 32, patch 8, embed 32, depth 2, K 16, D 8; warm-up
    # cut so the weights move) on the card against the same with
    # device="cpu", the lazy k-means init fed one start: two steps, K1
    # launched 1 + 10 times on the first (the init's 10 iterations) and once
    # on the second, no plain lookup on the card; losses and the codebook
    # within 1e-3
    from pathlib import Path

    from vector_quantization_tpu_torch.ops import codebook as cb
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parents[1] / "configs/vqkd/clip_8192_imagenet_ddp.py"))
    cfg = cfg["trainer"]["algorithm"]
    tiny = dict(embed_dim=32, depth=2, num_heads=2)
    model = cfg["model"]
    model["encoder"].update(img_size=32, patch_size=8, out_channels=8, **tiny)
    model["quantizer"].update(codebook_size=16, embedding_dim=8)
    model["pre_decode"].update(out_channels=8)
    model["decoder"].update(img_size=4, in_channels=8, out_channels=16, **tiny)
    cfg["teacher"].update(patch_size=8, proj_dim=16, img_size=32, **tiny)
    cfg["optimizer"]["schedule"]["warmup"] = 0
    start = torch.from_numpy(np.random.default_rng(1).permutation(64)[:16])
    monkeypatch.setattr(cb, "kmeans_init", functools.partial(cb.kmeans_init, draw=lambda n, m: start))
    torch.manual_seed(0)
    cpu = AlgorithmRegistry.build(cfg, device="cpu")
    card = AlgorithmRegistry.build(cfg, device=dev)
    card.model.load_state_dict(cpu.model.state_dict())
    card.teacher.load_state_dict(cpu.teacher.state_dict())
    u8 = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    batch = {"image": torch.from_numpy(u8.astype(np.float32) / 127.5 - 1.0), "original_image": torch.from_numpy(u8)}
    s_cpu, s_card = cpu.init_state(0), card.init_state(0)
    for want_k1 in (11, 1):
        before = (nearest_codes.launches, nearest_codes_reference.cuda_calls)
        _, m_cpu = cpu.train_step(s_cpu, batch)
        _, m_card = card.train_step(s_card, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert (nearest_codes.launches - before[0], nearest_codes_reference.cuda_calls - before[1]) == (want_k1, 0)
        for name, want_v in m_cpu.items():
            w, g = float(want_v), float(m_card[name])
            assert np.isfinite(g) and abs(g - w) <= 1e-3 * max(abs(w), 1e-6), (name, g, w)
        e_cpu, e_card = cpu.model.quantizer.codebook.detach(), card.model.quantizer.codebook.detach().cpu()
        assert float((e_card - e_cpu).abs().max()) <= 1e-3
    assert s_card.extra["initialized"] is True


# -- the runner on the card ------------------------------------------------------


def _smoke_config(**override):
    from pathlib import Path

    from vector_quantization_tpu_torch.utils.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs/vqgan/smoke.py"))
    cfg.override(override)
    return cfg


def test_trainer_two_steps_on_the_card(dev, tmp_path):
    from vector_quantization_tpu_torch.training.runner import build_runner

    cfg = _smoke_config(**{"trainer.max_iters": 2, "trainer.callbacks": [dict(type="CheckpointCallback", interval=2)]})
    trainer = build_runner(cfg, "trainer", work_dir=str(tmp_path))  # CUDA by default
    before = (nearest_codes.launches, nearest_codes_reference.cuda_calls)
    state = trainer.run()
    torch.cuda.synchronize()
    assert state.step == 2 and trainer.strategy.device.type == "cuda"
    assert (nearest_codes.launches - before[0], nearest_codes_reference.cuda_calls - before[1]) == (2, 0)
    assert {p.device.type for p in state.model.parameters()} == {"cuda"}
    assert (tmp_path / "checkpoints" / "iter_2" / "state.pt").exists()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_checkpoint_round_trip_of_a_cuda_generator(dev, tmp_path):
    from vector_quantization_tpu_torch.training import checkpoints as ckpt
    from vector_quantization_tpu_torch.training.runner import build_runner

    cfg = _smoke_config()
    a = build_runner(cfg, "trainer", work_dir=str(tmp_path / "a"))
    sa = a.init_state()
    assert sa.rng.device.type == "cuda"
    torch.rand(5, generator=sa.rng, device=dev)  # move the generator off its seed
    path = ckpt.save_checkpoint(str(tmp_path / "a"), a.algorithm, sa, 0)
    b = build_runner(cfg, "trainer", work_dir=str(tmp_path / "b"))
    sb = b.init_state()
    ckpt.restore_checkpoint(path, b.algorithm, sb)
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())
    assert torch.equal(torch.rand(7, generator=sa.rng, device=dev), torch.rand(7, generator=sb.rng, device=dev))
    for (name, p), q in zip(a.algorithm.model.named_parameters(), b.algorithm.model.parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q), name


def test_prefetch_copies_pinned_batches_that_equal_the_host(dev, tmp_path):
    from vector_quantization_tpu_torch.training.runner import build_runner

    trainer = build_runner(_smoke_config(), "trainer", work_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    host = [{"id_": [f"x{i}"], "image": rng.standard_normal((4, 64, 64, 3), dtype=np.float32),
             "category": rng.integers(0, 10, 4).astype(np.int32)} for i in range(5)]
    assert trainer.strategy.host_tensor(host[0]["image"]).is_pinned()
    got = []
    for batch in trainer._device_prefetch(iter(host)):
        assert set(batch) == {"image", "category"} and batch["image"].device.type == "cuda"
        got.append({k: (v * 1).cpu() for k, v in batch.items()})  # read on the compute stream
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert np.array_equal(g["image"].numpy(), h["image"]) and np.array_equal(g["category"].numpy(), h["category"])


def test_inception_features_on_card_match_cpu(dev):
    """The FID network (random init, cuDNN f32 with TF32 off) on the card
    against the same module on the CPU, 256 px images through the 299 px
    resize: 1e-4 of max|ref|."""
    from vector_quantization_tpu_torch.models.metrics.inception import load_inception

    model, _ = load_inception(None, "cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 256, 256, 3), dtype=np.uint8))
    with torch.inference_mode():
        want = model(images)
        got = model.to(dev)(images.to(dev)).cpu()
    assert got.shape == (4, 2048)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("b,d,f", [(64, 1024, 3072), (64, 2816, 1024), (64, 1024, 17385), (7, 1024, 17385),
                                   (1, 64, 40), (16, 32, 8)])
def test_int_mm_w8a8_matches_plain(dev, b, d, f):
    # torch._int_mm against the exact int32 sums: the serving projections,
    # the lm head's F = 17385 padded once to a multiple of 8, and fewer than
    # 17 rows (padded with zeros per call, sliced back)
    g = torch.Generator(device=dev).manual_seed(b + d + f)
    x = torch.randn(b, d, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (d, f), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(f, generator=g, device=dev) * 0.02
    wp, sp = im.prepare_w8a8(w, s)
    assert wp.shape[1] % im.W8A8_ALIGN == 0 and wp.shape[1] - f < im.W8A8_ALIGN
    xq, xs = im.quantize_rows_int8(x)
    calls = im.int8_mm.calls
    got = im.int8_mm(xq, wp)
    assert im.int8_mm.calls == calls + 1 and got.dtype == torch.int32 and got.shape == (b, wp.shape[1])
    assert torch.equal(got, im.int8_mm_reference(xq, wp))
    out = im.int8_matmul_w8a8(x, wp, sp, f)
    want = (im.int8_mm_reference(xq, w).float() * xs * s)
    assert out.shape == (b, f) and torch.equal(out, want)


def test_llama_remat_dots_step_on_card_equals_full_remat(dev):
    # a small flash model: the loss and gradients under remat_policy="dots"
    # equal full remat's; the launches per step are full remat's (the
    # forward kernel re-runs in the backward either way)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 300, (4, 257))).to(dev)
    out = {}
    for policy in (None, "dots"):
        model = LlamaTransformer(vocabulary_size=300, hidden_size=128, num_layers=3, num_heads=2, ffn_dim=256,
                                 dtype="bfloat16", remat=True, remat_policy=policy, flash=True).to(dev)
        with torch.no_grad():
            model.lm_head.copy_(torch.randn(model.lm_head.shape, generator=torch.Generator().manual_seed(2))
                                .to(dev) * 0.02)
        before = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
        loss = model(tokens, fused_ce_targets=tokens)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        after = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (6, 3, 3)
        out[policy] = (loss, grads)
    assert torch.equal(out[None][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(out[None][1], out["dots"][1]))


# -- the strategies under a one-rank NCCL group -------------------------------------


@pytest.fixture
def nccl_one_rank(dev, monkeypatch):
    """The default group from torchrun's variables (one rank, NCCL, a free
    localhost port), destroyed after the test."""
    import socket

    import torch.distributed as dist

    from vector_quantization_tpu_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    assert init_distributed("cuda") and dist.get_backend() == "nccl"
    yield dev
    dist.destroy_process_group()


def _tiny_ar(dev, flash=True):
    from pathlib import Path

    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parents[1] / "configs/regression/ar_anchor.py"))
    cfg = cfg["trainer"]["algorithm"]
    cfg["transformer"].update(flash=flash, dtype="bfloat16")  # the kernels take bf16
    torch.manual_seed(0)
    algo = AlgorithmRegistry.build(cfg, device=dev)
    with torch.no_grad():
        algo.model.lm_head.normal_(0.0, 0.05)
    rng = np.random.default_rng(0)
    batch = {"codes": torch.from_numpy(rng.integers(0, 64, (8, 8, 8))).to(dev),
             "category": torch.from_numpy(rng.integers(0, 10, 8)).to(dev)}
    return algo, batch


def _grads_of_one_step(algo, state, batch, strategy=None):
    """(loss, the gradients the optimizer got) of one step; the update is
    applied only under ``strategy``."""
    seen = []
    tx = algo.tx()
    step = tx.step

    def spy(params, grads, opt_state, **kw):
        seen.append([g.detach().clone() for g in grads])
        if strategy is not None:
            step(params, grads, opt_state, **kw)

    tx.step = spy
    try:
        if strategy is None:
            _, m = algo.train_step(state, batch)
        else:
            _, m = strategy.train_step(algo, state, batch)
    finally:
        del tx.step
    return float(m["loss"]), seen[0]


@pytest.mark.parametrize("kind", ["FSDPStrategy", "TPStrategy", "DataParallelStrategy"])
def test_one_rank_strategy_ar_step_equals_the_unwrapped_step(nccl_one_rank, kind):
    # the AR anchor's tiny Llama with flash (K4) under each strategy over a
    # one-rank NCCL group: the loss and every gradient equal the unwrapped
    # step's within 1e-6 of max|ref| (its collectives reduce over one rank),
    # K4 launched, no plain version on the card
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.registries import StrategyRegistry

    dev = nccl_one_rank
    algo, batch = _tiny_ar(dev)
    ref_loss, ref = _grads_of_one_step(algo, algo.init_state(3), batch)
    axes = {"FSDPStrategy": {"dp": -1, "fsdp": 1}, "TPStrategy": {"dp": -1, "tp": 1}}.get(kind, {"dp": -1})
    extra = {"min_size": 256} if kind == "FSDPStrategy" else {}
    strategy = StrategyRegistry.build({"type": kind, **extra}, mesh=make_mesh(axes, device_type="cuda"),
                                      device=dev)
    strategy.bind(algo)
    state = algo.init_state(3)
    strategy.attach(algo, state)
    strategy.shard_state(algo, state)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_reference.cuda_calls)
    loss, got = _grads_of_one_step(algo, state, batch, strategy)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches - before[0] > 0 and fa.flash_attention_reference.cuda_calls == before[1]
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max().clamp(min=1e-30))
    if kind != "DataParallelStrategy":
        assert strategy._param_entries
    strategy.unshard_state(algo, state)


def test_one_rank_tp_server_equals_the_unsharded_server(nccl_one_rank):
    # a tiny INT8 fused Llama served paged with and without TPStrategy(tp=1):
    # the same tokens from the same seed; K2 and K3 launched, pages freed
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention as k3
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.parallel.sharding import TPStrategy
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    dev = nccl_one_rank
    tiny = dict(vocabulary_size=48, hidden_size=128, num_layers=2, num_heads=2, ffn_dim=256, max_length=64)
    recipe = dict(image_tokens=16, batch_slots=4, sampler={"temperature": 1.0, "top_k": 8}, cfg_alpha=1.5,
                  uncond_token=10, steps_per_sync=4, paged=True, page_size=8, cache_dtype=torch.int8,
                  device=dev, seed=5)
    out = {}
    for tp in (False, True):
        model = LlamaTransformer(**tiny, quantize=True, fused_qkv=True, dtype="bfloat16", seed=1)
        strategy = TPStrategy(make_mesh({"dp": -1, "tp": 1}, device_type="cuda"), device=dev) if tp else None
        server = ARServer(model, None, TokenCodebook(11, 32), strategy=strategy, **recipe)
        for c in (1, 4, 7):
            server.submit(category=c)
        before = (int8_matmul.launches, k3.launches)
        out[tp] = dict(server.run_until_drained())
        torch.cuda.synchronize()
        assert int8_matmul.launches > before[0] and k3.launches > before[1]
        assert len(server._free_pages) == server._total_pages
    assert out[True].keys() == out[False].keys() == {0, 1, 2}
    for rid in out[False]:
        assert np.array_equal(out[True][rid], out[False][rid])


# -- the tools on the card ---------------------------------------------------

def test_tokenize_llamagen_on_card_matches_the_plain_lookup(dev, tmp_path):
    # the export at the golden config's small width: one K1 launch per image,
    # and every crop's codes against the plain lookup of the same features
    from pathlib import Path

    from vector_quantization_tpu_torch.ops import vq_lookup
    from vector_quantization_tpu_torch.ops.distances import normalize
    from vector_quantization_tpu_torch.tools import tokenize_llamagen
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import load_config

    repo = Path(__file__).resolve().parents[1]
    config = str(repo / "configs/regression/golden_synthetic.py")
    small = ["--override", "validator.dataset.size=3"]
    before = vq_lookup.nearest_codes.launches
    tokenize_llamagen.main(["t", config, "--out", str(tmp_path / "out"), "--crop-size", "24",
                            "--work-dir", str(tmp_path / "w"), *small])
    assert vq_lookup.nearest_codes.launches - before == 3
    runner = build_runner(load_config(config), "validator", work_dir=str(tmp_path / "w2"))
    runner.init_state()  # the same seed's weights as the tool's runner
    model, q = runner.state.model, runner.state.model.quantizer
    for i in range(3):
        codes = torch.from_numpy(np.load(tmp_path / f"out/imagenet24_codes/{i}.npy")).to(dev)
        crops = tokenize_llamagen.ten_crop(runner.dataloader.dataset[i].image, 24)
        with torch.no_grad():
            x = model.encode(torch.from_numpy(np.ascontiguousarray(crops)).to(dev)).reshape(-1, q.embedding_dim)
            x = normalize(x) if q.normalize_inputs else x
        plain = nearest_codes_reference(x, q.effective_codebook(), q.distance)
        assert compare_codes(x, q.effective_codebook(), codes, plain, q.distance)["ok"]


def test_a_tool_with_the_gpu_hidden_fails_loudly(dev, tmp_path):
    # the export without --device on a machine whose GPU is hidden: it fails
    # on CUDA instead of running on the host
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-m", "vector_quantization_tpu_torch.tools.tokenize_llamagen", "t",
                          str(repo / "configs/regression/golden_synthetic.py"), "--out", str(tmp_path / "out")],
                         cwd=repo, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr and not (tmp_path / "out").exists()


# ---- the f32 GEMM (csrc/f32_gemm.cu): GPT-2-medium's products ----------------

_GEMM_LAYERS = [("c_attn", 1024, 3072), ("c_proj", 1024, 1024), ("mlp_fc", 1024, 4096),
                ("mlp_proj", 4096, 1024), ("ragged", 1028, 1004)]
_GEMM_PRODUCTS = [(f"{name}.{kind}", k, n, kind) for name, k, n in _GEMM_LAYERS
                  for kind in ("fwd", "dx", "dw")] + [
    ("head.fwd", 1024, 17384, "head_fwd"), ("head.dh", 1024, 17384, "head_dh"),
    ("head.dwte", 1024, 17384, "head_dw")]


def _gemm_operands(dev, rows, k, n, kind, seed):
    """(a, b) of one product as ``ops/f32_gemm.Product`` makes it: the
    forward ``x @ w``, the input gradient ``gy @ w.T``, the weight gradient
    ``x.T @ gy``; the head's ``h @ wte.T``, ``gy @ wte``, ``gy.T @ h``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = functools.partial(torch.randn, generator=gen, device=dev)
    return {"fwd": lambda: (r(rows, k), r(k, n)), "dx": lambda: (r(rows, n), r(k, n).t()),
            "dw": lambda: (r(rows, k).t(), r(rows, n)), "head_fwd": lambda: (r(rows, k), r(n, k).t()),
            "head_dh": lambda: (r(rows, n), r(n, k)), "head_dw": lambda: (r(rows, n).t(), r(rows, k))}[kind]()


def _err64(got, ref):
    got, ref = got.detach(), ref.detach()
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("name,k,n,kind", _GEMM_PRODUCTS, ids=[p[0] for p in _GEMM_PRODUCTS])
def test_f32_gemm_matches_float64(dev, name, k, n, kind):
    """At 257 x 3 rows (a ragged last tile; the weight gradients sum over
    them): the kernel's error against float64 within 4x cuBLAS f32's and
    under 1/50 of TF32's (``allow_tf32``)."""
    a, b = _gemm_operands(dev, 257 * 3, k, n, kind, k + n)
    ref = a.double() @ b.double()
    before = fg.matmul.launches
    got = fg.matmul(a, b)
    torch.cuda.synchronize()
    assert fg.matmul.launches == before + 1 and got.shape == ref.shape
    cublas = _err64(torch.mm(a, b), ref)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _err64(torch.mm(a, b), ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err = _err64(got, ref)
    assert err <= 4 * cublas and err < tf32 / 50, (err, cublas, tf32)


@pytest.mark.parametrize("transposed", [False, True])
def test_f32_gemm_autograd_matches_float64(dev, transposed):
    """``dense`` and ``tied_head`` at 2056 rows (8 x 257): the output and
    the input, weight and bias gradients through the kernel, each within 4x
    the error of the same computed by cuBLAS f32, against float64."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(8, 257, 1024, generator=gen, device=dev)
    w = torch.randn(*((4096, 1024) if transposed else (1024, 4096)), generator=gen, device=dev) * 0.03
    b = torch.randn(4096, generator=gen, device=dev)
    gy = torch.randn(8, 257, 4096, generator=gen, device=dev)

    def run(x, w, b, fn):
        x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
        y = fn(x, w, b)
        return (y, *torch.autograd.grad(y, (x, w) if transposed else (x, w, b), gy.to(y.dtype)))

    if transposed:
        kernel_fn, plain_fn = (lambda x, w, b: fg.tied_head(x, w)), (lambda x, w, b: torch.matmul(x, w.t()))
    else:
        kernel_fn, plain_fn = fg.dense, (lambda x, w, b: torch.matmul(x, w) + b)
    before = fg.matmul.launches
    got = run(x, w, b, kernel_fn)
    torch.cuda.synchronize()
    assert fg.matmul.launches == before + 3
    cublas = run(x, w, b, plain_fn)
    ref = run(x.double(), w.double(), b.double(), plain_fn)
    for g, c, r in zip(got, cublas, ref):
        assert _err64(g, r) <= 4 * _err64(c, r), (_err64(g, r), _err64(c, r))


def test_f32_gemm_dispatch(dev):
    """Decode rows, one row short of ``MIN_ROWS``, bf16 and K or N not a
    multiple of 4 stay on torch.matmul (the kernel's launches do not move);
    ``MIN_ROWS`` f32 rows take the kernel, 3 launches with the backward. At
    1024 -> 4096 the forward's plan swaps the operands, so the bias goes on
    C's rows: within 4x cuBLAS f32's error against float64."""
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [((64, 1024), (1024, 3072), torch.float32), ((fg.MIN_ROWS - 1, 1024), (1024, 1024), torch.float32),
             ((4096, 1024), (1024, 3072), torch.bfloat16),
             ((4096, 1022), (1022, 1024), torch.float32), ((4096, 1024), (1024, 1022), torch.float32)]
    before = (fg.matmul.launches, fg.matmul.split_launches)
    for xs, ws, dtype in cases:
        x = torch.randn(*xs, generator=gen, device=dev).to(dtype)
        w = torch.randn(*ws, generator=gen, device=dev).to(dtype)
        b = torch.randn(ws[1], generator=gen, device=dev).to(dtype)
        assert not fg.takes_kernel(x, w)
        assert torch.equal(fg.dense(x, w, b), torch.matmul(x, w) + b)
    assert (fg.matmul.launches, fg.matmul.split_launches) == before
    x = torch.randn(fg.MIN_ROWS, 1024, generator=gen, device=dev, requires_grad=True)
    w = torch.randn(1024, 4096, generator=gen, device=dev, requires_grad=True)
    b = torch.randn(4096, generator=gen, device=dev, requires_grad=True)
    assert fg.takes_kernel(x, w) and fg.plan(fg.MIN_ROWS, 1024, 4096, fg.card(dev).sms).swap
    y = fg.dense(x, w, b)
    ref = x.double() @ w.double() + b.double()
    assert _err64(y, ref) <= 4 * _err64(torch.matmul(x, w) + b, ref)
    y.sum().backward()
    torch.cuda.synchronize()
    assert (fg.matmul.launches, fg.matmul.split_launches) == (before[0] + 3, before[1] + 3)


def test_gpt2_step_products_all_run_the_kernel_under_the_range(dev):
    """One GPT-2-medium step (8 x 257 tokens, vocabulary 17384) under the
    profiler: all 291 products (24 layers x 4 dense x 3, the head x 3) launch
    the kernel inside ``gpt2.gemm``, and no PyTorch matrix product runs
    inside it (the benchmark's ``gpt2_gemm_kernel_share.train`` reads 100)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import readers
    from benchmark import trace as bt

    model = GPT2Transformer(17384, hidden_size=1024, num_layers=24, num_heads=16, max_length=257).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, 17384, (8, 257))).to(dev)

    def step():
        grads = torch.autograd.grad(model(tokens).square().mean(), list(model.parameters()))
        torch.cuda.synchronize()
        return grads

    step()
    before = fg.matmul.launches
    with bt.profiled(True, True) as held:
        with torch.profiler.record_function("window"):
            step()
    assert fg.matmul.launches == before + 291
    t = held.trace
    kernels = [o for o in t.window_ops() if "f32_gemm_kernel" in o[0]]
    inside = [o for o in bt.ops_under(t, ("gpt2.gemm",)) if "f32_gemm_kernel" in o[0]]
    assert len(kernels) == len(inside) == 291
    assert not set(bt.ops_under(t, ("gpt2.gemm",))) & set(bt.ops_under(t, readers.MATMUL_OPS))


def test_gpt2_products_below_min_rows_read_below_100_in_the_kernel_share(dev):
    """A GPT-2 step at fewer than ``MIN_ROWS`` rows (2 x 16) under the
    profiler: its products fall to ``torch.matmul`` inside ``gpt2.gemm``,
    so the benchmark's ``gpt2_gemm_kernel_share.train`` reads below 100, and
    the kernel does not launch."""
    from types import SimpleNamespace

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import trace as bt
    from benchmark.harness import load_module

    share = load_module(Path(__file__).resolve().parents[1] / "benchmark/metrics/gpt2_gemm_kernel_share.train.py",
                        "gpt2_gemm_kernel_share_train")
    model = GPT2Transformer(64, hidden_size=64, num_layers=2, num_heads=2, max_length=16).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(14).integers(0, 64, (2, 16))).to(dev)
    before = fg.matmul.launches
    with bt.profiled(True, True) as held:
        with torch.profiler.record_function("window"):
            torch.autograd.grad(model(tokens).square().mean(), list(model.parameters()))
            torch.cuda.synchronize()
    assert fg.matmul.launches == before
    assert share.read(SimpleNamespace(trace=held.trace, counters={"steps": 1})) < 100


# ---- the DeepSeek-V3 prior's MoE on F1 (models/transformers/deepseek_v3.py) ----

def _bench_module(name):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.harness import load_module

    return load_module(Path(__file__).resolve().parents[1] / f"benchmark/metrics/{name}.py", name.replace(".", "_"))


def test_moe_expert_groups_through_f1_match_the_reference(dev):
    """A Moonlight MoE layer at its published widths (hidden 2048, experts
    of 1408), 8 of 64 experts held, its groups of 0, 100, 511, 512 and 3,000
    rows: the experts' output and its input and weight gradients within 4x
    the error of the same computed by cuBLAS f32 against float64 (the
    groups under ``MIN_ROWS`` on ``torch.matmul``); a group of 0 rows
    launches nothing."""
    from vector_quantization_tpu_torch.models.transformers.deepseek_v3 import _MoE, new_counters

    counters = new_counters(1, 8)
    moe = _MoE(2048, 1408, 64, 6, 2, range(8), 2.446, 1e-4, counters, 0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    counts = [0, 100, 511, 512, 3000, 0, 0, 0]
    xs = torch.randn(sum(counts), 2048, generator=gen, device=dev)
    gy = torch.randn(sum(counts), 2048, generator=gen, device=dev)
    experts = [moe.experts[str(e)] for e, c in enumerate(counts) if c]
    weights = [p for m in experts for p in (m.gate_proj.weight, m.up_proj.weight, m.down_proj.weight)]

    def plain(x, ws, dtype):
        out, start = [], 0
        for j, c in enumerate(c for c in counts if c):
            g, u, d = (w.to(dtype) for w in ws[3 * j: 3 * j + 3])
            xe = x[start: start + c]
            out.append((torch.nn.functional.silu(xe @ g.t()) * (xe @ u.t())) @ d.t())
            start += c
        return torch.cat(out)

    def grads(y, x, ws):
        return (y, *torch.autograd.grad(y, (x, *ws), gy.to(y.dtype)))

    before = fg.matmul.launches
    x = xs.detach().requires_grad_()
    got = grads(moe.run_experts(x, counts), x, weights)
    torch.cuda.synchronize()
    # the 512- and 3000-row groups: 2 products (gate and up stacked, down) and 4 in the backward each
    assert fg.matmul.launches == before + 12
    assert counters["kernel_products"] == 4 and counters["plain_products"] == 4
    assert counters["expert_rows"] == [counts]
    x = xs.detach().requires_grad_()
    cublas = grads(plain(x, weights, torch.float32), x, weights)
    x64 = xs.detach().double().requires_grad_()
    w64 = [w.detach().double().requires_grad_() for w in weights]
    ref = grads(plain(x64, w64, torch.float64), x64, w64)
    for g, c, r in zip(got, cublas, ref):
        assert _err64(g, r) <= 4 * _err64(c, r), (_err64(g, r), _err64(c, r))


class _Planted(torch.autograd.Function):
    """Identity that launches ``flip`` twice forward and twice backward."""

    @staticmethod
    def forward(ctx, x):
        return x.flip(0).flip(0)

    @staticmethod
    def backward(ctx, g):
        return g.flip(0).flip(0)


@pytest.mark.parametrize("where,metric", [("mla", "mla_ms.moe"), ("experts", "moe_expert_ms.moe"),
                                          ("route", "moe_routing_ms.moe")])
def test_moe_metrics_attribute_a_planted_launch_to_its_part(dev, where, metric, monkeypatch):
    """A small DeepSeek-V3 train step under the profiler with a planted
    ``flip`` pair in the MLA's output, the experts' output or the router's
    scores, forward and backward: every planted launch lands in its part's
    metric and in neither other part's; each metric reads above 0."""
    from types import SimpleNamespace

    from benchmark import moe_trace
    from benchmark import trace as bt
    from vector_quantization_tpu_torch.models.transformers import deepseek_v3 as dsm

    if where == "mla":
        orig = dsm._MLA.forward
        monkeypatch.setattr(dsm._MLA, "forward", lambda self, *a: _Planted.apply(orig(self, *a)))
    elif where == "experts":
        orig = dsm._MoE.run_experts
        monkeypatch.setattr(dsm._MoE, "run_experts", lambda self, *a: _Planted.apply(orig(self, *a)))
    else:
        orig = dsm._MoE.route

        def route(self, x):  # the scores: the cut layer's weights are detached, the balance loss reads s
            idx, w, s = orig(self, x)
            return idx, w, _Planted.apply(s)

        monkeypatch.setattr(dsm._MoE, "route", route)
    model = dsm.DeepseekV3Transformer(256, 65, hidden_size=256, num_layers=3, num_heads=4, kv_lora_rank=64,
                                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                                      intermediate_size=512, moe_intermediate_size=128, n_routed_experts=16,
                                      num_experts_per_tok=4, experts_held=8).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(0, 256, (16, 65))).to(dev)

    def step():
        logits, aux = model(tokens, return_aux=True)
        loss = logits.square().mean() + aux["balance"]
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()

    step()
    with bt.profiled(True, True) as held:
        with torch.profiler.record_function("window"):
            with torch.profiler.record_function("vq.backward"):
                step()
    run = SimpleNamespace(trace=held.trace, counters={"steps": 1})
    planted = set(bt.ops_under(held.trace, ("aten::flip",)))
    layers = 3 if where == "mla" else 2
    assert len(planted) == 4 * layers
    parts = {}
    for name in ("mla_ms.moe", "moe_expert_ms.moe", "moe_routing_ms.moe"):
        m = _bench_module(name)
        parts[name] = set(moe_trace.part_ops(run, m.FORWARD, m.BACKWARD, m.EXCLUDE))
        assert m.read(run) > 0
    for name, ops in parts.items():
        assert (planted <= ops) if name == metric else not (planted & ops), (name, len(planted & ops))


def test_moe_products_keep_out_of_gpt2s_range_and_take_f1(dev):
    """A DeepSeek-V3 step whose balancing bias sends every token to experts
    0 and 1 (two groups of 4,112 rows, two of none): its products launch F1
    under their own ranges, none inside ``gpt2.gemm`` (GPT-2's metrics read
    nothing of it), and the experts' kernel share reads 100."""
    from types import SimpleNamespace

    from benchmark import readers
    from benchmark import trace as bt
    from vector_quantization_tpu_torch.models.transformers.deepseek_v3 import DeepseekV3Transformer

    model = DeepseekV3Transformer(256, 257, hidden_size=256, num_layers=2, num_heads=4, kv_lora_rank=64,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, intermediate_size=512,
                                  moe_intermediate_size=128, n_routed_experts=8, num_experts_per_tok=2,
                                  experts_held=4).to(dev)
    for moe in model.moe_layers():
        moe.gate.e_score_correction_bias[:2] = 1.0
    tokens = torch.from_numpy(np.random.default_rng(17).integers(0, 256, (16, 257))).to(dev)

    def step():
        logits, aux = model(tokens, return_aux=True)
        torch.autograd.grad(logits.square().mean() + aux["balance"], list(model.parameters()),
                            allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()

    step()
    with bt.profiled(True, True) as held:
        with torch.profiler.record_function("window"):
            step()
    run = SimpleNamespace(trace=held.trace, counters={"steps": 1})
    assert model.counters["plain_products"] == 0 and model.counters["kernel_products"] == 2 * 2 * 2
    assert model.counters["expert_rows"] == [[2 * 4112, 2 * 4112, 0, 0]]
    assert not bt.ops_under(held.trace, ("gpt2.gemm",))
    assert _bench_module("gpt2_gemm_ms.train").read(run) is None
    assert _bench_module("moe_expert_kernel_share.moe").read(run) == pytest.approx(100.0)
    assert any("f32_gemm_kernel" in o[0] for o in bt.ops_under(held.trace, ("moe.expert.gemm",)))
    assert readers.device_ms(run, ("mla.gemm",)) > 0 and readers.device_ms(run, ("head.gemm",)) > 0
