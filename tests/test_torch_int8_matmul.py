"""The port's int8_matmul (plain version on CPU) against the JAX function:
its Pallas kernel in interpret mode and its XLA path, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from vector_quantization_tpu_torch.ops.int8_matmul import (
    H100, TILED_MIN_ROWS, Card, Plan, int8_matmul, plan, ragged_plan, split_k, split_k_plan,
    tiled_plan, wide_plan,
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


def _x_aligned(d):
    # x's rows alone: 2 D bytes a multiple of 16
    return (2 * d) % 16 == 0


def _w_aligned(f):
    # w's rows alone: F bytes a multiple of 16
    return f % 16 == 0


def _plan(design, b, d, f, card=H100):
    # the design's own plan ("planned": the one plan() picks, as plan_for
    # asks for it)
    if design == "split_k":
        return split_k_plan(b, d, f, card.sms)
    if design == "wide":
        return wide_plan(b, d, f, card)
    if design == "ragged":
        return ragged_plan(b, d, f, card)
    return plan(b, d, f, card, _x_aligned(d), _w_aligned(f))


# (design, shape): each design at every shape it takes (the wide design
# needs aligned rows and a share that fits; the ragged design x's rows
# aligned, w's at any offset)
DESIGN_CASES = [(design, s) for design in ("planned", "split_k", "wide", "ragged") for s in PLAN_SHAPES
                if (design != "wide" or (_aligned(*s[1:]) and wide_plan(*s, H100) is not None))
                and (design != "ragged" or _x_aligned(s[1]))]


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
    p = plan(b, d, f, SMALL_CARD, _x_aligned(d), _w_aligned(f))
    assert p.smem() <= SMALL_CARD.smem_block
    if p.design == "wide":
        per_sm = -(-p.grid(b, d, f)[0] * p.grid(b, d, f)[1] // SMALL_CARD.sms)
        assert per_sm * (p.smem() + 1024) <= SMALL_CARD.smem_sm


@pytest.mark.parametrize("b,d,f", [s for s in PLAN_SHAPES if s[2] % 16])
def test_plan_takes_split_k_where_w_rows_are_unaligned(b, d, f):
    # below TILED_MIN_ROWS, w's rows unaligned: the ragged design where x's
    # rows are aligned (the head's F = 17385, ragged F), all of D a block;
    # split-K where they are not (D = 100: 200-byte rows)
    p = _plan("planned", b, d, f)
    if _x_aligned(d):
        assert p == ragged_plan(b, d, f, H100) and p.design == "ragged"
        assert p.split == 1 and p.kt == 64 and p.k_chunk == -(-d // 64) * 64
    else:
        assert p.design == "split_k" and p.k_chunk == split_k(b, d, f, 132)
    assert plan(b, d, f, H100, _x_aligned(d), False) == p
    # with x's rows unaligned too, split-K
    assert plan(b, d, f, H100, False, False) == split_k_plan(b, d, f, 132)


@pytest.mark.parametrize("b,d,f", PLAN_SHAPES[:4])
def test_plan_takes_wide_at_the_aligned_decode_shapes(b, d, f):
    # a power-of-two cluster whose grid runs in one wave at two blocks per
    # SM, the block's share whole in the ring; with x unaligned, split-K
    p = _plan("planned", b, d, f)
    assert p.design == "wide" and p.split in (1, 2, 4, 8)
    gx = p.grid(b, d, f)[0]
    assert gx <= 2 * 132 and (p.split == 8 or 2 * gx > 2 * 132)
    assert p.stages == min(p.k_chunk // 64, 8)
    assert plan(b, d, f, H100, False, True).design == "split_k"


# -- the tiled design (many rows) ------------------------------------------------

# Llama-medium's five INT8 products: qkv, o, gate+up, down (fused) and the head
MEDIUM_WIDTHS = [(1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024), (1024, 17385)]


@pytest.mark.parametrize("d,f", MEDIUM_WIDTHS)
def test_plan_takes_tiled_at_the_prefill_rows(d, f):
    # generate()'s prefill of 64 rows x 129 positions: every projection and
    # the head (F = 17385: rows not 16-byte aligned) on the tiled design
    p = plan(8256, d, f, H100, _x_aligned(d), _w_aligned(f))
    assert p == tiled_plan(8256, d, f) and p.design == "tiled"
    assert p.k_chunk == -(-d // 64) * 64 and p.split == 1
    assert plan(8256, d, f, H100, False, False) == p


# the plan at each decode shape (the five fused widths and generate()'s
# unfused gate/up, at 1, 7 and 64 rows): the tiled design's parent's, but
# the head's, which the ragged design took from split-K
PARENT_PLANS = [
    ((1, 1024, 3072), ("wide", 128, 8, 64, 2, 128)),
    ((1, 1024, 1024), ("wide", 128, 8, 64, 2, 128)),
    ((1, 1024, 5632), ("wide", 128, 4, 64, 4, 256)),
    ((1, 2816, 1024), ("wide", 128, 8, 64, 6, 384)),
    ((1, 1024, 17385), ("ragged", 144, 1, 64, 3, 1024)),
    ((1, 1024, 2816), ("wide", 128, 8, 64, 2, 128)),
    ((7, 1024, 3072), ("wide", 128, 8, 64, 2, 128)),
    ((7, 1024, 1024), ("wide", 128, 8, 64, 2, 128)),
    ((7, 1024, 5632), ("wide", 128, 4, 64, 4, 256)),
    ((7, 2816, 1024), ("wide", 128, 8, 64, 6, 384)),
    ((7, 1024, 17385), ("ragged", 144, 1, 64, 3, 1024)),
    ((7, 1024, 2816), ("wide", 128, 8, 64, 2, 128)),
    ((64, 1024, 3072), ("wide", 128, 8, 64, 2, 128)),
    ((64, 1024, 1024), ("wide", 128, 8, 64, 2, 128)),
    ((64, 1024, 5632), ("wide", 128, 4, 64, 4, 256)),
    ((64, 2816, 1024), ("wide", 128, 8, 64, 6, 384)),
    ((64, 1024, 17385), ("ragged", 144, 1, 64, 3, 1024)),
    ((64, 1024, 2816), ("wide", 128, 8, 64, 2, 128)),
]


@pytest.mark.parametrize("shape,parent", PARENT_PLANS)
def test_plan_keeps_the_parent_plan_at_decode_shapes(shape, parent):
    b, d, f = shape
    assert TILED_MIN_ROWS > b
    assert plan(b, d, f, H100, _x_aligned(d), _w_aligned(f)) == Plan(*parent)


def _tiles_cover_once(p, b, d, f):
    # every (row, column) of the output in exactly one tile, each over all of D
    seen = np.zeros((b, f), np.int32)
    for m0, n0, k0, k1 in p.blocks(b, d, f):
        assert (k0, k1) == (0, d) and m0 < b and n0 < f
        seen[m0:m0 + p.rows, n0:n0 + p.n] += 1
    return seen


@pytest.mark.parametrize(
    "b,d,f",
    [(130, 1000, 17385), (257, 96, 200), (300, 1000, 777), (129, 20000, 256),
     (8256, 1024, 17385), (8256, 2816, 1024), (1, 8, 1)],
)
def test_tiled_plan_tiles_cover_each_output_once(b, d, f):
    p = tiled_plan(b, d, f)
    gx, gy, gz = p.grid(b, d, f)
    blocks = p.blocks(b, d, f)
    assert len(blocks) == gx * gy * gz and p.rows == 256
    assert (_tiles_cover_once(p, b, d, f) == 1).all()
    # the kernel's tile t is (row tile t // gx, column tile t % gx)
    assert blocks == [(t // gx * p.rows, t % gx * p.n, 0, d) for t in range(gx * gy)]


def test_tiled_plan_fits_the_card():
    # one block per SM: the block's shared memory (the kernel's own
    # reckoning) within the per-block and per-SM limits of an H100; on a
    # card with less, plan() keeps the designs below
    p = tiled_plan(8256, 1024, 17385)
    assert p.smem() == 1024 + 1024 + 4 * (32768 + 8192 + 9216)
    assert p.smem() <= H100.smem_block and p.smem() + 1024 <= H100.smem_sm
    assert plan(8256, 1024, 2816, SMALL_CARD, True, True).design != "tiled"


def _copied_words(off: int, nb: int, half: int) -> range:
    """The aligned 16-byte words of a row slot that the producer thread of
    half ``half`` copies (``csrc/int8_matmul_tiled.cu``): those that cover
    the row's bytes [64 half, min(64 half + 64, nb)), the row starting
    ``off`` bytes into its first word."""
    lo, hi = 64 * half, min(64 * half + 64, nb)
    return range((off + lo) >> 4, ((off + hi - 1) >> 4) + 1) if lo < hi else range(0)


def _realign(raw: np.ndarray, off: int, nb: int, half: int) -> np.ndarray:
    """The kernel's shift of half an unaligned weight row into place
    (``realign``): output word m of the half is the funnel shift of the
    copied words' 32-bit words (off >> 2) + 16 half + m and + m + 1 right by
    8 (off & 3) bits, its bytes past ``nb`` zeroed."""
    words = raw.view("<u4").astype(np.uint64)
    out = np.zeros(16, np.uint32)
    for m in range(16):
        w0 = (off >> 2) + 16 * half + m
        u = int(((words[w0 + 1] << 32) | words[w0]) >> (8 * (off & 3))) & 0xFFFFFFFF
        left = nb - 64 * half - 4 * m
        out[m] = u if left >= 4 else 0 if left <= 0 else u & ((1 << (8 * left)) - 1)
    return out.view(np.uint8)


@pytest.mark.parametrize("nb", [128, 127, 113, 65, 64, 63, 16, 9, 1])
def test_unaligned_row_loader_model(nb):
    # a row of nb bytes (128, or a ragged last column tile) at every base
    # alignment: each half row's thread copies the aligned 16-byte words
    # that cover its bytes (at most 5, none past the word that holds the
    # row's last byte) into a 144-byte slot; put back in place from a slot
    # that holds its own copies only (the rest garbage: a thread waits for
    # its own copies alone), each half equals the row's bytes, then zeros
    rng = np.random.default_rng(nb)
    memory = rng.integers(0, 256, 4096, dtype=np.uint8)
    for off in range(16):
        start = 1024 + off
        last = (off + nb - 1) >> 4
        halves = []
        for half in (0, 1):
            words = _copied_words(off, nb, half)
            assert len(words) <= 5 and all(j <= last for j in words)
            raw = rng.integers(0, 256, 144, dtype=np.uint8)
            for j in words:
                raw[16 * j:16 * j + 16] = memory[1024 + 16 * j:1024 + 16 * j + 16]
            halves.append(_realign(raw, off, nb, half))
        got = np.concatenate(halves)
        np.testing.assert_array_equal(got[:nb], memory[start:start + nb])
        assert not got[nb:].any()


def _byte_perm(a: int, b: int, sel: int) -> int:
    data = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    return int.from_bytes(bytes(data[(sel >> 4 * i) & 7] for i in range(4)), "little")


def _widen2(u: int, p: int) -> int:
    """The kernels' ``widen2``: bytes p and p + 2 of u (sign bits flipped)
    -> a bf16 pair by byte permutes and an f32 subtract."""
    def f32(bits):
        return np.frombuffer(np.uint32(bits).tobytes(), np.float32)[0]

    lo = f32(_byte_perm(u, 0x4B000000, 0x7650 + p)) - np.float32(8388736.0)
    hi = f32(_byte_perm(u, 0x4B000000, 0x7652 + p)) - np.float32(8388736.0)
    bits = [int(np.array(v, np.float32).view(np.uint32)) for v in (lo, hi)]
    return _byte_perm(bits[0], bits[1], 0x7632)


def test_widen2_is_exact_for_every_int8():
    # each of the 256 int8 values, in either byte of a pair, comes out as
    # its own bf16 (int8 values are exact in bf16)
    vals = np.arange(-128, 128)
    want = torch.tensor(vals, dtype=torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)
    for v, bf in zip(vals, want):
        for other in (0, -128, 127, -1):
            b = [(x + 128) & 0xFF for x in (v, other, other, v)]  # sign bits flipped
            u = int.from_bytes(bytes(b), "little")
            pair = _widen2(u, 0)  # bytes 0 and 2: v low, other high
            assert pair & 0xFFFF == bf
            pair = _widen2(u, 1)  # bytes 1 and 3: other low, v high
            assert pair >> 16 == bf


def _store_rows(f: int, cw: int, base_off: int, rows: int) -> dict:
    """The tiled kernel's stores of one warp's 16 columns [cw, cw + 16)
    where the output rows are not 16-byte aligned (``store_group``): lane
    4 g + t holds columns cw + 4 (g >> 1) + [0, 4) of row 2 t + (g & 1) of
    an 8-row group; it stores the aligned word of its row that ends ``off``
    columns into its 4 (the columns before from lane - 8), whole where it
    lies within the warp's columns and F, else float by float; the row's
    last lane also its last ``off`` columns. Returns {(row, column):
    [values stored]}, each value the (row, column) it came from."""
    stored = {}
    for r8 in range(0, rows, 8):
        held = {}
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            row, q = r8 + 2 * t + (g & 1), g >> 1
            held[lane] = (row, q, [(row, cw + 4 * q + e) for e in range(4)])
        for lane in range(32):
            row, q, y = held[lane]
            prev = held[lane - 8][2] if lane >= 8 else y
            if row >= rows:
                continue
            off = (base_off + row * f + cw) & 3  # floats past a 16-byte boundary
            c = 4 * q - off
            word = [prev[4 - off + e] if e < off else y[e - off] for e in range(4)]
            for e in range(4):
                if c + e >= 0 and cw + c + e < f:
                    stored.setdefault((row, cw + c + e), []).append(word[e])
            if q == 3:
                for e in range(off):
                    if cw + 16 - off + e < f:
                        stored.setdefault((row, cw + 16 - off + e), []).append(y[4 - off + e])
    return stored


@pytest.mark.parametrize("f", [17385, 777, 37, 18, 33])
def test_unaligned_store_lanes_model(f):
    # every output element of the warp's columns within F, in every row of
    # two 8-row groups (11 rows: a ragged last group), at every alignment
    # of the output's base, is stored exactly once, with its own value
    for cw in range(0, f, 16):
        for base_off in range(4):
            stored = _store_rows(f, cw, base_off, 11)
            want = {(r, c): [(r, c)] for r in range(11) for c in range(cw, min(cw + 16, f))}
            assert stored == want


# -- the ragged design (w's rows not 16-byte aligned, below TILED_MIN_ROWS) ------


@pytest.mark.parametrize(
    "b,d,f", [(1, 1024, 17385), (7, 1024, 17385), (64, 1024, 17385), (64, 1000, 777), (5, 104, 37),
              (5, 100, 37)],
)
def test_plan_takes_ragged_at_the_unaligned_head(b, d, f):
    # the decode lm head at 1, 7 and 64 rows and ragged F: 144 columns a
    # block where 128 would take two waves at the head (136 stripes on 132
    # SMs), all of D, a ring of 3; x's rows unaligned (D = 100): split-K
    p = plan(b, d, f, H100, _x_aligned(d), False)
    if not _x_aligned(d):
        assert p == split_k_plan(b, d, f, H100.sms)
        return
    assert p.design == "ragged" and p.source == "int8_matmul_ragged"
    assert (p.split, p.kt, p.stages, p.k_chunk) == (1, 64, 3, -(-d // 64) * 64)
    assert p.n == (144 if f == 17385 else 128) and p.rows == 64
    assert p.grid(b, d, f) == (-(-f // p.n), -(-b // 64), 1)


@pytest.mark.parametrize("b", [1, 7, 64])
def test_ragged_plan_runs_the_head_in_one_wave(b):
    # one block an SM: the head's grid fits the H100's 132 SMs at once, and
    # an SM holds the block beside the 1024 bytes it keeps for it
    p = ragged_plan(b, 1024, 17385, H100)
    gx, gy, gz = p.grid(b, 1024, 17385)
    assert gx * gy * gz == 121 <= H100.sms
    assert -(-17385 // 128) > H100.sms  # the 128-column tile would not
    assert p.smem() <= H100.smem_block and p.smem() + 1024 <= H100.smem_sm


@pytest.mark.parametrize("n,stages", [(128, 3), (128, 4), (128, 8), (144, 3), (144, 4), (144, 8)])
def test_ragged_smem_is_the_kernels_reckoning(n, stages):
    # 1024 bytes of slack and a 1024-byte header, then the larger of x's two
    # 32 KB chunks, the four warpgroups' bf16 B tiles (wgmma's N rows of 128
    # bytes: 72 at 144 columns, 64 at 128) with the 16 warps' rings (16 rows
    # of covering words a stage, two stages of 16 shifted rows), and the
    # tile's two f32 images (pitch 16 U + 4 or + 20 floats); the plan's ring
    # of 3 fits an H100, 4 stages do only at 128 columns
    u = n // 16
    wu = (u + 1) // 2  # a column group's units: 5 at 144 columns, 4 at 128
    nw = {144: 72, 128: 64}[n]
    p = Plan("ragged", n, 1, 64, stages, 1024)
    ring = stages * 16 * 16 * (wu + 1) + 2 * 16 * 16 * (wu | 1)
    images = 2 * 64 * (16 * u + (20 if u % 2 else 4)) * 4
    assert (16 * u + (20 if u % 2 else 4)) % 32 == 4 and (wu | 1) % 2 == 1
    assert p.smem() == 2048 + max(2 * 32768 + 4 * nw * 128 + 16 * ring, images)
    assert (p.smem() <= H100.smem_block) == (stages == 3 or (n, stages) == (128, 4))


@pytest.mark.parametrize("b,d,f", [(64, 1024, 17385), (64, 1000, 777), (5, 104, 37)])
def test_ragged_plan_on_a_smaller_card(b, d, f):
    # the ragged block does not fit a 100 KB card: plan() keeps split-K,
    # which does
    assert ragged_plan(b, d, f, SMALL_CARD) is None
    p = plan(b, d, f, SMALL_CARD, True, False)
    assert p == split_k_plan(b, d, f, SMALL_CARD.sms) and p.smem() <= SMALL_CARD.smem_block


def _ragged_copies(u: int, base: int, f: int, d: int, n0: int, cg: int, j: int, ks: int) -> list:
    """The copies of warp ``ks`` of column group ``cg`` at stage ``j``
    (``csrc/int8_matmul_ragged.cu``, its indexing): the group's bytes of a
    row are [cb, cb + seg) of the stripe's, cb = 64 cg, seg = its 16 WU (WU
    = u / 2 rounded up) within the stripe's nb; task e is word c of row r,
    e = r (WU + 1) + c, copied where ``seg > 0 and 16 c < off + seg`` and
    the row lies within D; ``off`` is the row's byte offset past a 16-byte
    boundary at stage 0, and stage j's source is stage 0's + 64 j F.
    Returns [(row r, ring slot's byte, source address)]."""
    wu = u // 2 + u % 2
    nb = min(16 * u, f - n0)
    cb = 64 * cg
    seg = max(0, min(16 * wu, nb - cb))
    out = []
    for e in range(16 * (wu + 1)):
        r, c = divmod(e, wu + 1)
        off = (base + (16 * ks + r) * f + n0 + cb) & 15
        if seg > 0 and 16 * c < off + seg and 64 * j + 16 * ks + r < d:
            src = base + (16 * ks + r) * f + n0 + cb - off + 16 * c + 64 * j * f
            out.append((r, r * 16 * (wu + 1) + 16 * c, src))
    return out


def _ragged_shift(raw: np.ndarray, u: int, offs: list) -> np.ndarray:
    """The warp's shift of its 16 rows into place: word c of row r is the
    funnel shift of the 32-bit words at byte r 16 (WU + 1) + 16 c + (off &
    ~3) and the next four, right by 8 (off & 3) bits. Returns (16, 16 WU)."""
    wu = u // 2 + u % 2
    out = np.zeros((16, 16 * wu), np.uint8)
    for r in range(16):
        off = offs[r]
        for c in range(wu):
            at = r * 16 * (wu + 1) + 16 * c + (off & ~3)
            words = raw[at:at + 20].view("<u4").astype(np.uint64)
            for q in range(4):
                v = int(((words[q + 1] << 32) | words[q]) >> (8 * (off & 3))) & 0xFFFFFFFF
                out[r, 16 * c + 4 * q:16 * c + 4 * q + 4] = np.frombuffer(v.to_bytes(4, "little"), np.uint8)
    return out


@pytest.mark.parametrize("base", [0, 3])
@pytest.mark.parametrize("f", [17385, 777, 40, 37, 33])
@pytest.mark.parametrize("u", [8, 9])
def test_ragged_loader_model(f, u, base):
    # a weight of 100 rows (two stages, the second short) at a base 0 or 3
    # bytes past a 16-byte boundary, its first two stripes and its last
    # (nb < 64 at F = 777, 40, 37, 33: column group 1 holds no byte): every
    # word a warp copies holds a byte of its group's segment of its row (so
    # none lies past the weight's last 16-byte word, none starts past its
    # last byte), no row past D is copied; shifted from a ring slot that
    # holds its own copies only (the rest garbage), each group's B tile
    # column (whole unit i at local unit wl0 + i, the middle one at mid_l)
    # reads its own byte of the row, and the two groups' columns within nb
    # come from their segments, [cb, cb + seg)
    d, wu, h = 100, u // 2 + u % 2, u // 2
    rng = np.random.default_rng(f + u + base)
    memory = rng.integers(0, 256, base + d * f + 64, dtype=np.uint8)
    end = base + d * f  # one past the weight's last byte
    stripes = sorted({0, 16 * u, (f - 1) // (16 * u) * 16 * u} & set(range(0, f, 16 * u)))
    for n0 in stripes:
        nb = min(16 * u, f - n0)
        for j in range(-(-d // 64)):
            for ks in range(4):
                read = {}
                for cg in (0, 1):
                    cb = 64 * cg
                    seg = max(0, min(16 * wu, nb - cb))
                    offs = [(base + (16 * ks + r) * f + n0 + cb) & 15 for r in range(16)]
                    raw = rng.integers(0, 256, 16 * 16 * (wu + 1), dtype=np.uint8)
                    for r, slot, src in _ragged_copies(u, base, f, d, n0, cg, j, ks):
                        k = 64 * j + 16 * ks + r
                        lo = base + k * f + n0 + cb  # the group's segment of row k
                        assert src % 16 == 0 and k < d
                        assert src < lo + seg and src + 16 > lo and src < end
                        raw[slot:slot + 16] = memory[src:src + 16]
                    shifted = _ragged_shift(raw, u, offs)
                    wl0, mid_l = (1 if u % 2 and cg else 0), (0 if cg else h)
                    fu0 = u - h if cg else 0
                    for jn in range(16 * h + 8 * (u % 2)):
                        col = _ragged_b_column(u, cg, jn)
                        local = 16 * (wl0 + (col // 16 - fu0) if jn < 16 * h else mid_l) + col % 16
                        assert local == col - cb
                        if col < nb:
                            assert local < seg
                            read[col] = shifted[:, local]
                for r in range(16):
                    k = 64 * j + 16 * ks + r
                    if k >= d:
                        continue
                    row = np.array([read[c][r] for c in range(nb)], np.uint8)
                    np.testing.assert_array_equal(row, memory[base + k * f + n0:base + k * f + n0 + nb])


def _ragged_b_column(u: int, cg: int, jn: int) -> int:
    """The stripe column of row ``jn`` of column group ``cg``'s B tile (and
    of its wgmma sums' column ``jn``): whole unit i's n8 tile p is rows
    16 i + 8 p + g, column 16 (fu0 + i) + 2 g + p; the middle unit (u odd)
    rows 16 (u // 2) + g, column 16 (u // 2) + 2 g + cg."""
    h = u // 2
    fu0 = u - h if cg else 0
    if jn < 16 * h:
        i, p, g = jn // 16, (jn % 16) // 8, jn % 8
        return 16 * (fu0 + i) + 2 * g + p
    return 16 * h + 2 * (jn - 16 * h) + cg


@pytest.mark.parametrize("u", [8, 9])
def test_ragged_b_tile_model(u):
    # each warp (k rows 16 ks + [0, 16) of a stage) of each warpgroup writes
    # lane (g, t)'s widened words, W^T[column][depth 16 ks + 8 m + 2 t, + 1]
    # of n8 tile p of unit i (from ldmatrix .trans: depths 2 t, 2 t + 1 of
    # columns 2 g, 2 g + 1), where the K-major 128-byte-swizzled B tile keeps
    # element (row jn, depth d): every (row, depth) of the tile once, 32
    # banks a store; the columns of the two groups tile the stripe once
    h = u // 2
    nw = 16 * h + 8 * (u % 2)
    cols = []
    for cg in (0, 1):
        fu0 = u - h if cg else 0
        seen = {}
        for ks in range(4):
            for m in range(2):
                for tile in [(i, p) for i in range(h) for p in (0, 1)] + ([(h, None)] if u % 2 else []):
                    banks = set()
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        i, p = tile
                        group = 2 * i + p if p is not None else 2 * h
                        off = group * 1024 + g * 128 + (((2 * ks + m) ^ g) << 4) + 4 * t
                        col = 16 * (fu0 + i) + 2 * g + p if p is not None else 16 * h + 2 * g + cg
                        d = 16 * ks + 8 * m + 2 * t
                        jn = 16 * i + 8 * p + g if p is not None else 16 * h + g
                        want = (jn // 8) * 1024 + (jn % 8) * 128 + (((d // 8) ^ (jn % 8)) << 4) + (d % 8) * 2
                        assert off == want and _ragged_b_column(u, cg, jn) == col
                        assert off not in seen
                        seen[off] = (jn, d)
                        banks.add((off // 4) % 32)
                    assert len(banks) == 32
        assert sorted(seen.values()) == [(jn, d) for jn in range(nw) for d in range(0, 64, 2)]
        cols += [_ragged_b_column(u, cg, jn) for jn in range(nw)]
    assert sorted(cols) == list(range(16 * u))


def _ragged_image(u: int, f: int, n0: int, m0: int, out_off: int) -> dict:
    """The warps' writes of their sums (``csrc/int8_matmul_ragged.cu``):
    wgmma's accumulator a of lane (g, t) of warp ks of warpgroup cg is row
    16 ks + g + 8 ((a % 4) >> 1) and B row 8 (a // 4) + 2 t + (a & 1), the
    column :func:`_ragged_b_column`; each lands at row r, float a_r + the
    kernel's column. Returns {(row, position): (row, column)}."""
    h = u // 2
    image = {}
    for warp in range(8):
        cg, ks = warp >> 2, warp & 3
        fu0 = u - h if cg else 0
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for hh in range(2):
                r = 16 * ks + g + 8 * hh
                ar = (out_off + (m0 + r) * f + n0) & 3
                # the kernel's positions: 16 u' + 4 t + [0, 4) of whole
                # units, 16 h + 4 t + cg and + 2 of the middle one
                kernel = {}
                for i in range(h):
                    c = 16 * (fu0 + i) + 4 * t
                    kernel.update({8 * i + 2 * hh: c, 8 * i + 4 + 2 * hh: c + 1,
                                   8 * i + 2 * hh + 1: c + 2, 8 * i + 4 + 2 * hh + 1: c + 3})
                if u % 2:
                    c = 16 * h + 4 * t + cg
                    kernel.update({8 * h + 2 * hh: c, 8 * h + 2 * hh + 1: c + 2})
                for acc, col in kernel.items():
                    assert ((acc % 4) >> 1) == hh
                    assert _ragged_b_column(u, cg, 8 * (acc // 4) + 2 * t + (acc & 1)) == col
                    key = (r, ar + col)
                    assert key not in image
                    image[key] = (r, col)
    return image


@pytest.mark.parametrize("f", [17385, 777, 37])
@pytest.mark.parametrize("u", [8, 9])
def test_ragged_store_lanes_model(f, u):
    # the image holds each (row, column) of the block once, at its row's
    # shifted position; the output words then store every (row, column)
    # within F once, with its own sum, whole 16-byte words aligned, at every
    # alignment of the output's base and in a partial last row tile
    p_pitch = 16 * u + (20 if u % 2 else 4)
    for n0 in sorted({0, 16 * u, (f - 1) // (16 * u) * 16 * u}):
        nb = min(16 * u, f - n0)
        for out_off, m0, b in [(0, 0, 64), (1, 64, 75), (2, 0, 7), (3, 128, 130)]:
            image = _ragged_image(u, f, n0, m0, out_off)
            assert len(image) == 64 * 16 * u
            assert all(pos < p_pitch for _, pos in image)
            stored = {}
            rows = min(64, b - m0)
            for e in range(rows * (4 * u + 1)):
                r, l = divmod(e, 4 * u + 1)
                dst = out_off + (m0 + r) * f + n0
                c0 = 4 * l - (dst & 3)
                if c0 >= nb:
                    continue
                vals = [image.get((r, 4 * l + i)) for i in range(4)]
                if c0 >= 0 and c0 + 4 <= nb:
                    assert (dst + c0) % 4 == 0
                for i in range(4):
                    if 0 <= c0 + i < nb:
                        assert vals[i] == (r, c0 + i)
                        stored[(r, c0 + i)] = stored.get((r, c0 + i), 0) + 1
            assert stored == {(r, c): 1 for r in range(rows) for c in range(nb)}
