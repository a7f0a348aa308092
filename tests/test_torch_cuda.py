"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (decided inside the
fixture, never at import). On a GPU machine without JAX run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.ops import flash_attention as fa
from vector_quantization_tpu_torch.ops.int8_matmul import (
    int8_matmul,
    int8_matmul_reference,
)
from vector_quantization_tpu_torch.ops.paged_attention import (
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


@pytest.mark.parametrize(
    "b,d,f",
    [
        (64, 1024, 3072), (64, 1024, 1024), (64, 1024, 5632),
        (64, 2816, 1024), (64, 1024, 17385),
        (1, 1024, 3072), (7, 2816, 1024), (3, 100, 37), (130, 96, 200),
    ],
)
def test_int8_matmul_kernel_matches_plain(dev, b, d, f):
    # bf16 inputs, exact bf16*int8 products, f32 sums in another order
    rng = np.random.default_rng(b * 7 + d + f)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, f).astype(np.float32)).to(dev)
    before = int8_matmul.launches
    got = int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, f)
    assert _rel_err(got, int8_matmul_reference(x, w, s)) <= 1e-3


def _paged_inputs(dev, *, pool_dtype, q_dtype, b=64, h=16, dh=64, ps=64,
                  n_layers=3, p_cap=5, seed=0):
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
    lengths = rng.integers(0, p_cap * ps + 1, b).astype(np.int32)
    lengths[:6] = [0, 1, ps, ps + 1, p_cap * ps, 2]
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


@pytest.mark.parametrize(
    "n,k,d,dtype,metric,ties",
    [
        (16384, 16384, 8, torch.float32, "l2", False),  # the tokenizer's lookup
        (16384, 16384, 8, torch.bfloat16, "l2", False),
        (16384, 16384, 256, torch.float32, "l2", False),
        (1000, 777, 40, torch.float32, "cosine", False),
        (1, 16384, 8, torch.float32, "l2", False),
        (4096, 1000, 8, torch.float32, "l2", True),
        (4096, 1000, 8, torch.bfloat16, "l2", True),
    ],
)
def test_nearest_codes_kernel_matches_plain(dev, n, k, d, dtype, metric, ties):
    # f32 scores summed in another order: rows may differ only as near-ties
    # (compare_codes); planted exact ties go to the lowest index exactly
    rng = np.random.default_rng(n + k + d)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = rng.standard_normal((k, d), dtype=np.float32)
    if ties:
        e[1::2] = e[0::2][: k // 2]
        x[::3] = e[rng.integers(0, k // 2, x[::3].shape[0]) * 2]
    x = torch.from_numpy(x).to(dev, dtype)
    e = torch.from_numpy(e).to(dev, dtype)
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
     (2, 640, 4, 64), (2, 641, 4, 64), (2, 256, 4, 128), (2, 1472, 2, 32), (2, 1473, 2, 32)],
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
    # aligned (dkv reads them by TMA, dq 16 bytes at a time), and launch
    # nothing
    fn = getattr(fa, kernel)
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    x, y = buf[1:n + 1].view(shape), buf[8:].view(shape)
    lse = torch.zeros((1, 2, 64), device=dev)
    cases = [(x, y, y, y, lse, lse), (y, x, y, y, lse, lse), (y, y, x, y, lse, lse),
             (y, y, y, x, lse, lse)]
    before = fn.launches
    for args in cases:
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(*args)
    assert fn.launches == before
    out = fn(y, y, y, y, lse, lse)  # the aligned views run
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert all(bool(torch.isfinite(t.float()).all()) for t in (out if isinstance(out, tuple) else (out,)))


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
