"""GPT-2 through the port against the JAX package, on the CPU, f32 (vocab
32, width 32, 2 layers, 2 heads, max_length 16; every bias, LayerNorm
scale and embedding drawn from numpy, so none is at its init value).

Held within 1e-4 of max|ref| (per tensor):
- the training forward's logits and the gradient of ``next_token_ce``
  with respect to every parameter;
- two ``ARAlgorithm.train_step``s of ``configs/regression/ar_anchor.py``
  with its transformer swapped for GPT-2 (the dense head and
  ``next_token_ce``, since ``supports_fused_ce`` is false), from the
  drawn weights: the losses within 1e-5 relative, every weight within
  1e-4 of max|ref|, except the
  elements whose first-step JAX gradient is f32 rounding noise (the key
  part of ``c_attn``'s bias, which the softmax cancels): AdamW turns
  those into full steps, and they are held to its bound, 2 steps x 2 x
  1.1 lr, as in ``tests/test_torch_vqgan_train.py``;
- the cached decode (a 3-token prefill, then single steps) with an f32 and
  with an INT8 KV cache, and the ``slot_positions`` decode at staggered
  columns (``tests/test_serving.py``'s GPT-2 slot tests: it equals the
  full forward, and JAX's);
- ``generate`` with ``kv_segment`` equal to the full-window one, sampled
  (``tests/test_ar.py``'s segmented-generate test), and greedy ``generate``
  equal to JAX's token for token;
- the dense ``ARServer`` on GPT-2: its per-row scatter engine (the learned
  positions rule out the shared column) gives JAX's server's streams.

``ops/f32_gemm.py``, which GPT-2's ``_Dense`` and head call, on the CPU:
the dispatch keeps CPU tensors on ``torch.matmul``; the autograd function,
with the plain product in the kernel's place, gives the outputs and
gradients of the products it replaces; every product of either branch
runs inside the range ``gpt2.gemm``; the plan covers the sum over K; the
wrapper's operand layouts, emulated with the kernel's indexing, give
``a @ b``. The kernel itself is held
against float64 in ``tests/test_torch_cuda.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.ar  # noqa: F401  (registers the JAX algorithm)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.models.transformers.gpt2 import GPT2Transformer as JaxGPT2
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.tasks.sequence_modeling import TokenCodebook as JaxCodebook
from vector_quantization_tpu.tasks.sequence_modeling import generate as jax_generate
from vector_quantization_tpu.tasks.sequence_modeling import next_token_ce as jax_next_token_ce
from vector_quantization_tpu.tasks.serving import ARServer as JaxServer
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.models.transformers.gpt2 import GPT2Transformer
from vector_quantization_tpu_torch.ops import f32_gemm
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook, generate, next_token_ce
from vector_quantization_tpu_torch.tasks.serving import ARServer
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax, llama_params_to_flax, load_ar_from_flax
from vector_quantization_tpu_torch.utils.config import Config
from test_torch_vqkd import NOISE_REL, _adam_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ANCHOR = str(REPO / "configs/regression/ar_anchor.py")
TINY = dict(vocabulary_size=32, hidden_size=32, num_layers=2, num_heads=2, max_length=16)
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _close(got, want, what, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * float(np.abs(want).max(initial=0.0)), (what, err, float(np.abs(want).max()))


def _params(seed=0, **over):
    """JAX's init, then every leaf redrawn from numpy: kernels and
    embeddings N(0, 0.2²) (wide enough that the logits spread), biases
    N(0, 0.05²), LayerNorm scales 1 + N(0, 0.05²)."""
    cfg = {**TINY, **over}
    params = JaxGPT2(**cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.default_rng(seed + 100)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "scale":
            return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(params))


def _pair(seed=0, **over):
    cfg = {**TINY, **over}
    params = _params(seed, **over)
    tt = GPT2Transformer(**cfg)
    tt.load_state_dict(llama_params_from_flax(params))
    return JaxGPT2(**cfg), jax.tree_util.tree_map(jnp.asarray, params), tt.eval()


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, TINY["vocabulary_size"], (b, t)).astype(np.int32)


def test_training_forward_and_gradients_match_jax():
    jt, params, tt = _pair()
    toks = _tokens(1, 3, TINY["max_length"])
    want = jt.apply({"params": params}, jnp.asarray(toks))
    got = tt(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and not tt.supports_fused_ce
    _close(got, want, "logits")
    jgrads = jax.grad(lambda p: jax_next_token_ce(jt.apply({"params": p}, jnp.asarray(toks)),
                                                  jnp.asarray(toks)))(params)
    tt.zero_grad()
    next_token_ce(tt(torch.from_numpy(toks)), torch.from_numpy(toks)).backward()
    grads = _flat(llama_params_to_flax(tt))
    got_grads = {name: p.grad for name, p in tt.named_parameters()}
    want_grads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(want_grads) == set(got_grads)
    for name, w in want_grads.items():
        _close(got_grads[name], w, f"grad {name}")


def test_two_ar_train_steps_match_jax():
    override = dict(transformer=dict(type="GPT2Transformer", hidden_size=32, num_layers=2, num_heads=2), cfg=None)
    jcfg = jax_load_config(ANCHOR)["trainer"]["algorithm"]
    jcfg.update(override)
    jalgo = JaxAlgorithmRegistry.build(jcfg)
    jstate = jalgo.init_state(jax.random.PRNGKey(0), {})
    cfg = Config.load(ANCHOR)["trainer"]["algorithm"]
    cfg.update(override)
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    assert type(algo.model).__name__ == "GPT2Transformer" and not algo._use_fused()
    assert (algo.model.vocabulary_size, algo.model.max_length) == (jalgo.model.vocabulary_size, 65)
    params = _params(0, vocabulary_size=jalgo.model.vocabulary_size, max_length=65)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=jalgo.tx(params).init(params))
    load_ar_from_flax(algo, params, jax.tree_util.tree_map(np.asarray, jstate.extra["ir_params"]))
    state = algo.init_state(0)
    step = jax.jit(jalgo.train_step)
    rng = np.random.default_rng(3)
    for i in range(2):
        batch = {"codes": rng.integers(0, 64, (4, 8, 8)).astype(np.int32),
                 "category": rng.integers(0, 10, 4).astype(np.int32)}
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        if i == 0:  # the first-step gradients that are rounding noise
            mu = _flat(jax.tree_util.tree_map(np.asarray, dict(_adam_state(jstate.opt_state).mu)))
            top = max(float(np.abs(v).max()) for v in mu.values())
            noise = {k: np.abs(v) <= NOISE_REL * top for k, v in mu.items()}
    assert noise["h0.c_attn.bias"][32:64].all() and not noise["h0.c_attn.bias"][:32].any()
    got = _flat(llama_params_to_flax(algo.model))
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jstate.params)))
    assert set(got) == set(want) == set(noise)
    bound = 2 * 2 * 1.1 * algo.optimizer_cfg["lr"]
    for name, w in want.items():
        assert float(np.abs(got[name] - w)[noise[name]].max(initial=0.0)) <= bound, name
        _close(got[name][~noise[name]], w[~noise[name]], name)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_cached_decode_matches_jax(cache_dtype):
    jt, params, tt = _pair(1)
    b = 3
    jc = jt.init_cache(b, dtype=getattr(jnp, cache_dtype))
    tc = tt.init_cache(b, dtype=getattr(torch, cache_dtype), device="cpu")
    toks = _tokens(2, b, 3)
    with torch.inference_mode():
        for _ in range(6):
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc)
            tl, tc = tt(torch.from_numpy(toks), tc)
            assert tl.dtype == torch.float32 and tc.length == int(jc.length)
            _close(tl, jl, "logits")
            toks = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    if cache_dtype == "int8":
        for i in range(TINY["num_layers"]):
            for t, j in ((tc.k[i], jc.k[i]), (tc.v[i], jc.v[i])):
                diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
            _close(tc.k_scale[i], jc.k_scale[i], "k_scale")


def test_slot_positions_decode_matches_full_forward_and_jax():
    jt, params, tt = _pair(2)
    toks = np.asarray([[3, 1, 30, 4]], np.int32)
    full = jt.apply({"params": params}, jnp.asarray(toks))
    _close(tt(torch.from_numpy(toks)), full, "full forward")
    jc, tc = jt.init_cache(1, dtype=jnp.float32), tt.init_cache(1, dtype=torch.float32, device="cpu")
    outs = []
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            pos = np.asarray([t], np.int32)
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks[:, t:t + 1]), jc, slot_positions=jnp.asarray(pos))
            tl, tc = tt(torch.from_numpy(toks[:, t:t + 1]), tc, slot_positions=torch.from_numpy(pos))
            _close(tl, jl, f"slot step {t}")
            outs.append(tl[:, 0])
    _close(torch.stack(outs, 1), full, "slot decode vs full forward")
    # staggered rows, each at its own column
    jc, tc = jt.init_cache(3, dtype=jnp.float32), tt.init_cache(3, dtype=torch.float32, device="cpu")
    toks = np.asarray([[3], [5], [7]], np.int32)
    with torch.inference_mode():
        for step in range(6):
            pos = np.asarray([step, step + 4, step + 1], np.int32)
            jl, jc = jt.apply({"params": params}, jnp.asarray(toks), jc, slot_positions=jnp.asarray(pos))
            tl, tc = tt(torch.from_numpy(toks), tc, slot_positions=torch.from_numpy(pos))
            _close(tl, jl, f"staggered step {step}")
            toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_segmented_generate_matches_full_window():
    _, _, tt = _pair(3, vocabulary_size=64, max_length=40)
    prefix = torch.zeros((2, 1), dtype=torch.int32)
    kw = dict(sampler={"top_k": 5}, cache_dtype=torch.float32)
    full = generate(tt, prefix, 32, TokenCodebook(12, 48), torch.Generator().manual_seed(7), kv_segment=None, **kw)
    seg = generate(tt, prefix, 32, TokenCodebook(12, 48), torch.Generator().manual_seed(7), kv_segment=8, **kw)
    assert torch.equal(full, seg) and int(full.min()) >= 0 and int(full.max()) < 48


@pytest.mark.parametrize("cfg_alpha,kv_segment", [(None, None), (1.75, 4)])
def test_greedy_generate_matches_jax(cfg_alpha, kv_segment):
    jt, params, tt = _pair(4)
    prefix = np.asarray([[10], [10], [3], [5]], np.int32)
    want = jax_generate(jt, params, jnp.asarray(prefix), 12, JaxCodebook(11, 16), jax.random.PRNGKey(1),
                        sampler={"top_k": 1}, cfg_alpha=cfg_alpha, cache_dtype=jnp.float32,
                        kv_segment=kv_segment)
    got = generate(tt, torch.from_numpy(prefix), 12, TokenCodebook(11, 16), torch.Generator().manual_seed(1),
                   sampler={"top_k": 1}, cfg_alpha=cfg_alpha, cache_dtype=torch.float32, kv_segment=kv_segment)
    assert got.shape == (4 if cfg_alpha is None else 2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_server_streams_match_jax():
    jt, params, tt = _pair(5)
    recipe = dict(image_tokens=6, batch_slots=4, sampler={"temperature": 1e-4}, cfg_alpha=1.75, uncond_token=10,
                  steps_per_sync=3)
    js = JaxServer(jt, params, JaxCodebook(11, 16), cache_dtype=jnp.float32, **recipe)
    ts = ARServer(tt, None, TokenCodebook(11, 16), cache_dtype=torch.float32, device="cpu", **recipe)
    assert not ts._shared_col and not js._shared_col
    want, got = ({}, {})
    for server, out in ((js, want), (ts, got)):
        for c in (2, 7, 5, 1, 3):
            server.submit(category=c)
        out.update(dict(server.run_until_drained()))
    assert got.keys() == want.keys() == {0, 1, 2, 3, 4}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert int(got[rid].min()) >= 0 and int(got[rid].max()) < 16


def _dense_operands(seed, lead, fin, fout):
    rng = np.random.default_rng(seed)
    x, w, b = (torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32))
               for shape in (lead + (fin,), (fin, fout), (fout,)))
    return x.requires_grad_(), w.requires_grad_(), b.requires_grad_()


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dense_and_head_keep_cpu_tensors_on_torch_matmul(lead):
    x, w, b = _dense_operands(6, lead, 8, 12)
    launches = f32_gemm.matmul.launches
    assert not f32_gemm.takes_kernel(x, w)
    assert torch.equal(f32_gemm.dense(x, w, b), torch.matmul(x, w) + b)
    assert torch.equal(f32_gemm.tied_head(x, w.t()), torch.matmul(x, w))
    assert f32_gemm.matmul.launches == launches


@pytest.mark.parametrize("transposed", [False, True])
def test_product_plain_path_matches_the_products_it_replaces(transposed, monkeypatch):
    """``Product`` with the plain product (``matmul_reference``) in the
    kernel's place, on CPU tensors: the output equals ``torch.matmul`` (+
    bias), and its input, weight and bias gradients those autograd takes
    through ``torch.matmul``."""
    monkeypatch.setattr(f32_gemm, "matmul", f32_gemm.matmul_reference)
    x, w, b = _dense_operands(7, (9,), 16, 24)
    weight = w.detach().t().contiguous().requires_grad_() if transposed else w
    bias = None if transposed else b
    gy = torch.from_numpy(np.random.default_rng(8).normal(0.0, 1.0, (9, 24)).astype(np.float32))
    got = f32_gemm.Product.apply(x, weight, bias, transposed)
    want = torch.matmul(x, weight.t() if transposed else weight) + (0.0 if transposed else bias)
    assert torch.equal(got, want)
    inputs = (x, weight) if transposed else (x, weight, bias)
    got_grads = torch.autograd.grad(got, inputs, gy)
    want_grads = torch.autograd.grad(want, inputs, gy)
    for g, w_ in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)


def _mm_ranges(run):
    """Under the CPU profiler: for each ``aten::mm`` that ``run`` reaches,
    whether ``gpt2.gemm`` encloses it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    out = []
    for e in prof.events():
        if e.name == "aten::mm":
            p = e.cpu_parent
            while p is not None and p.name != "gpt2.gemm":
                p = p.cpu_parent
            out.append(p is not None)
    return out


@pytest.mark.parametrize("transposed", [False, True])
def test_products_of_either_branch_run_inside_the_range(transposed, monkeypatch):
    """``dense`` and ``tied_head`` open ``gpt2.gemm`` around the product
    whichever computes it, so a product that falls to ``torch.matmul``
    lands inside the range as ``aten::mm`` (the benchmark's
    ``gpt2_gemm_kernel_share.train`` then reads below 100); ``Product``'s
    forward and both backward products run inside it too."""
    x, w, b = _dense_operands(11, (6,), 16, 24)
    weight = w.detach().t().contiguous().requires_grad_() if transposed else w

    def call():
        return f32_gemm.tied_head(x, weight) if transposed else f32_gemm.dense(x, weight, b)

    # torch.matmul's forward inside the range; its backward runs on autograd's engine, outside it
    assert _mm_ranges(lambda: call().sum().backward()) == [True, False, False]
    monkeypatch.setattr(f32_gemm, "takes_kernel", lambda *_: True)
    monkeypatch.setattr(f32_gemm, "matmul", f32_gemm.matmul_reference)
    assert _mm_ranges(lambda: call().sum().backward()) == [True, True, True]


def test_gpt2_layers_go_through_dense_and_head(monkeypatch):
    _, _, tt = _pair(6)
    calls = []
    real_dense, real_head = f32_gemm.dense, f32_gemm.tied_head
    monkeypatch.setattr("vector_quantization_tpu_torch.models.transformers.gpt2.dense",
                        lambda *a: calls.append("dense") or real_dense(*a))
    monkeypatch.setattr("vector_quantization_tpu_torch.models.transformers.gpt2.tied_head",
                        lambda *a: calls.append("head") or real_head(*a))
    tt(torch.from_numpy(_tokens(9, 2, 5)))
    assert calls == ["dense"] * 4 * TINY["num_layers"] + ["head"]


@pytest.mark.parametrize("m,k,n", [(16448, 1024, 3072), (16448, 3072, 1024), (1024, 16448, 3072),
                                   (1024, 16448, 1024), (4096, 16448, 1024), (16448, 1024, 17384),
                                   (17384, 16448, 1024), (771, 1024, 17384), (37, 3000, 8)])
def test_plan_covers_the_sum(m, k, n):
    p = f32_gemm.plan(m, k, n, 132)
    assert p.k_per_split % 32 == 0 and (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    assert p.swap == (2 * m < n) and 1 <= p.blocks <= min(132, p.tiles)
    rows, cols = (n, m) if p.swap else (m, n)
    assert p.tiles == -(-rows // 128) * -(-cols // 128) * p.splits
    assert p == f32_gemm.plan(m, k, n, 132)


def _tf32(v):
    """cvt.rna.tf32.f32: the top 10 mantissa bits, rounded to nearest, ties away."""
    i = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0x1000) & 0xFFFFE000
    return torch.where(i >= 2**31, i - 2**32, i).to(torch.int32).view(torch.float32)


def _read(t, transposed, pitch, rows, cols):
    """The (rows, cols) matrix the kernel reads at t's storage offset."""
    flat = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
    i, r = torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij")
    return flat[t.storage_offset() + (r * pitch + i if transposed else i * pitch + r)]


@pytest.mark.parametrize("rows", [37, 40])
def test_an_operand_that_lies_otherwise_is_copied_to_aligned_rows(rows):
    """An expanded gradient (strides 0, as a sum's), transposed as a weight
    gradient reads it, over a ragged number of rows: ``_as_read`` copies it
    to rows padded to a multiple of 4 elements, which the kernel reads as
    the operand itself."""
    t = torch.arange(12, dtype=torch.float32)[:, None].expand(12, rows).t().t()
    got, transposed, pitch = f32_gemm._as_read(t)
    assert not transposed and pitch % 4 == 0 and pitch >= rows and got.stride(0) == pitch
    assert torch.equal(_read(got, False, pitch, 12, rows), t)


@pytest.mark.parametrize("m,k,n,a_t,b_t,bias", [(300, 64, 96, False, False, True), (40, 64, 200, False, False, True),
                                                (64, 300, 200, True, False, False), (100, 64, 36, False, True, False),
                                                (8, 3000, 8, True, False, False), (130, 4096, 12, False, False, True)])
def test_operand_layouts_emulated(m, k, n, a_t, b_t, bias):
    """``matmul``'s plan and operand layouts (``_as_read``), run through an
    emulation of the kernel on the CPU (A read as it lies and split, B's
    TF32 parts as the prologue writes them, the parts of K, the bias on the
    first part, the store transposed where the plan swaps) give a @ b."""
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.normal(0.0, 1.0, (k, m) if a_t else (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0.0, 1.0, (n, k) if b_t else (k, n)).astype(np.float32))
    a, b = (a.t() if a_t else a), (b.t() if b_t else b)
    bb = torch.from_numpy(rng.normal(0.0, 1.0, (n,)).astype(np.float32)) if bias else None
    p = f32_gemm.plan(m, k, n, 4)
    A, B = (b.t(), a) if p.swap else (a, b.t())
    A, a_trans, lda = f32_gemm._as_read(A)
    B, b_trans, ldb = f32_gemm._as_read(B)
    av, bv = _read(A, a_trans, lda, A.shape[0], k), _read(B, b_trans, ldb, B.shape[0], k)
    ah, bh = _tf32(av), _tf32(bv)
    al, bl = _tf32(av - ah), _tf32(bv - bh)
    out = torch.zeros(p.splits, m, n, dtype=torch.float64)
    for s in range(p.splits):
        r = slice(s * p.k_per_split, min(k, (s + 1) * p.k_per_split))
        c = sum(x[:, r].double() @ y[:, r].double().t() for x, y in ((al, bh), (ah, bl), (ah, bh)))
        if bb is not None and s == 0:
            c = c + (bb.double()[:, None] if p.swap else bb.double())
        out[s] = c.t() if p.swap else c
    want = a.double() @ b.double() + (0.0 if bb is None else bb.double())
    assert float((out.sum(0) - want).abs().max() / want.abs().max()) < 1e-6
