"""VQ-KD and Cluster tokenizer training through the port's entry points
against the JAX package, on the CPU, at tiny widths (img 32, patch 8,
embed 32, depth 2, heads 2; K 16; D 8 for VQ-KD, the teacher's 32 for
Cluster), f32.

The same numpy-made weights reach both packages (flax layout; the port
loads them through ``utils/bridge.py``), and the same numpy batches go
through both. Held within 1e-4 of max|ref| (per tensor; per scalar its own
magnitude):
- ``mask_tree`` and the optimizer's ``exclude`` against ``optax.masked``
  (within 1e-5, as the optimizer tests hold optax);
- ``cluster_stats``, ``kmeans_update``, ``kmeans_init`` (its three
  branches: fewer points than codes, the ``max_points`` subsample and the
  chunked assignment; the JAX draws fed to both) and ``cvq_update``;
- the teachers (CLIP with and without its projection, ViT, DINO),
  ``ClusterEncoder``, ``ViTEncoder`` and ``ViTDecoder``;
- two ``VQKDAlgorithm.train_step``s from ``configs/vqkd/
  clip_8192_imagenet_ddp.py`` (the first fires the lazy k-means init, fed
  JAX's draw), and two ``ClusterAlgorithm.train_step``s from
  ``configs/cluster/clip_8192_imagenet_ddp.py``, both with the models cut
  to the widths above: losses, every parameter, AdamW's or Adam's
  moments, the codebook and ``extra``;
- ``eval_step`` and ``LossMetric`` (the VQ-KD validator's ``r_loss``).

Codes are compared by ``compare_codes``: equal except near-ties. An
element whose first-step JAX gradient is f32 rounding noise (within 1e-6
of the tree's largest; the port's must be noise too) is held to Adam's
bound instead (2 steps x 2 x 1.1 lr), as in ``test_torch_vqgan_train.py``.
The VQ-KD config's warm-up (lr 0 at the first step) is cut to 0 so that
both steps move the weights; its cosine, AdamW, weight decay and
``exclude`` stay.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vector_quantization_tpu.algorithms.vqkd  # noqa: F401  (registers the JAX algorithms)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
import vector_quantization_tpu.training.metrics as jax_metrics
from vector_quantization_tpu.ops import codebook as jax_cb
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.registries import ModelRegistry as JaxModelRegistry
from vector_quantization_tpu.registries import TeacherRegistry as JaxTeacherRegistry
from vector_quantization_tpu.training.optim import build_optimizer as jax_build_optimizer
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu.utils.filters import mask_tree as jax_mask_tree
from vector_quantization_tpu_torch.ops import codebook as cb
from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes, nearest_codes
from vector_quantization_tpu_torch.registries import (
    AlgorithmRegistry,
    EncoderRegistry,
    MetricRegistry,
    ModelRegistry,
    TeacherRegistry,
)
from vector_quantization_tpu_torch.training.optim import build_optimizer
from vector_quantization_tpu_torch.utils.bridge import (
    extra_from_flax,
    extra_to_flax,
    flax_param_paths,
    flax_param_shapes,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import Config
from vector_quantization_tpu_torch.utils.filters import mask_tree

REPO = Path(__file__).resolve().parents[1]
VQKD = str(REPO / "configs/vqkd/clip_8192_imagenet_ddp.py")
CLUSTER = str(REPO / "configs/cluster/clip_8192_imagenet_ddp.py")
REL = 1e-4
NOISE_REL = 1e-6
BATCH, SIZE, K = 4, 32, 16
TINY = dict(embed_dim=32, depth=2, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, rel=REL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * float(np.abs(want).max(initial=0.0)), (what, err, float(np.abs(want).max()))


def _flat(tree, prefix=""):
    """{"a/b": leaf}, keys in jax.tree_util's (sorted) order; optax's
    masked-out leaves dropped."""
    out = {}
    for k, v in sorted(dict(tree).items()):
        if isinstance(v, optax.MaskedNode):
            continue
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _numpy_params(shapes, seed):
    """Flax-layout weights from numpy: kernels N(0, 2/fan_in) (fan_in: all
    but the last axis), norm scales 1 + N(0, 0.05²), position and cls
    embeddings N(0, 0.02²), the codebook N(0, 1), other leaves N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def make(tree, leaf=None):
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        if leaf in ("kernel", "qkv_kernel", "proj"):
            return (rng.standard_normal(tree) * np.sqrt(2.0 / np.prod(tree[:-1]))).astype(np.float32)
        if leaf == "scale":
            return (1.0 + rng.normal(0.0, 0.05, tree)).astype(np.float32)
        if leaf in ("pos_embed", "cls_token"):
            return rng.normal(0.0, 0.02, tree).astype(np.float32)
        if leaf == "codebook":
            return rng.standard_normal(tree).astype(np.float32)
        return rng.normal(0.0, 0.05, tree).astype(np.float32)

    return make(shapes)


def _load(module, seed):
    params = _numpy_params(flax_param_shapes(module), seed)
    module.load_state_dict(state_dict_from_flax(module, params))
    return params


def _uint8(seed, b=BATCH, s=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3), dtype=np.uint8)


def _batch(seed):
    u8 = _uint8(seed)
    return {"image": (u8.astype(np.float32) / 127.5 - 1.0), "original_image": u8}


# -- filters and the optimizer's exclude mask ----------------------------------

_TREE = {"quantizer": {"codebook": (6, 4)}, "encoder": {"teacher": {"backbone": {"kernel": (4, 5), "bias": (5,)}}},
         "decoder": {"task2": {"kernel": (5, 3), "bias": (3,)}}}
_EXCLUDES = ["codebook", ["teacher", "decoder/task2/bias"],
             {"prefixes": ["encoder/"], "suffixes": ["codebook"]},
             {"regexes": [r"task\d/kernel"], "names": ["quantizer/codebook"]}]


@pytest.mark.parametrize("exclude", _EXCLUDES)
def test_exclude_matches_optax_masked(exclude):
    rng = np.random.default_rng(0)
    params = {k: {kk: (jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32), vv,
                                              is_leaf=lambda s: isinstance(s, tuple)))
                  for kk, vv in v.items()} for k, v in _TREE.items()}
    paths = list(_flat(params))
    keep = mask_tree(paths, exclude, value=False)
    assert dict(zip(paths, keep)) == {k: bool(v) for k, v in _flat(jax_mask_tree(params, exclude, False)).items()}
    assert keep == [not m for m in mask_tree(paths, exclude)]
    cfg = dict(type="adamw", lr=1e-2, weight_decay=0.1, grad_clip=0.5, exclude=exclude)
    tx = jax_build_optimizer(cfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    opt = build_optimizer(cfg, paths)
    tparams = [torch.from_numpy(v.copy()) for v in _flat(params).values()]
    tstate = opt.init(tparams)
    assert len(tstate["mu"]) == sum(keep)
    for _ in range(4):
        grads = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, opt.trained([torch.from_numpy(g.copy()) for g in _flat(grads).values()]), tstate)
    for (name, want), got, k in zip(_flat(jparams).items(), tparams, keep):
        if not k:
            assert np.array_equal(got.numpy(), params_flat := _flat(params)[name]), name
            assert np.array_equal(want, params_flat), name
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max()), name
    with pytest.raises(ValueError, match="flax paths"):
        build_optimizer(cfg)


# -- codebook ops ----------------------------------------------------------------


def _points(seed, n=200, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_cluster_stats_and_kmeans_update_match_jax():
    x = _points(1)
    e = _points(2, n=K)
    codes = np.random.default_rng(3).integers(0, K - 3, x.shape[0]).astype(np.int32)  # 3 codes unused
    counts, sums = cb.cluster_stats(torch.from_numpy(x), torch.from_numpy(codes), K)
    jc, js = jax_cb.cluster_stats(jnp.asarray(x), jnp.asarray(codes), K)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    _close(sums, js, "sums")
    assert counts[-3:].sum() == 0
    for decay, norm_in, renorm in ((0.99, True, True), (None, False, False), (0.5, False, True)):
        got = cb.kmeans_update(torch.from_numpy(e), torch.from_numpy(x), torch.from_numpy(codes), decay,
                               normalize_input=norm_in, renormalize=renorm)
        want = jax_cb.kmeans_update(jnp.asarray(e), jnp.asarray(x), jnp.asarray(codes), decay,
                                    normalize_input=norm_in, renormalize=renorm)
        _close(got, want, f"kmeans_update {decay} {norm_in} {renorm}")
        np.testing.assert_array_equal(got[-3:].numpy() == e[-3:], decay is None and not renorm)


def _jax_draws(key, n, k, max_points):
    """The indices ``jax_cb.kmeans_init`` draws from ``key``: the
    subsample's (if n > max_points), then the start's."""
    key, sub_key = jax.random.split(key)
    out = []
    if n > max_points:
        out.append(np.asarray(jax.random.choice(sub_key, n, (max_points,), replace=False)))
        n = max_points
    out.append(np.asarray(jax.random.choice(key, n, (k,), replace=False)))
    return out


def _feeder(draws):
    it = iter(draws)

    def draw(n, m):
        idx = next(it)
        assert idx.shape == (m,) and idx.max() < n
        return torch.from_numpy(idx.astype(np.int64))

    return draw


@pytest.mark.parametrize("branch", ["direct", "pad", "subsample", "chunked"])
def test_kmeans_init_matches_jax(branch):
    n, max_points, chunk_elems = {"direct": (200, 2**20, 2**27), "pad": (10, 2**20, 2**27),
                                  "subsample": (300, 120, 2**27), "chunked": (1000, 2**20, 2000)}[branch]
    x = _points(4, n=n) * 3.0
    key = jax.random.PRNGKey(5)
    want = jax_cb.kmeans_init(jnp.asarray(x), K, key, iters=5, max_points=max_points,
                              chunk_elems=chunk_elems)
    draws = _jax_draws(key, n, K, max_points) if n >= K else []
    got = cb.kmeans_init(torch.from_numpy(x), K, iters=5, max_points=max_points, chunk_elems=chunk_elems,
                         draw=_feeder(draws))
    xn = torch.from_numpy(np.asarray(jax_cb.normalize(jnp.asarray(x))))
    # the codes the two codebooks give, then the codebooks themselves
    e_want = torch.from_numpy(np.asarray(want))
    rep = compare_codes(xn, e_want, nearest_codes(xn, got), nearest_codes(xn, e_want))
    assert rep["ok"], rep
    _close(got, want, f"kmeans_init {branch}")
    if branch == "pad":
        assert torch.equal(got[n:], torch.zeros(K - n, 8))
    else:
        norms = torch.linalg.vector_norm(got, dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_kmeans_init_draws_from_the_generator():
    x = torch.from_numpy(_points(6))
    a = cb.kmeans_init(x, K, torch.Generator().manual_seed(1), iters=2)
    b = cb.kmeans_init(x, K, torch.Generator().manual_seed(1), iters=2)
    c = cb.kmeans_init(x, K, torch.Generator().manual_seed(2), iters=2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cvq_update_matches_jax():
    x = _points(7, n=64)
    e = _points(8, n=K)
    p = np.random.default_rng(9).uniform(0, 0.2, K).astype(np.float32)
    p[:4] = 0.0  # dead codes: decay ~eps, snap to their anchors
    codes = np.random.default_rng(10).integers(4, K, 64).astype(np.int32)
    d = ((x[:, None] - e[None]) ** 2).sum(-1)
    got, gp = cb.cvq_update(torch.from_numpy(e), torch.from_numpy(p), torch.from_numpy(x), torch.from_numpy(d),
                            torch.from_numpy(codes), ema_decay=0.99)
    want, wp, _ = jax_cb.cvq_update(jnp.asarray(e), jnp.asarray(p), jnp.asarray(x), jnp.asarray(d),
                                    jnp.asarray(codes), ema_decay=0.99)
    _close(gp, wp, "probability")
    _close(got, want, "codebook")
    _close(got[:4], x[np.argmin(d, axis=0)][:4], "dead codes at their anchors", rel=1e-2)
    _close(cb.cvq_decay(torch.from_numpy(p), K, 0.99), jax_cb.cvq_decay(jnp.asarray(p), K, 0.99), "decay")


# -- teachers and the ViT halves -------------------------------------------------

_TEACHERS = {
    "clip_proj": dict(type="CLIPTeacher", patch_size=8, proj_dim=16, **TINY),
    "clip_no_proj": dict(type="CLIPTeacher", patch_size=8, proj_dim=None, final_norm=True, **TINY),
    "vit": dict(type="ViTTeacher", patch_size=8, **TINY),
    "dino": dict(type="DINOTeacher", patch_size=8, **TINY),
}


@pytest.mark.parametrize("name", list(_TEACHERS))
def test_teacher_matches_jax(name):
    cfg = _TEACHERS[name]
    port = TeacherRegistry.build({**cfg, "img_size": SIZE})
    params = _load(port, 11)
    u8 = _uint8(12)
    jteacher = JaxTeacherRegistry.build(dict(cfg))
    want = jteacher.apply({"params": params}, jnp.asarray(u8), return_2d=True)
    got = port(torch.from_numpy(u8), return_2d=True)
    _close(got, want, name)
    assert port.out_channels == jteacher.out_channels == want.shape[-1]
    flat = jteacher.apply({"params": params}, jnp.asarray(u8))
    _close(port(torch.from_numpy(u8)), flat, f"{name} flat")
    assert set(_flat(params_to_flax(port))) == set(_flat(params))


def test_teacher_resize_raises():
    """The bicubic resizes are ported (``tests/test_torch_teachers.py``);
    what still raises is a side that is not positive."""
    teacher = TeacherRegistry.build(dict(type="PixelTeacher", patch_size=8, image_size=64, output_size=4))
    assert teacher(torch.from_numpy(_uint8(17)), return_2d=True).shape == (BATCH, 4, 4, 3)
    with pytest.raises(ValueError, match="output_size"):
        TeacherRegistry.build(dict(type="PixelTeacher", patch_size=8, output_size=0))


def test_cluster_encoder_matches_jax():
    teacher = dict(type="CLIPTeacher", patch_size=8, proj_dim=None, final_norm=True, **TINY)
    port = EncoderRegistry.build(dict(type="ClusterEncoder", teacher={**teacher, "img_size": SIZE}))
    params = _load(port, 13)
    image = _batch(14)["image"]
    jenc = JaxModelRegistry.build(dict(type="ClusterEncoder", teacher=teacher))
    want = jenc.apply({"params": params}, jnp.asarray(image))
    got = port(torch.from_numpy(image).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, "cluster encoder")
    assert flax_param_paths(port)["teacher.backbone.ln_pre.weight"] == "teacher/backbone/ln_pre/scale"


@pytest.mark.parametrize("half", ["encoder", "decoder"])
def test_vit_halves_match_jax(half):
    if half == "encoder":
        cfg = dict(type="ViTEncoder", img_size=SIZE, patch_size=8, out_channels=8, **TINY)
        x = np.random.default_rng(15).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    else:
        cfg = dict(type="ViTDecoder", img_size=4, patch_size=1, in_channels=8, out_channels=24,
                   out_patch_size=2, **TINY)
        x = np.random.default_rng(15).standard_normal((BATCH, 4, 4, 8)).astype(np.float32)
    registry = EncoderRegistry if half == "encoder" else ModelRegistry
    port = registry.build(cfg)
    params = _load(port, 16)
    jmod = JaxModelRegistry.build(dict(cfg))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, half)
    if half == "decoder":
        assert type(jmod).last_parameter_path() == ("backbone", "task2", "kernel")
        assert port.last_parameter() is port.backbone.task2.weight
    with pytest.raises(ValueError, match="pos_embed"):
        port(torch.zeros(1, x.shape[-1], 2 * x.shape[1], 2 * x.shape[2]))


# -- train steps -------------------------------------------------------------------


def _tiny_model(algorithm, port):
    """The config's model cut to the tiny widths (the port's teachers also
    take ``img_size``)."""
    img = {"img_size": SIZE} if port else {}
    model = dict(algorithm["model"])
    if algorithm["type"] == "VQKDAlgorithm":
        model["encoder"] = dict(model["encoder"], img_size=SIZE, patch_size=8, out_channels=8, **TINY)
        model["quantizer"] = dict(model["quantizer"], codebook_size=K, embedding_dim=8)
        model["pre_decode"] = dict(model["pre_decode"], out_channels=8)
        model["decoder"] = dict(model["decoder"], img_size=SIZE // 8, in_channels=8, out_channels=16, **TINY)
        teacher = dict(algorithm["teacher"], patch_size=8, proj_dim=16, **TINY, **img)
        return dict(algorithm, model=model, teacher=teacher)
    teacher = dict(model["encoder"]["teacher"], patch_size=8, **TINY, **img)
    model["encoder"] = dict(model["encoder"], teacher=teacher)
    model["quantizer"] = dict(model["quantizer"], codebook_size=K, embedding_dim=TINY["embed_dim"])
    return dict(algorithm, model=model)


def _algorithm_cfg(load, path, port):
    cfg = dict(load(path)["trainer"]["algorithm"])
    opt = dict(cfg["optimizer"])
    if "schedule" in opt:
        opt["schedule"] = dict(opt["schedule"], warmup=0)
    return _tiny_model(dict(cfg, optimizer=opt), port)


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the (masked) chain."""
    if hasattr(opt_state, "mu"):
        return opt_state
    children = opt_state if isinstance(opt_state, tuple) else (getattr(opt_state, "inner_state", ()),)
    for child in children:
        found = _adam_state(child) if isinstance(child, tuple) or hasattr(child, "inner_state") or \
            hasattr(child, "mu") else None
        if found is not None:
            return found
    return None


_JAX_STEPS: dict = {}


def _pair(path, seed):
    jcfg = _algorithm_cfg(jax_load_config, path, port=False)
    jalgo = JaxAlgorithmRegistry.build(jcfg)
    algo = AlgorithmRegistry.build(_algorithm_cfg(Config.load, path, port=True), device="cpu")
    params = _load(algo.model, seed)
    state = algo.init_state(0)
    extra = {}
    if hasattr(algo, "teacher"):
        extra["teacher_params"] = _numpy_params(flax_param_shapes(algo.teacher), seed + 1)
        extra["initialized"] = np.zeros((), np.bool_)
    if "probability" in state.extra:
        extra["probability"] = np.zeros(K, np.float32)
    extra_from_flax(algo, state, extra)
    jstate = JaxTrainState.create(params=params, opt_state=jalgo.tx(params).init(params),
                                  rng=jax.random.PRNGKey(seed), extra=extra)
    if path not in _JAX_STEPS:
        _JAX_STEPS[path] = jax.jit(jalgo.train_step)
    return jalgo, jax.tree_util.tree_map(jnp.asarray, jstate), algo, state


def _lazy_init_draw(jrng, n):
    """The start ``ReconstructionAlgorithm.train_step`` draws for the
    lazy k-means init from the state's key (``next_rng``, then the first
    of three)."""
    _, sub = jax.random.split(jrng)
    return _jax_draws(jax.random.split(sub, 3)[0], n, K, 2**20)


def _close_params(got, want, what, noise, noise_tol):
    """Every leaf of ``want`` within 1e-4 of its max|ref|; the elements
    ``noise`` marks within ``noise_tol`` (or that)."""
    for name, w in want.items():
        g = got[name]
        mask = noise.get(name, np.zeros(w.shape, bool))
        tol = max(noise_tol, REL * float(np.abs(w).max()))
        assert float(np.abs(g - w)[mask].max(initial=0.0)) <= tol, (what, name, "noise elements")
        _close(g[~mask], w[~mask], f"{what} {name}")


@pytest.mark.parametrize("path", [VQKD, CLUSTER], ids=["vqkd", "cluster"])
def test_two_train_steps_match_jax(path, monkeypatch):
    jalgo, jstate, algo, state = _pair(path, seed=20)
    vqkd = type(algo).__name__ == "VQKDAlgorithm"
    assert type(algo).__name__ == type(jalgo).__name__
    if vqkd:
        draws = _lazy_init_draw(jstate.rng, BATCH * (SIZE // 8) ** 2)
        monkeypatch.setattr(cb, "kmeans_init", functools.partial(cb.kmeans_init, draw=_feeder(draws)))
        teacher_before = {k: v.clone() for k, v in algo.teacher.state_dict().items()}
    # the optimizer's exclude also freezes: VQ-KD's codebook, Cluster's encoder (its teacher)
    frozen = [n for n, p in algo.model.named_parameters() if not p.requires_grad]
    assert frozen == (["quantizer.codebook"] if vqkd else
                      [n for n, _ in algo.model.named_parameters() if n.startswith("encoder.")])
    lr = algo.optimizer_cfg["lr"]
    for i in range(2):
        batch = _batch(30 + i)
        jstate, jm = _JAX_STEPS[path](jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm), set(m) ^ set(jm)
        for name in jm:
            want = float(jm[name])
            assert abs(float(m[name]) - want) <= REL * max(abs(want), 1e-6), (i, name, float(m[name]), want)
        jadam = _adam_state(jstate.opt_state)
        kept = [n for n, p in algo.model.named_parameters() if p.requires_grad]
        mu = dict(zip(kept, state.opt_state["mu"]))
        got_mu = _flat(params_to_flax(algo.model, {n: mu.get(n, torch.zeros_like(p))
                                                   for n, p in algo.model.named_parameters()}))
        want_mu = _flat(jadam.mu)
        assert set(want_mu) == {flax_param_paths(algo.model)[n] for n in kept}
        if i == 0:  # first-step gradients that are rounding noise, in JAX and then in the port
            top = max(float(np.abs(v).max()) for v in want_mu.values())
            noise = {k: np.abs(v) <= NOISE_REL * top for k, v in want_mu.items()}
            assert all((np.abs(got_mu[k][noise[k]]) <= 10 * NOISE_REL * top).all() for k in noise)
        # at step 2 a noise element's mu is b1·(noise) + (1 − b1)·g2: equal to
        # JAX's within twice the noise bound, so g2 agrees there too
        _close_params(got_mu, want_mu, f"step {i} mu", noise, 2 * 10 * NOISE_REL * top)
    assert state.step == 2 and int(jstate.step) == 2
    # each of two Adam steps moves an element by at most ~lr
    _close_params(_flat(params_to_flax(algo.model)), _flat(jstate.params), "params", noise, 2 * 2 * 1.1 * lr)
    got_extra, want_extra = extra_to_flax(algo, state), jax.tree_util.tree_map(np.asarray, dict(jstate.extra))
    assert set(got_extra) == set(want_extra)
    codebook = algo.model.quantizer.codebook.detach()
    if vqkd:
        assert got_extra["initialized"] and bool(want_extra["initialized"])
        assert all(torch.equal(v, teacher_before[k]) for k, v in algo.teacher.state_dict().items())
        assert _flat(got_extra["teacher_params"]).keys() == _flat(want_extra["teacher_params"]).keys()
        for k, v in _flat(want_extra["teacher_params"]).items():
            assert np.array_equal(_flat(got_extra["teacher_params"])[k], v), k
        norms = torch.linalg.vector_norm(codebook, dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    else:
        _close(got_extra["probability"], want_extra["probability"], "probability")
    # the last step's lookup: equal codes (near-ties aside) from the two codebooks
    feat = algo.model.encode(torch.from_numpy(_batch(31)["image"])).detach().reshape(-1, codebook.shape[1])
    q = algo.model.quantizer
    e_want = torch.from_numpy(np.asarray(jstate.params["quantizer"]["codebook"]))
    rep = compare_codes(feat, e_want, q.encode(feat), nearest_codes(feat, e_want, q.distance), q.distance)
    assert rep["ok"], rep


def test_vqkd_eval_step_and_loss_metric_match_jax():
    jalgo, jstate, algo, state = _pair(VQKD, seed=40)
    metrics_cfg = Config.load(VQKD)["validator"]["metrics"]
    assert metrics_cfg["r_loss"] == {"type": "LossMetric", "key": "loss_cosine"}
    metric = MetricRegistry.build(metrics_cfg["r_loss"])
    jmetric = jax_metrics.LossMetric(key="loss_cosine")
    for i in range(2):
        batch = _batch(50 + i)
        jmemo = jax.jit(jalgo.eval_step)(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        memo = algo.eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(memo) == set(jmemo) == {"codes", "pred", "loss_commitment", "loss_cosine"}
        for name in ("pred", "loss_commitment", "loss_cosine"):
            _close(memo[name], jmemo[name], name)
        np.testing.assert_array_equal(memo["codes"].numpy(), np.asarray(jmemo["codes"]))
        metric.update(memo)
        jmetric.update({k: np.asarray(v) for k, v in jmemo.items()})
    got, want = metric.summary("r_loss")["r_loss"], jmetric.summary("r_loss")["r_loss"]
    assert abs(got - want) <= REL * abs(want), (got, want)


# -- the shipped configs at full width -------------------------------------------


@pytest.mark.parametrize("path", [VQKD, CLUSTER], ids=["vqkd", "cluster"])
def test_config_builds_at_full_width(path):
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(Config.load(path)["trainer"]["algorithm"], device="meta")
    q = algo.model.quantizer
    n_params = sum(p.numel() for p in algo.model.parameters())
    tx = algo.tx()
    if type(algo).__name__ == "VQKDAlgorithm":
        assert (q.codebook_size, q.embedding_dim, q.distance, q.normalize_inputs) == (8192, 32, "cosine", True)
        enc, dec = algo.model.encoder, algo.model.decoder
        assert (enc.backbone.depth, enc.backbone.pos_embed.shape[1], enc.out_channels) == (12, 197, 32)
        assert (dec.backbone.depth, dec.backbone.pos_embed.shape[1], dec.out_channels) == (3, 197, 512)
        t = algo.teacher
        assert type(t).__name__ == "CLIPTeacher" and t.out_channels == 512 and t.backbone.depth == 12
        assert t.backbone.patch_embed.bias is None and t.backbone.ln_pre.eps == 1e-5
        assert not any(p.requires_grad for p in t.parameters())
        assert algo.codebook_update == {"type": "kmeans", "decay": 0.99}
        assert algo.lazy_kmeans_init == {"iters": 10} and algo.recon_losses == {"cosine": {}}
        assert (tx.kind, tx.weight_decay, tx.keep.count(False)) == ("adamw", 1e-4, 1)
        assert n_params == 109_092_416
    else:
        assert (q.codebook_size, q.embedding_dim, q.distance) == (8192, 768, "l2")
        t = algo.model.encoder.teacher
        assert type(t).__name__ == "CLIPTeacher" and t.out_channels == 768 and t.backbone.proj is None
        assert algo.codebook_update == {"type": "cvq", "ema_decay": 0.99, "anchor": "nearest", "sync": True}
        assert (tx.kind, tx.keep.count(True)) == ("adam", 1)
        assert n_params == 92_090_880
