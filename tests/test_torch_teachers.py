"""The teachers' bicubic resize and the ConvNeXt teacher against the JAX
package, on the CPU, f32.

- ``ops.resize.resize(..., "bicubic")`` against ``jax.image.resize(..., "bicubic")`` (Keys'
  cubic, a = -0.5, antialiased on a downscale) within 1e-5 of max|ref| at
  16 -> 14, 14 -> 16, 7 -> 14 and 224 -> 224, the last within 1e-6 (both
  leave an unchanged axis as it is).
- A tiny ConvNeXt (depths (1, 1, 2, 1), widths (8, 16, 32, 64)) at 64 px,
  with and without ``output_size``, within 1e-4 of max|ref|.
- Two ``VQKDAlgorithm.train_step``s of ``configs/vqkd/
  convnext_8192_imagenet_ddp.py`` with that teacher (``output_size`` 8:
  the 2×2 map up to the 8×8 code grid) and the ViT halves of
  ``tests/test_torch_vqkd.py`` at 64 px, held as that file holds VQ-KD's
  (the first step fires the lazy k-means init, fed JAX's draw).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.vqkd  # noqa: F401  (registers the JAX algorithms)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.registries import TeacherRegistry as JaxTeacherRegistry
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.ops.resize import resize, resize_weights
from vector_quantization_tpu_torch.ops import codebook as cb
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, TeacherRegistry
from vector_quantization_tpu_torch.utils.bridge import (
    extra_from_flax,
    extra_to_flax,
    flax_param_paths,
    flax_param_shapes,
    params_to_flax,
)
from vector_quantization_tpu_torch.utils.config import Config
from test_torch_vqkd import (  # noqa: E402
    K,
    NOISE_REL,
    REL,
    TINY,
    _adam_state,
    _close,
    _close_params,
    _feeder,
    _flat,
    _lazy_init_draw,
    _load,
    _numpy_params,
)

REPO = Path(__file__).resolve().parents[1]
CONVNEXT = str(REPO / "configs/vqkd/convnext_8192_imagenet_ddp.py")
TINY_CONVNEXT = dict(type="ConvNeXtTeacher", depths=(1, 1, 2, 1), widths=(8, 16, 32, 64))
SIZE, BATCH = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sizes", [(16, 14), (14, 16), (7, 14), (224, 224)], ids=lambda s: f"{s[0]}to{s[1]}")
def test_bicubic_resize_matches_jax(sizes):
    n, m = sizes
    x = np.random.default_rng(n * 1000 + m).standard_normal((2, n, n, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, m, m, 5), method="bicubic"))
    got = resize(torch.from_numpy(x), m, m, "bicubic").numpy()
    _close(got, want, f"{n}->{m}", rel=1e-6 if n == m else 1e-5)
    if n == m:
        assert np.array_equal(got, x)
    w = resize_weights(n, m, "bicubic")
    assert w.shape == (m, n) and np.allclose(w.sum(axis=1), 1.0, atol=1e-6)
    if m < n:  # antialiased: the widened kernel reaches past Keys' 4 taps
        assert (np.abs(w) > 0).sum(axis=1).max() > 4


@pytest.mark.parametrize("output_size", [None, 7], ids=["native", "output_size"])
def test_convnext_teacher_matches_jax(output_size):
    cfg = dict(TINY_CONVNEXT, output_size=output_size)
    port = TeacherRegistry.build(cfg)
    params = _load(port, 21)
    jteacher = JaxTeacherRegistry.build(dict(cfg))
    u8 = np.random.default_rng(22).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    want = jteacher.apply({"params": params}, jnp.asarray(u8), return_2d=True)
    got = port(torch.from_numpy(u8), return_2d=True)
    assert got.shape == (BATCH, output_size or 2, output_size or 2, 64)
    _close(got, want, "convnext")
    _close(port(torch.from_numpy(u8)), jteacher.apply({"params": params}, jnp.asarray(u8)), "flat")
    assert set(_flat(params_to_flax(port))) == set(_flat(params))
    assert flax_param_paths(port)["backbone.s2b1.dwconv.weight"] == "backbone/s2b1/dwconv/kernel"
    assert port.out_channels == jteacher.out_channels == 64 and port.downsample_factor == 32
    assert torch.equal(port.backbone.s0b0.gamma, torch.from_numpy(params["backbone"]["s0b0"]["gamma"]))


def _convnext_cfg(load):
    cfg = dict(load(CONVNEXT)["trainer"]["algorithm"])
    cfg["optimizer"] = dict(cfg["optimizer"], schedule=dict(cfg["optimizer"]["schedule"], warmup=0))
    model = dict(cfg["model"])
    model["encoder"] = dict(model["encoder"], img_size=SIZE, patch_size=8, out_channels=8, **TINY)
    model["quantizer"] = dict(model["quantizer"], codebook_size=K, embedding_dim=8)
    model["pre_decode"] = dict(model["pre_decode"], out_channels=8)
    model["decoder"] = dict(model["decoder"], img_size=SIZE // 8, in_channels=8, **TINY)
    assert cfg["teacher"] == {"type": "ConvNeXtTeacher", "output_size": 14}
    assert model["decoder"]["out_channels"] == 1024
    model["decoder"]["out_channels"] = 64
    return dict(cfg, model=model, teacher=dict(TINY_CONVNEXT, output_size=SIZE // 8))


def _batch(seed):
    u8 = np.random.default_rng(seed).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    return {"image": (u8.astype(np.float32) / 127.5 - 1.0), "original_image": u8}


def test_vqkd_convnext_two_train_steps_match_jax(monkeypatch):
    jalgo = JaxAlgorithmRegistry.build(_convnext_cfg(jax_load_config))
    algo = AlgorithmRegistry.build(_convnext_cfg(Config.load), device="cpu")
    assert type(algo.teacher).__name__ == "ConvNeXtTeacher"
    params = _load(algo.model, 60)
    state = algo.init_state(0)
    extra = {"teacher_params": _numpy_params(flax_param_shapes(algo.teacher), 61),
             "initialized": np.zeros((), np.bool_)}
    extra_from_flax(algo, state, extra)
    jstate = jax.tree_util.tree_map(jnp.asarray, JaxTrainState.create(
        params=params, opt_state=jalgo.tx(params).init(params), rng=jax.random.PRNGKey(60), extra=extra))
    draws = _lazy_init_draw(jstate.rng, BATCH * (SIZE // 8) ** 2)
    monkeypatch.setattr(cb, "kmeans_init", functools.partial(cb.kmeans_init, draw=_feeder(draws)))
    jstep = jax.jit(jalgo.train_step)
    lr = algo.optimizer_cfg["lr"]
    for i in range(2):
        batch = _batch(62 + i)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for name in jm:
            want = float(jm[name])
            assert abs(float(m[name]) - want) <= REL * max(abs(want), 1e-6), (i, name, float(m[name]), want)
        kept = [n for n, p in algo.model.named_parameters() if p.requires_grad]
        mu = dict(zip(kept, state.opt_state["mu"]))
        got_mu = _flat(params_to_flax(algo.model, {n: mu.get(n, torch.zeros_like(p))
                                                   for n, p in algo.model.named_parameters()}))
        want_mu = _flat(_adam_state(jstate.opt_state).mu)
        if i == 0:  # first-step gradients that are rounding noise, in JAX and then in the port
            top = max(float(np.abs(v).max()) for v in want_mu.values())
            noise = {k: np.abs(v) <= NOISE_REL * top for k, v in want_mu.items()}
            assert all((np.abs(got_mu[k][noise[k]]) <= 10 * NOISE_REL * top).all() for k in noise)
        _close_params(got_mu, want_mu, f"step {i} mu", noise, 2 * 10 * NOISE_REL * top)
    # each of two Adam steps moves a noise element by at most ~lr
    _close_params(_flat(params_to_flax(algo.model)), _flat(jstate.params), "params", noise, 2 * 2 * 1.1 * lr)
    _close(algo.model.quantizer.codebook, jstate.params["quantizer"]["codebook"], "codebook")
    got_extra = extra_to_flax(algo, state)
    assert got_extra["initialized"] and bool(jstate.extra["initialized"])
    for k, v in _flat(jstate.extra["teacher_params"]).items():
        assert np.array_equal(_flat(got_extra["teacher_params"])[k], np.asarray(v)), k
