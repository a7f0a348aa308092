"""FSQ and SQ through the port against the JAX package, on the CPU, f32.

- ``FSQCodec`` at levels (8, 8, 5, 5, 5) and (8, 8, 8, 5, 5, 5): codes
  equal except where a pre-round value lies within 1e-6 of a half-integer
  (those counted, under 0.1% of the rows); ``z`` within 1e-6; the lattice
  (``embeddings()``) and ``decode`` equal; the STE gradients within 1e-6.
- Two ``ReconstructionAlgorithm.train_step``s on ``configs/fsq/
  8000_imagenet_ddp.py`` cut to the smoke anchor's widths (VQGAN width 32,
  ``width_mults`` (1, 2), 16 channels around the connectors) at 32 px,
  held as ``tests/test_torch_vqgan_train.py`` holds the reconstruction
  steps: metrics within 1e-4, the weights within 1e-4 of max|ref| apart
  from the rounding-noise elements Adam moves by a full step.
- The quantizer launches no lookup; ``configs/sq/interface.py`` builds a
  ``ScalarQuantizer``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.base  # noqa: F401  (registers the JAX algorithms)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.ops.fsq import FSQCodec as JaxFSQCodec
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.ops import vq_lookup
from vector_quantization_tpu_torch.ops.fsq import FSQCodec
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, ModelRegistry
from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes, params_to_flax, state_dict_from_flax
from vector_quantization_tpu_torch.utils.config import Config
from test_torch_vqgan_train import (  # noqa: E402
    NOISE_REL,
    REL,
    _adam_moments,
    _close_trees,
    _mu_tree,
    _noise,
    _numpy_params,
    _synthetic_batches,
)

REPO = Path(__file__).resolve().parents[1]
FSQ = str(REPO / "configs/fsq/8000_imagenet_ddp.py")
SQ = str(REPO / "configs/sq/interface.py")
LEVELS = [(8, 8, 5, 5, 5), (8, 8, 8, 5, 5, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed, n, c):
    return (np.random.default_rng(seed).standard_normal((n, c)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("levels", LEVELS, ids=["8000", "64000"])
def test_codec_matches_jax(levels):
    n = 8192
    x = _x(0, n, len(levels))
    jc, pc = JaxFSQCodec(levels), FSQCodec(levels)
    wcodes, wz = (np.asarray(a) for a in jc.encode(jnp.asarray(x)))
    codes, z = pc.encode(torch.from_numpy(x))
    assert codes.dtype == torch.int32 and codes.shape == (n,)
    bound = np.asarray(jc.bound(jnp.asarray(x)), np.float64)
    near_half = (np.abs(np.abs(bound - np.floor(bound)) - 0.5) <= 1e-6).any(axis=1)
    differ = codes.numpy() != wcodes
    assert not (differ & ~near_half).any()
    assert near_half.sum() <= 1e-3 * n, int(near_half.sum())
    rows = ~near_half
    assert float(np.abs(z.numpy() - wz)[rows].max()) <= 1e-6
    assert int(codes.min()) >= 0 and int(codes.max()) < pc.codebook_size == jc.codebook_size
    np.testing.assert_array_equal(pc.embeddings().numpy(), np.asarray(jc.embeddings()))
    np.testing.assert_array_equal(pc.decode(codes).numpy()[rows], np.asarray(jc.decode(jnp.asarray(wcodes)))[rows])
    np.testing.assert_array_equal(pc.to_decimal(pc.from_decimal(codes)).numpy(), codes.numpy())


def test_round_half_to_even_and_ste_gradients_match_jax():
    levels = LEVELS[0]
    np.testing.assert_array_equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).numpy(),
                                  np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5, -0.5]))))
    x = _x(1, 512, len(levels))
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JaxFSQCodec(levels).encode(a)[1] * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (FSQCodec(levels).encode(t)[1] * torch.from_numpy(w)).sum().backward()
    assert float(np.abs(t.grad.numpy() - np.asarray(want)).max()) <= 1e-6 * float(np.abs(want).max())


def _fsq_cfg(load):
    cfg = dict(load(FSQ)["trainer"]["algorithm"])
    model = dict(cfg["model"])
    model["encoder"] = dict(model["encoder"], width=32, width_mults=(1, 2), depth_mult=1, out_channels=16)
    model["pre_decode"] = dict(model["pre_decode"], out_channels=16)
    model["decoder"] = dict(model["decoder"], width=32, width_mults=(2, 1), depth_mult=1, in_channels=16,
                            attention_layer=None, refine_layer=None)
    return dict(cfg, model=model)


def test_fsq_reconstruction_train_steps_match_jax(monkeypatch):
    jalgo = JaxAlgorithmRegistry.build(_fsq_cfg(jax_load_config))
    algo = AlgorithmRegistry.build(_fsq_cfg(Config.load), device="cpu")
    q = algo.model.quantizer
    assert type(q).__name__ == "FiniteScalarQuantizer" and q.embedding_dim == 5 and q.codebook_size == 8000
    assert not list(q.parameters())
    g = _numpy_params(flax_param_shapes(algo.model), 5)
    algo.model.load_state_dict(state_dict_from_flax(algo.model, g))
    state = algo.init_state(0)
    jstate = jax.tree_util.tree_map(jnp.asarray, JaxTrainState.create(
        params=g, opt_state=jalgo.tx(g).init(g), rng=jax.random.PRNGKey(0), extra={}))
    jstep = jax.jit(jalgo.train_step)
    lookups = []
    monkeypatch.setattr(vq_lookup, "_launch", lambda *a: lookups.append(a) or None)
    for i, image in enumerate(_synthetic_batches(2)):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(image)})
        state, m = algo.train_step(state, {"image": torch.from_numpy(image)})
        assert set(m) == set(jm) == {"loss", "loss_quantizer", "loss_l1", "loss_mse"}
        assert float(m["loss_quantizer"]) == 0.0
        for name in jm:
            assert abs(float(m[name]) - float(jm[name])) <= REL * max(abs(float(jm[name])), 1e-6), (i, name)
        if i == 0:
            noise, top = _noise(_adam_moments(jstate.opt_state)[0])
    assert not lookups  # no nearest-code lookup, on any device
    assert state.extra == {}
    step_tol = 2 * 2 * 1.1 * algo.optimizer_cfg["lr"]
    _close_trees(params_to_flax(algo.model), jstate.params, "params", noise, step_tol)
    jmu, _ = _adam_moments(jstate.opt_state)
    _close_trees(_mu_tree(algo.model, state.opt_state), jmu, "mu", noise, 2 * 10 * NOISE_REL * top)
    image = torch.from_numpy(_synthetic_batches(1)[0])
    codes = algo.model.encode_to_quant(image)
    assert codes.dtype == torch.int32 and int(codes.max()) < 8000 and int(codes.min()) >= 0 and not lookups
    with torch.no_grad():
        z = algo.model(image)["quantizer"].z
        assert torch.equal(algo.model.decode_from_quant(codes), algo.model.decode(z))


def test_sq_interface_builds_a_scalar_quantizer():
    cfg = Config.load(SQ)["trainer"]["algorithm"]
    with torch.device("meta"):
        model = ModelRegistry.build(cfg["model"], device="meta")
    q = model.quantizer
    assert type(q).__name__ == "ScalarQuantizer" and q.levels == (8, 8, 5, 5, 5) and q.codebook_size == 8000
    assert model.post_encode.conv.out_channels == 5 and model.pre_decode.conv.in_channels == 5
