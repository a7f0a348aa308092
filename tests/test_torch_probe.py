"""The linear probe and LARS in the port on the CPU, held against the JAX
package.

- LARS (``training/optim.py``) against ``optax.lars`` (through the JAX
  package's ``build_optimizer``) over 5 steps on a probe head's tree whose
  biases start at zero: the defaults, ``weight_decay`` with a mask, a
  cosine schedule, ``nesterov``, and ``exclude``; 1e-6 relative.
- The head's BatchNorm (``models/layers.BatchNorm`` over (B, C)) against
  flax's ``nn.BatchNorm``: outputs and running statistics (the biased
  variance, momentum 0.99) over three train calls, then eval.
- Two ``ClassificationAlgorithm`` steps on the tiny IR of
  ``test_misc_algorithms.py`` at 32 px from the same IR and head params:
  loss 1e-5 relative, head params and BN statistics 1e-5 of max|ref|, the
  IR unchanged, the codes equal to JAX's but near-ties (``compare_codes``);
  then ``eval_step``'s loss and accuracy.
- ``load_ir_from`` through a port checkpoint, and
  ``configs/ic/imagenet_ddp.py`` built at full width on the meta device.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vector_quantization_tpu.algorithms.classification import ClassificationAlgorithm as JaxProbe
from vector_quantization_tpu.training.optim import build_optimizer as jax_build_optimizer
from vector_quantization_tpu_torch.algorithms.base import ReconstructionAlgorithm
from vector_quantization_tpu_torch.models.layers import BatchNorm
from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.training import checkpoints as ckpt
from vector_quantization_tpu_torch.training.optim import build_optimizer
from vector_quantization_tpu_torch.utils.bridge import (
    batch_stats_to_flax,
    extra_from_flax,
    extra_to_flax,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import Config
from test_misc_algorithms import IR_CFG  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (see ``test_torch_runner.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _head_tree(seed):
    rng = np.random.default_rng(seed)
    return {"BatchNorm_0": {"bias": np.zeros(8, np.float32), "scale": np.ones(8, np.float32)},
            "Dense_0": {"bias": np.zeros(10, np.float32),
                        "kernel": rng.standard_normal((8, 10)).astype(np.float32) / np.sqrt(8)}}


def _leaves(tree):
    """(flax path, leaf) in ``tree_flatten``'s order."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(k.key for k in path), v) for path, v in flat]


LARS_CASES = {
    "defaults": ({"type": "lars", "lr": 0.1}, {}),
    "weight_decay_mask": ({"type": "lars", "lr": 0.1, "weight_decay": 1e-2,
                           "weight_decay_mask": {"suffixes": ["kernel"]}},
                          {"weight_decay_mask": {"BatchNorm_0": {"bias": False, "scale": False},
                                                 "Dense_0": {"bias": False, "kernel": True}}}),
    "cosine": ({"type": "lars", "lr": 0.1, "schedule": {"type": "cosine", "warmup": 1, "total": 5}}, {}),
    "nesterov": ({"type": "lars", "lr": 0.1, "nesterov": True, "momentum": 0.8}, {}),
    "exclude": ({"type": "lars", "lr": 0.1, "exclude": "BatchNorm_0"}, {}),
}


@pytest.mark.parametrize("case", list(LARS_CASES))
def test_lars_matches_optax(case):
    cfg, jax_only = LARS_CASES[case]
    tree = _head_tree(0)
    tx = jax_build_optimizer({**cfg, **jax_only}, tree)
    jparams, opt_state = jax.tree_util.tree_map(jnp.asarray, tree), None
    opt_state = tx.init(jparams)
    leaves = _leaves(tree)
    opt = build_optimizer(cfg, [p for p, _ in leaves])
    params = [torch.from_numpy(v.copy()) for _, v in leaves]
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for step in range(5):
        grads = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32), tree)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.step(params, opt.trained([torch.from_numpy(g.copy()) for _, g in _leaves(grads)]), state)
        for (path, want), got in zip(_leaves(jparams), params):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (case, step, path, err)
    if case == "exclude":
        assert all(torch.equal(params[i], torch.from_numpy(v)) for i, (p, v) in enumerate(leaves)
                   if p.startswith("BatchNorm_0"))


def test_head_batchnorm_matches_flax():
    rng = np.random.default_rng(2)
    bn, ref = BatchNorm(8), fnn.BatchNorm(use_running_average=False)
    x0 = rng.standard_normal((16, 8)).astype(np.float32)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    stats = variables["batch_stats"]
    for i in range(3):
        x = (rng.standard_normal((16, 8)) * (i + 1) + i).astype(np.float32)
        want, upd = ref.apply({**variables, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = bn(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-7)
    want = fnn.BatchNorm(use_running_average=True).apply({**variables, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(bn(torch.from_numpy(x), train=False).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32),
            "category": (np.arange(n) % 10).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_probe():
    """The JAX probe and its initial state (immutable: shared by the tests)."""
    jalgo = JaxProbe(ir=IR_CFG, num_categories=10, image_size=32, optimizer={"type": "lars", "lr": 0.1})
    batch = jax.tree_util.tree_map(jnp.asarray, _batch(0))
    return jalgo, jax.jit(jalgo.init_state)(jax.random.PRNGKey(0), batch)


def _pair():
    """The JAX probe's initial state, and the port's algorithm and state
    holding the same IR and head weights."""
    jalgo, jstate = _jax_probe()
    algo = AlgorithmRegistry.build(dict(type="ClassificationAlgorithm", ir=IR_CFG, num_categories=10,
                                        image_size=32), device="cpu")
    algo.model.load_state_dict(state_dict_from_flax(algo.model, jstate.params, jstate.extra["bn_stats"]))
    state = algo.init_state(0)
    extra_from_flax(algo, state, jax.tree_util.tree_map(np.asarray, dict(jstate.extra)))
    return jalgo, jstate, algo, state


def _close(got, want, tol, what):
    for path, w in _leaves(want):
        g = dict(_leaves(got))[path]
        w = np.asarray(w)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), (what, path)


def test_two_probe_steps_match_jax():
    jalgo, jstate, algo, state = _pair()
    ir_before = {k: v.clone() for k, v in algo.ir_model.state_dict().items()}
    jax_step = jax.jit(jalgo.train_step)
    for seed in (1, 2):
        batch = _batch(seed)
        jstate, jm = jax_step(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), (seed, float(m["loss"]), want)
    _close(params_to_flax(algo.model), jstate.params, 1e-5, "head params")
    extra = extra_to_flax(algo, state)
    _close(extra["bn_stats"], jstate.extra["bn_stats"], 1e-5, "bn stats")
    _close(extra["ir_params"], jstate.extra["ir_params"], 0.0, "ir params")
    assert all(torch.equal(v, ir_before[k]) for k, v in algo.ir_model.state_dict().items())
    image = _batch(3)["image"]
    want = jax.jit(lambda p, x: jalgo.ir_model.apply({"params": p}, x, method=jalgo.ir_model.encode_to_quant))(
        jstate.extra["ir_params"], jnp.asarray(image))
    with torch.no_grad():
        x = torch.from_numpy(image)
        got = algo.ir_model.encode_to_quant(x)
        feat = algo.ir_model.encode(x).reshape(-1, algo.ir_model.quantizer.embedding_dim)
    rep = compare_codes(feat, algo.ir_model.quantizer.codebook, got, torch.from_numpy(np.array(want)))
    assert rep["ok"], rep
    jmemo = jax.jit(jalgo.eval_step)(jstate, jax.tree_util.tree_map(jnp.asarray, _batch(4)))
    memo = algo.eval_step(state, {k: torch.from_numpy(v) for k, v in _batch(4).items()})
    assert abs(float(memo["loss"]) - float(jmemo["loss"])) <= 1e-5 * abs(float(jmemo["loss"]))
    assert float(memo["accuracy"]) == float(jmemo["accuracy"])


def test_load_ir_from_a_port_checkpoint(tmp_path):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        recon = ReconstructionAlgorithm(model=IR_CFG, device="cpu")
    rstate = recon.init_state(0)
    ckpt.save_checkpoint(str(tmp_path), recon, rstate, 1)
    _, _, algo, state = _pair()
    assert not torch.equal(algo.ir_model.quantizer.codebook, recon.model.quantizer.codebook)
    state = algo.load_ir_from(state, ckpt.checkpoint_path(str(tmp_path), 1))
    for (name, got), want in zip(algo.ir_model.state_dict().items(), recon.model.state_dict().values()):
        assert torch.equal(got, want), name
    assert state.extra["ir_params"]["quantizer.codebook"] is algo.ir_model.quantizer.codebook


def test_probe_state_round_trips_a_checkpoint(tmp_path):
    _, _, algo, state = _pair()
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    state, _ = algo.train_step(state, batch)
    path = ckpt.save_checkpoint(str(tmp_path), algo, state, 1)
    _, _, other, restored = _pair()
    ckpt.restore_checkpoint(path, other, restored)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for a, b in zip(state.opt_state["trace"], restored.opt_state["trace"]):
        assert torch.equal(a, b)
    for key, value in batch_stats_to_flax(algo.model)["BatchNorm_0"].items():
        np.testing.assert_array_equal(value, batch_stats_to_flax(other.model)["BatchNorm_0"][key])


def test_imagenet_probe_config_builds_on_meta():
    cfg = Config.load(str(REPO / "configs/ic/imagenet_ddp.py"))["trainer"]["algorithm"]
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(cfg, device="meta")
    head = algo.model.Dense_0
    assert (head.in_features, head.out_features) == (256, 1000)
    assert tuple(algo.ir_model.quantizer.codebook.shape) == (8192, 256)
    assert algo.tx().kind == "lars" and not any(p.requires_grad for p in algo.ir_model.parameters())
