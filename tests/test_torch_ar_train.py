"""AR training through the port's entry points against the JAX package:
``configs/regression/ar_anchor.py`` -> the config loader -> each package's
``AlgorithmRegistry`` -> ``ARAlgorithm``, the same weights carried over by
``utils/bridge.py``.

- Three train steps from the same params and ``codes`` batches (CFG
  dropout off: the two packages' generators draw different numbers): equal
  losses and parameters.
- The ``image`` path: the frozen tokenizer's codes equal JAX's, near-ties
  aside (``ops/vq_lookup.compare_codes``), and the tokenizer never moves.
- The committed ``iter_800`` anchor checkpoint, restored by the JAX package
  and bridged in: the port's ``eval_step`` on the validator's 32 synthetic
  images gives JAX's loss and the recorded 0.08484
  (``tools/record_published.py``), and an accuracy near the recorded
  0.9707 (the accuracy samples, and the port's generator draws other
  numbers: within 0.05, the record's own check tolerance).
- CFG dropout: the drop rate and the uncondition token.

Tolerances of the train steps: losses within 1e-5 relative (measured:
up to 5.2e-6 at step 3). Parameters after 3 steps within 5e-5 (dense f32
head) and 5e-4 (the fused CE, the anchor's default) relative L2 per leaf
(measured: 9.9e-6 and 1.1e-4). AdamW's update m/(sqrt(v) + eps) is
nearly the sign of the gradient, so a gradient element near 0 turns a
tiny difference into a large share of lr; the fused CE rounds the head's
operands and the logits' cotangent to bf16 in both packages, and values
that differ in the last f32 bits may round one bf16 step apart, so its
gradients agree less closely than the dense head's.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.ar  # noqa: F401  (registers the JAX algorithm)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.ops.distances import normalize
from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.utils.bridge import llama_params_to_flax, load_ar_from_flax
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
ANCHOR = str(REPO / "configs/regression/ar_anchor.py")
ITER_800 = REPO / "work_dirs/published/anchor_ar_train/checkpoints/iter_800"
RECORDED_LOSS, RECORDED_ACCURACY = 0.08484, 0.9707


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _algorithm_cfg(**override):
    cfg = Config.load(ANCHOR)["trainer"]["algorithm"]
    cfg.update(override)
    return cfg


def _pair(**override):
    """(JAX algorithm, its initial state, the port's algorithm with the
    same weights); the lm head is made non-zero so step 1 moves the blocks."""
    jcfg = jax_load_config(ANCHOR)["trainer"]["algorithm"]
    jcfg.update(override)
    jalgo = JaxAlgorithmRegistry.build(jcfg)
    state = jalgo.init_state(jax.random.PRNGKey(0), {})
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    rng = np.random.default_rng(11)
    params["lm_head"] = (rng.standard_normal(params["lm_head"].shape) * 0.05).astype(np.float32)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          opt_state=jalgo.tx(state.params).init(params))
    algo = AlgorithmRegistry.build(_algorithm_cfg(**override), device="cpu")
    ir_params = jax.tree_util.tree_map(np.asarray, state.extra["ir_params"])
    load_ar_from_flax(algo, params, ir_params)
    return jalgo, state, algo


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _codes_batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"codes": rng.integers(0, 64, (b, 8, 8)).astype(np.int32),
             "category": rng.integers(0, 10, b).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("fused_ce,param_tol", [(True, 5e-4), (False, 5e-5)])
def test_train_steps_match_jax(fused_ce, param_tol):
    jalgo, jstate, algo = _pair(cfg=None, fused_ce=fused_ce)
    state = algo.init_state(0)
    step = jax.jit(jalgo.train_step)
    for batch in _codes_batches(3):
        jstate, jmetrics = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = float(jmetrics["loss"])
        assert abs(float(metrics["loss"]) - want) <= 1e-5 * want
    assert state.step == 3 and state.opt_state["count"] == 3
    got = _flat(llama_params_to_flax(algo.model))
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jstate.params)))
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.linalg.norm(got[name] - w) <= param_tol * np.linalg.norm(w), name


def test_image_path_codes_match_jax_and_tokenizer_stays_frozen():
    jalgo, jstate, algo = _pair()
    rng = np.random.default_rng(4)
    image = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    category = rng.integers(0, 10, 8).astype(np.int32)
    jcodes = np.array(jalgo.encode_image_tokens(jstate.extra["ir_params"], jnp.asarray(image)))
    timage = torch.from_numpy(image)
    codes = algo.encode_image_tokens(timage)
    feat = algo.ir_model.encode(timage).reshape(-1, 8)
    rep = compare_codes(normalize(feat), algo.ir_model.quantizer.effective_codebook(),
                        codes.reshape(-1), torch.from_numpy(jcodes).reshape(-1))
    assert rep["ok"], rep
    before = copy.deepcopy(algo.ir_model.state_dict())
    state = algo.init_state(0)
    for _ in range(2):
        state, metrics = algo.train_step(state, {"image": timage, "category": torch.from_numpy(category)})
        assert torch.isfinite(metrics["loss"])
    after = algo.ir_model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not any(p.requires_grad for p in algo.ir_model.parameters())


def _restore_iter_800():
    """The anchor state, restored on one CPU device: the checkpoint was
    saved on an 8-device mesh, so each leaf gets a single-device template."""
    import orbax.checkpoint as ocp
    from jax.sharding import SingleDeviceSharding

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(ITER_800)
    meta = getattr(meta, "item_metadata", meta)
    sharding = SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sharding), meta)
    return ckptr.restore(ITER_800, template)


def test_iter_800_anchor_eval_matches_jax_and_the_record():
    from vector_quantization_tpu.training.runner import build_runner

    restored = _restore_iter_800()
    validator = build_runner(jax_load_config(ANCHOR), "validator")
    jalgo = validator.algorithm
    jstate = JaxTrainState(step=restored["step"], params=restored["params"], opt_state=None,
                           rng=restored["rng"], extra=restored["extra"])
    algo = AlgorithmRegistry.build(Config.load(ANCHOR)["validator"]["algorithm"], device="cpu")
    load_ar_from_flax(algo, jax.tree_util.tree_map(np.asarray, dict(restored["params"])),
                      jax.tree_util.tree_map(np.asarray, restored["extra"]["ir_params"]))
    state = algo.init_state(0)
    gen = torch.Generator().manual_seed(0)
    losses, jlosses, accs = [], [], []
    for batch in validator.dataloader:  # 2 batches of 16 synthetic images
        jmemo = jalgo.eval_step(jstate, {k: jnp.asarray(batch[k]) for k in ("image", "category")})
        memo = algo.eval_step(state, {k: torch.from_numpy(np.asarray(batch[k]))
                                      for k in ("image", "category")}, generator=gen)
        np.testing.assert_array_equal(memo["codes"].numpy(), np.asarray(jmemo["codes"]))
        jlosses.append(float(jmemo["loss"]))
        losses.append(float(memo["loss"]))
        accs.append(float(memo["accuracy"]))
    assert len(losses) == 2
    loss, jloss = float(np.mean(losses)), float(np.mean(jlosses))
    assert abs(loss - jloss) <= 1e-5
    assert abs(loss - RECORDED_LOSS) <= 1e-3
    assert abs(float(np.mean(accs)) - RECORDED_ACCURACY) <= 0.05


def test_cfg_dropout_rate_and_uncondition_token():
    algo = AlgorithmRegistry.build(_algorithm_cfg(), device="cpu")
    state = algo.init_state(3)
    n = 20000
    batch = {"codes": torch.zeros((n, 8, 8), dtype=torch.int32),
             "category": torch.full((n,), 7, dtype=torch.int32)}
    tokens = algo._tokens(state, batch, train=True)
    first = tokens[:, 0]
    assert set(first.unique().tolist()) == {7, algo.uncondition_token}
    assert algo.uncondition_token == 10
    assert abs(float((first == algo.uncondition_token).float().mean()) - 0.1) <= 0.01
    assert torch.equal(algo._tokens(state, batch, train=False)[:, 0], batch["category"])
    # image codes are biased past the condition ids (10 classes + uncondition)
    assert int(tokens[:, 1:].min()) == 11
