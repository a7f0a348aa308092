"""The port's ``generate`` and the ``ARAlgorithm`` generation steps against
the JAX package, and the ``iter_800`` decode anchor.

- Greedy ``generate`` (top-k 1, and temperature 1e-4) on the same bridged
  weights equals JAX's token for token, with and without CFG, with
  ``kv_segment`` None and 4.
- Sampled ``generate`` (top-k/top-p at temperature 1) gives the same codes
  for every ``kv_segment``: one draw per token, in order.
- The committed ``iter_800`` anchor checkpoint, restored by the JAX package
  and bridged in, decoded greedily with CFG as
  ``tools/record_published.py`` does: ``decode_hash`` 134239 and
  ``decode_mean`` 32.2265625 (``BASELINE.json["published"]
  ["self_trained_ar"]``), exactly.
- ``generate_step``, ``half_generate_step`` and ``eval_step`` with
  ``eval_generate`` on the anchor's weights under greedy sampling: the same
  codes as JAX's, and images of the right shape.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.ar  # noqa: F401  (registers the JAX algorithm)
import vector_quantization_tpu.models  # noqa: F401
from vector_quantization_tpu.models.transformers.llama import LlamaTransformer as JaxLlama
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.tasks.sequence_modeling import TokenCodebook as JaxCodebook
from vector_quantization_tpu.tasks.sequence_modeling import generate as jax_generate
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook, generate
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax, load_ar_from_flax
from vector_quantization_tpu_torch.utils.config import Config
from tests.test_torch_ar_train import ANCHOR, _restore_iter_800

TINY = dict(
    vocabulary_size=32, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64, max_length=16
)
DECODE_HASH, DECODE_MEAN = 134239, 32.2265625


def _tiny_pair():
    jt = JaxLlama(**TINY)
    params = jt.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    params["lm_head"] = (
        np.random.default_rng(9).standard_normal(params["lm_head"].shape) * 0.5
    ).astype(np.float32)
    tt = LlamaTransformer(**TINY)
    tt.load_state_dict(llama_params_from_flax(params))
    return jt, jax.tree_util.tree_map(jnp.asarray, params), tt.eval()


@pytest.mark.parametrize(
    "cfg_alpha,kv_segment,sampler",
    [
        (None, None, {"top_k": 1}),
        (1.75, 4, {"top_k": 1}),
        (None, 4, {"temperature": 1e-4}),
        (1.75, None, {"temperature": 1e-4}),
    ],
)
def test_greedy_generate_matches_jax(cfg_alpha, kv_segment, sampler):
    jt, params, tt = _tiny_pair()
    prefix = np.asarray([[10, 4], [10, 6], [3, 4], [5, 6]], np.int32)
    if cfg_alpha is not None:
        prefix[:2, 0] = 10  # [uncond; cond] halves
    want = jax_generate(jt, params, jnp.asarray(prefix), 12, JaxCodebook(11, 16),
                        jax.random.PRNGKey(1), sampler=sampler, cfg_alpha=cfg_alpha,
                        cache_dtype=jnp.float32, kv_segment=kv_segment)
    got = generate(tt, torch.from_numpy(prefix), 12, TokenCodebook(11, 16),
                   torch.Generator().manual_seed(1), sampler=sampler, cfg_alpha=cfg_alpha,
                   cache_dtype=torch.float32, kv_segment=kv_segment)
    assert got.dtype == torch.int32
    assert got.shape == (4 if cfg_alpha is None else 2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_kv_segment_does_not_change_the_sampled_stream(cache_dtype):
    _, _, tt = _tiny_pair()
    prefix = torch.tensor([[10], [10], [3], [5]], dtype=torch.int32)
    outs = [
        generate(tt, prefix, 13, TokenCodebook(11, 16), torch.Generator().manual_seed(7),
                 sampler={"temperature": 1.0, "top_k": 8, "top_p": 0.9}, cfg_alpha=1.75,
                 cache_dtype=cache_dtype, kv_segment=seg)
        for seg in (None, 1, 4, 5, 32)
    ]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < 16
    with pytest.raises(ValueError, match="max_length"):
        generate(tt, prefix, 16, TokenCodebook(11, 16), torch.Generator())


@pytest.fixture(scope="module")
def anchor():
    """The restored ``iter_800`` state: (JAX algorithm built with
    ``eval_generate``, its state, the port's algorithm with the same
    weights), both sampling greedily."""
    restored = _restore_iter_800()
    jcfg = jax_load_config(ANCHOR)["trainer"]["algorithm"]
    jcfg["eval_generate"] = True
    jalgo = JaxAlgorithmRegistry.build(jcfg)
    jstate = JaxTrainState(step=restored["step"], params=restored["params"], opt_state=None,
                           rng=restored["rng"], extra=restored["extra"])
    cfg = Config.load(ANCHOR)["trainer"]["algorithm"]
    cfg["eval_generate"] = True
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    load_ar_from_flax(algo, jax.tree_util.tree_map(np.asarray, dict(restored["params"])),
                      jax.tree_util.tree_map(np.asarray, restored["extra"]["ir_params"]))
    jalgo.sampler = algo.sampler = {"temperature": 1.0, "top_k": 1}
    return jalgo, jstate, algo


def test_iter_800_anchor_decode_hash(anchor):
    # tools/record_published.py's greedy CFG decode of classes 0-3
    _, _, algo = anchor
    cond = torch.arange(4, dtype=torch.int32)
    cond = torch.cat([torch.full_like(cond, algo.uncondition_token), cond])
    codes = generate(algo.model, cond[:, None], algo.image_hw * algo.image_hw,
                     algo.image_codebook, torch.Generator().manual_seed(1234),
                     sampler={"temperature": 1.0, "top_k": 1}, cfg_alpha=algo.cfg_alpha)
    arr = codes.numpy().astype(np.int32)
    assert arr.shape == (4, 64)
    assert zlib.crc32(arr.tobytes()) % 10**6 == DECODE_HASH
    assert float(arr.mean()) == DECODE_MEAN


def _recording(decode, seen):
    def wrapped(*args):
        seen.append(np.asarray(args[-1]))
        return decode(*args)
    return wrapped


def test_generation_steps_match_jax(anchor):
    jalgo, jstate, algo = anchor
    state = algo.init_state(0)
    jseen, seen = [], []
    jalgo.decode_image_tokens = _recording(type(jalgo).decode_image_tokens.__get__(jalgo), jseen)
    algo.decode_image_tokens = _recording(type(algo).decode_image_tokens.__get__(algo), seen)
    rng = np.random.default_rng(2)
    batch = {"codes": rng.integers(0, 64, (3, 8, 8)).astype(np.int32),
             "category": np.asarray([1, 4, 9], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    # eval_step with eval_generate runs generate_step on the batch's classes
    jmemo = jalgo.eval_step(jstate, jbatch)
    memo = algo.eval_step(state, tbatch, generator=gen)
    jimages = [jmemo["generated_image"],
               jalgo.half_generate_step(jstate, jbatch, jax.random.PRNGKey(1))]
    images = [memo["generated_image"], algo.half_generate_step(state, tbatch, gen)]
    assert len(seen) == len(jseen) == 2
    for got, want in zip(seen, jseen):
        assert got.shape == (3, 8, 8)
        np.testing.assert_array_equal(got, want)
    # the front half of half_generate_step is the batch's own
    np.testing.assert_array_equal(seen[1].reshape(3, 64)[:, :32], batch["codes"].reshape(3, 64)[:, :32])
    for img, jimg in zip(images, jimages):
        assert img.shape == (3, 32, 32, 3) and bool(torch.isfinite(img).all())
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4, rtol=1e-4)
    assert abs(float(memo["loss"]) - float(jmemo["loss"])) <= 1e-5
