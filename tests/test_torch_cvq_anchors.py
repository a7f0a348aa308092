"""CVQ-VAE's anchors (nearest, multinomial, random, cached) in the port
against the JAX package, on the CPU, f32.

The random anchors draw from a ``torch.Generator`` in the port and from a
JAX key in the reference, so the draws themselves cannot agree. Held
instead:
- given the same anchors (JAX's draw), the port's CVQ update equals JAX's
  ``cvq_update`` with that anchor rule within 1e-6 of max|ref|, for each
  rule and for both of ``random``'s and ``cached``'s branches (features
  at least K, and fewer);
- every anchor the port draws is a row of its pool (the features, and
  for ``cached`` the previous anchors), or uniform [0, 1) noise where the
  reference pads, with no row drawn twice where it draws without
  replacement;
- a fixed-seed frequency test: multinomial draws follow ``softmax(d.T)``
  over the raw distances, so the farther feature is the likelier;
- ``anchor_cache``: (K, D) f32 uniform in [0, 1) at init, the step's
  anchors after each step, and through a checkpoint round trip, on
  ``configs/cvqvae/interface.py`` cut to width 32, K 16, D 8.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_quantization_tpu.ops import codebook as jax_cb
from vector_quantization_tpu_torch.ops import codebook as cb
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.training import checkpoints as ckpt
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
CVQ = str(REPO / "configs/cvqvae/interface.py")
K, D = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, rel=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * float(np.abs(want).max(initial=0.0)), (what, err)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    e = rng.standard_normal((K, D)).astype(np.float32)
    p = rng.uniform(0, 0.2, K).astype(np.float32)
    p[:5] = 0.0  # dead codes: they snap to their anchors
    codes = rng.integers(5, K, n).astype(np.int32)
    d = ((x[:, None] - e[None]) ** 2).sum(-1).astype(np.float32)
    cache = rng.uniform(0, 1, (K, D)).astype(np.float32)
    return x, e, p, codes, d, cache


@pytest.mark.parametrize("anchor,n", [("nearest", 40), ("multinomial", 40), ("random", 40), ("random", 10),
                                      ("cached", 40), ("cached", 10), ("cached", 5)])
def test_update_with_the_same_anchors_matches_jax(anchor, n):
    x, e, p, codes, d, cache = _inputs(n, seed=n)
    key = jax.random.PRNGKey(n)
    args = [jnp.asarray(a) for a in (x, d)]
    if anchor == "cached":
        anchors = jax_cb.cached_anchors(*args, key, jnp.asarray(cache))[0]
    else:
        anchors = {"nearest": jax_cb.nearest_anchors, "multinomial": jax_cb.multinomial_anchors,
                   "random": jax_cb.random_anchors}[anchor](*args, key)
    want, wp, wcache = jax_cb.cvq_update(jnp.asarray(e), jnp.asarray(p), jnp.asarray(x), jnp.asarray(d),
                                         jnp.asarray(codes), ema_decay=0.99, anchor=anchor, key=key,
                                         anchor_cache=jnp.asarray(cache) if anchor == "cached" else None)
    got, gp = cb.cvq_update(torch.from_numpy(e), torch.from_numpy(p), torch.from_numpy(x), torch.from_numpy(d),
                            torch.from_numpy(codes), ema_decay=0.99,
                            anchors=torch.from_numpy(np.asarray(anchors)))
    _close(gp, wp, "probability")
    _close(got, want, "codebook")
    if anchor == "cached":
        np.testing.assert_array_equal(np.asarray(wcache), np.asarray(anchors))
    if anchor == "nearest":  # the port's own nearest anchors are JAX's
        np.testing.assert_array_equal(cb.cvq_anchors(torch.from_numpy(x), torch.from_numpy(d)).numpy(),
                                      np.asarray(anchors))


def _rows_of(anchors, pool):
    """Per anchor row, the index of the equal pool row, or -1."""
    eq = (anchors[:, None, :] == pool[None, :, :]).all(-1)
    return np.where(eq.any(1), eq.argmax(1), -1)


@pytest.mark.parametrize("anchor,n", [("multinomial", 40), ("random", 40), ("random", 10),
                                      ("cached", 40), ("cached", 10), ("cached", 5)])
def test_drawn_anchors_are_pool_rows_or_noise(anchor, n):
    x, _, _, _, d, cache = _inputs(n, seed=n + 1)
    gen = torch.Generator().manual_seed(3)
    got = cb.cvq_anchors(torch.from_numpy(x), torch.from_numpy(d), anchor, gen, torch.from_numpy(cache)).numpy()
    assert got.shape == (K, D) and got.dtype == np.float32
    pool = np.concatenate([x, cache]) if anchor == "cached" and n < K else x
    idx = _rows_of(got, pool)
    noise = idx < 0
    assert (got[noise] >= 0).all() and (got[noise] < 1).all()
    if anchor == "multinomial":
        assert not noise.any()
    else:  # without replacement; noise only where the pool is short of K
        assert len(set(idx[~noise])) == int((~noise).sum())
        assert int(noise.sum()) == max(0, K - len(pool))
    if anchor == "random" and n < K:  # the features in order, then the noise
        np.testing.assert_array_equal(got[:n], x)
    again = cb.cvq_anchors(torch.from_numpy(x), torch.from_numpy(d), anchor, torch.Generator().manual_seed(3),
                           torch.from_numpy(cache)).numpy()
    np.testing.assert_array_equal(got, again)


def test_multinomial_draws_follow_softmax_of_the_distance():
    dist = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0], np.float32)
    codes = 20_000
    d = np.repeat(dist[:, None], codes, axis=1)  # (N, K): every code sees the same distances
    x = np.arange(5, dtype=np.float32)[:, None].repeat(D, axis=1)
    got = cb.multinomial_anchors(torch.from_numpy(x), torch.from_numpy(d), torch.Generator().manual_seed(0))
    freq = np.bincount(got[:, 0].numpy().astype(np.int64), minlength=5) / codes
    want = np.exp(dist) / np.exp(dist).sum()
    assert np.abs(freq - want).max() <= 0.015, (freq, want)  # ~4 sigma at 20000 draws
    assert (np.diff(freq) > 0).all()  # the farther feature is the likelier


def _algorithm(anchor="cached"):
    cfg = dict(Config.load(CVQ, anchor=anchor, codebook_size=K, embedding_dim=D)["trainer"]["algorithm"])
    model = dict(cfg["model"])
    model["encoder"] = dict(model["encoder"], width=32, width_mults=(1, 2), depth_mult=1)
    model["decoder"] = dict(model["decoder"], width=32, width_mults=(2, 1), depth_mult=1, attention_layer=None,
                            refine_layer=None)
    return AlgorithmRegistry.build(dict(cfg, model=model), device="cpu")


def _images(seed, b=2):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32))


@pytest.mark.parametrize("anchor", ["nearest", "multinomial", "random", "cached"])
def test_the_four_anchors_train(anchor):
    algo = _algorithm(anchor)
    assert algo.codebook_update["anchor"] == anchor
    state = algo.init_state(0)
    assert ("anchor_cache" in state.extra) == (anchor == "cached")
    before = algo.model.quantizer.codebook.detach().clone()
    state, m = algo.train_step(state, {"image": _images(1)})
    assert all(torch.isfinite(v) for v in m.values())
    assert not torch.equal(before, algo.model.quantizer.codebook)
    assert float(state.extra["probability"].sum()) > 0


def test_anchor_cache_first_value_update_and_checkpoint(tmp_path):
    algo = _algorithm()
    state = algo.init_state(0)
    first = state.extra["anchor_cache"]
    assert first.shape == (K, D) and first.dtype == torch.float32
    assert float(first.min()) >= 0 and float(first.max()) < 1 and float(first.std()) > 0.2
    assert torch.equal(first, _algorithm().init_state(5).extra["anchor_cache"])  # seeded, not drawn from the state
    for step in range(2):
        image = _images(10 + step)
        old = state.extra["anchor_cache"].clone()
        with torch.no_grad():  # the features the step's quantizer sees (before its update)
            feats = algo.model.encode(image).reshape(-1, D).numpy()
        state, _ = algo.train_step(state, {"image": image})
        new = state.extra["anchor_cache"]
        assert new.shape == (K, D) and not torch.equal(new, old)
        # 512 features >= K: the pool is this step's features alone
        idx = _rows_of(new.numpy(), feats)
        assert (idx >= 0).all() and len(set(idx)) == K
    path = ckpt.save_checkpoint(str(tmp_path), algo, state, 2)
    saved = state.extra["anchor_cache"].clone()
    fresh = _algorithm()
    restored = ckpt.restore_checkpoint(path, fresh, fresh.init_state(0))
    assert torch.equal(restored.extra["anchor_cache"], saved)
    assert torch.equal(restored.extra["probability"], state.extra["probability"])
