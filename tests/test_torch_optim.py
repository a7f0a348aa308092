"""The port's schedules and optimizers against optax (the JAX package's
``training/optim.py`` builds optax chains): schedule values at the
boundary counts, and 5 update steps of adam / adamw / sgd with and without
``grad_clip`` on a toy parameter tree, from the same gradients.

Tolerances: schedules within 1e-6 relative (optax computes in f32, the
port in Python floats); parameters within 1e-5 relative after 5 steps
(f32 arithmetic, bias corrections rounded in another place).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vector_quantization_tpu.training.optim import build_optimizer as jax_build_optimizer
from vector_quantization_tpu.training.optim import build_schedule as jax_build_schedule
from vector_quantization_tpu_torch.training.optim import build_optimizer, build_schedule

_SCHEDULES = [
    dict(type="cosine", warmup=10, total=50),
    dict(type="cosine", warmup=10, total=50, end=1e-5),
    dict(type="linear", warmup=4, total=20, end=2e-4),
    dict(type="constant", warmup=7),
    dict(type="cosine", total=30),
    None,
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cfg", _SCHEDULES)
def test_schedule_matches_optax(cfg):
    lr = 1e-3
    ours, ref = build_schedule(cfg, lr), jax_build_schedule(cfg, lr)
    warmup = (cfg or {}).get("warmup", 0)
    total = (cfg or {}).get("total", 60)
    for count in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, total, total + 5}):
        want = float(ref(count)) if callable(ref) else float(ref)
        assert abs(ours(count) - want) <= 1e-6 * max(abs(want), 1e-12), count
    if warmup:
        assert ours(0) == 0.0  # the first step of a warm-up moves nothing


def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"]]


@pytest.mark.parametrize(
    "cfg",
    [
        dict(type="adamw", lr=1e-2, weight_decay=0.05, grad_clip=1.0),
        dict(type="adamw", lr=1e-2, weight_decay=0.05, grad_clip=1.0,
             schedule=dict(type="cosine", warmup=2, total=5)),
        dict(type="adam", lr=3e-3, betas=(0.5, 0.9), grad_clip=0.5),
        dict(type="adam", lr=3e-3, eps=1e-6),
        dict(type="sgd", lr=1e-2, momentum=0.9, grad_clip=2.0),
        dict(type="sgd", lr=1e-2),
    ],
)
def test_optimizer_matches_optax(cfg):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    for i, g in enumerate(grads):  # alternate large and small steps: clipping on and off
        scale = 3.0 if i % 2 == 0 else 0.05
        grads[i] = {"a": g["a"] * scale, "b": {"c": g["b"]["c"] * scale}}
    tx = jax_build_optimizer(cfg)
    jparams = {"a": jnp.asarray(params["a"]), "b": {"c": jnp.asarray(params["b"]["c"])}}
    state = tx.init(jparams)
    opt = build_optimizer(cfg)
    tparams = [torch.from_numpy(x.copy()) for x in _leaves(params)]
    tstate = opt.init(tparams)
    for g in grads:
        jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, [torch.from_numpy(x.copy()) for x in _leaves(g)], tstate)
    assert tstate["count"] == 5
    for got, want in zip(tparams, _leaves(jparams)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_unported_options_raise():
    # LARS is ported (tests/test_torch_probe.py); its masks, like exclude, need the parameters' names
    assert build_optimizer(dict(type="lars", lr=0.1)).kind == "lars"
    with pytest.raises(ValueError, match="weight_decay_mask needs"):
        build_optimizer(dict(type="lars", lr=0.1, weight_decay_mask="kernel"))
    # exclude is ported (tests/test_torch_vqkd.py); like JAX's, it needs the parameters' names
    with pytest.raises(ValueError, match="exclude mask needs"):
        build_optimizer(dict(type="adamw", lr=0.1, exclude="codebook"))
