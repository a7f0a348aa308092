"""The port's Llama training forward against the JAX model: the same flax
weights (through utils/bridge.py, with a non-zero lm head so gradients
reach the blocks), the same tokens; logits, the fused-CE loss and every
parameter's gradient, with the einsum attention and with the flash
attention (JAX's Pallas kernel in interpret mode), f32.

Tolerances: logits within 1e-5 of max|ref| (f32 in another order); the
fused loss within 1e-5 relative; gradients within 1e-4 of each leaf's
max|ref| (measured: under 8e-6): the fused CE rounds the hidden states
and the logits' cotangent to bf16 in both packages, from f32 values that
differ in the last bits, so single elements may sit one bf16 step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vector_quantization_tpu.models.transformers.llama import LlamaTransformer as JaxLlama
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax, llama_params_to_flax

TINY = dict(vocabulary_size=75, hidden_size=64, num_layers=2, num_heads=2, ffn_dim=128,
            max_length=17)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params():
    params = JaxLlama(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.default_rng(5)
    params["lm_head"] = (rng.standard_normal(params["lm_head"].shape) * 0.1).astype(np.float32)
    return params


def _tokens(b=3, t=17, seed=2):
    return np.random.default_rng(seed).integers(0, TINY["vocabulary_size"], (b, t)).astype(np.int32)


def _port(params, **kw):
    model = LlamaTransformer(**TINY, **kw)
    model.load_state_dict(llama_params_from_flax(params))
    return model


def _port_loss_and_grads(model, tokens):
    loss = model(torch.from_numpy(tokens), fused_ce_targets=torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    named = {n: g for (n, _), g in zip(model.named_parameters(), grads)}
    return float(loss.detach()), named


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("flash", [False, True])
def test_training_forward_matches_jax(flash):
    params, tokens = _params(), _tokens()
    jt = JaxLlama(**TINY, flash=flash)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    # jitted: dispatched op by op, the interpret mode's callbacks run JAX ops
    # of their own while the main thread dispatches the next op, and under
    # a loaded CPU the two deadlock
    with pltpu.force_tpu_interpret_mode():
        jlogits = jax.jit(lambda p: jt.apply({"params": p}, jnp.asarray(tokens)))(jparams)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jt.apply({"params": p}, jnp.asarray(tokens), fused_ce_targets=jnp.asarray(tokens))
        ))(jparams)
    model = _port(params, flash=flash)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and logits.shape == (3, 17, TINY["vocabulary_size"])
    assert _rel(logits, jlogits) <= 1e-5
    loss, grads = _port_loss_and_grads(model, tokens)
    assert abs(loss - float(jloss)) <= 1e-5 * float(jloss)
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jgrads)))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name  # the non-zero head reaches every block
        assert _rel(g, want[name]) <= 1e-4, name


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("flash", [False, True])
def test_remat_changes_nothing(flash, policy):
    """Full remat and ``remat_policy="dots"`` (the projections' products
    kept, the rest re-run) give the loss and gradients of no remat, bit for
    bit; under "dots" the backward re-runs no ``aten.mm`` (it does exactly
    no remat's products), under full remat it re-runs the blocks' own."""
    params, tokens = _params(), _tokens(seed=4)
    loss0, g0 = _port_loss_and_grads(_port(params, flash=flash), tokens)
    loss1, g1 = _port_loss_and_grads(_port(params, flash=flash, remat=True, remat_policy=policy), tokens)
    assert loss0 == loss1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    mms = [_backward_mms(_port(params, flash=flash, remat=remat, remat_policy=policy), tokens)
           for remat in (False, True)]
    assert (mms[1] == mms[0]) == (policy == "dots") and mms[1] >= mms[0]


def _backward_mms(model, tokens):
    """``aten.mm`` calls in the backward of the fused loss."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    t = torch.from_numpy(tokens)
    loss = model(t, fused_ce_targets=t)
    with Count():
        torch.autograd.grad(loss, list(model.parameters()))
    return Count.n


def test_remat_dots_matches_jax():
    """The loss and every gradient under ``remat_policy="dots"`` against the
    JAX model's (``nn.remat`` with ``dots_with_no_batch_dims_saveable``),
    einsum attention: JAX's remat cannot trace the Pallas kernel's
    interpret mode (its callbacks carry effects). The port's flash path
    under "dots" equals its full remat, which is held to JAX's above."""
    params, tokens = _params(), _tokens(seed=6)
    jt = JaxLlama(**TINY, remat=True, remat_policy="dots")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.apply({"params": p}, jnp.asarray(tokens), fused_ce_targets=jnp.asarray(tokens))
    ))(jax.tree_util.tree_map(jnp.asarray, params))
    loss, grads = _port_loss_and_grads(_port(params, remat=True, remat_policy="dots"), tokens)
    assert abs(loss - float(jloss)) <= 1e-5 * float(jloss)
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jgrads)))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g, want[name]) <= 1e-4, name


def test_bridge_round_trip_and_unported_options():
    params = _params()
    back = _flat(llama_params_to_flax(_port(params)))
    for name, value in _flat(params).items():
        np.testing.assert_array_equal(back[name], value)
    with pytest.raises(ValueError, match="remat_policy"):
        _port(params, remat=True, remat_policy="everything")
