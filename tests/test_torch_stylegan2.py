"""upfirdn2d and the StyleGAN2 discriminator through the port against the
JAX package, on the CPU, f32.

- ``upfirdn2d`` within 1e-6 of max|ref| at up 2, down 2, negative and
  mixed pads, with a separable kernel that is not symmetric (the JAX
  function's two-pass path) and with a kernel that is not separable (its
  depthwise-conv path): true convolution, so a flipped kernel would fail;
- ``fused_bias_leaky_relu``;
- the discriminator (32 px, ``channel_multiplier`` 1/32: 16 channels,
  batch 4, so the minibatch std takes 4 groups) within 1e-4 of max|ref|:
  its logits and the gradients of a loss on them with respect to every
  parameter and to the image;
- two ``VQGANAlgorithm.train_step``s on the smoke anchor with this
  discriminator and R1 on, through ``tests/test_torch_vqgan_train.py``'s
  own two-step check (every metric, both models' weights and Adam moments,
  the empty ``d_batch_stats``), the discriminator's kernels drawn N(0, 1)
  as the reference draws them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_vqgan_train as vt
from vector_quantization_tpu.models.discriminators.stylegan2 import StyleGAN2Discriminator as JaxStyleGAN2
from vector_quantization_tpu.ops import upfirdn as jax_upfirdn
from vector_quantization_tpu_torch.models.discriminators.stylegan2 import StyleGAN2Discriminator
from vector_quantization_tpu_torch.ops import upfirdn
from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes, params_to_flax, state_dict_from_flax

DISC = dict(type="StyleGAN2Discriminator", image_size=32, channel_multiplier=1 / 32)
_numpy_params = vt._numpy_params


def _params(shapes, seed):
    """``tests/test_torch_vqgan_train.py``'s weights, but for a StyleGAN2
    tree every ``kernel`` N(0, 1), as the reference draws it: its
    equalised learning rate divides by √fan_in at use (the file's
    N(0, 2/fan_in) would be divided twice and leave no gradient to hold)."""
    params = _numpy_params(shapes, seed)
    if "from_rgb" not in shapes:
        return params
    rng = np.random.default_rng(seed + 1000)

    def redraw(tree):
        return {k: redraw(v) if isinstance(v, dict) else
                rng.standard_normal(v.shape).astype(np.float32) if k == "kernel" else v for k, v in tree.items()}

    return redraw(params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEPARABLE = np.outer([1.0, 2.0, 4.0], [1.0, 3.0, 0.5, -1.0]).astype(np.float32)  # 3x4, not symmetric
DENSE = np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32)  # not separable


@pytest.mark.parametrize("kernel", [SEPARABLE, DENSE, upfirdn.blur_kernel_2d()],
                         ids=["separable", "dense", "blur"])
@pytest.mark.parametrize("up,down,pad", [(2, 1, (1, 2)), (1, 2, (2, 1)), (1, 1, (-1, 2)), (2, 2, (3, -2, -1, 1))],
                         ids=["up2", "down2", "negative_pad", "mixed"])
def test_upfirdn2d_matches_jax(kernel, up, down, pad):
    x = np.random.default_rng(1).standard_normal((2, 9, 8, 3)).astype(np.float32)
    want = np.asarray(jax_upfirdn.upfirdn2d(jnp.asarray(x), kernel, up=up, down=down, pad=pad))
    got = upfirdn.upfirdn2d(torch.from_numpy(x), kernel, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if kernel is SEPARABLE and up == 1 and down == 1:  # a correlation would not agree
        flipped = upfirdn.upfirdn2d(torch.from_numpy(x), kernel[::-1, ::-1].copy(), pad=pad).numpy()
        assert np.abs(flipped - want).max() > 1e-2 * np.abs(want).max()


def test_blur_kernel_and_fused_bias_leaky_relu_match_jax():
    np.testing.assert_array_equal(upfirdn.blur_kernel_2d(), jax_upfirdn.blur_kernel_2d())
    x = np.random.default_rng(2).standard_normal((2, 3, 5)).astype(np.float32)
    b = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    want = np.asarray(jax_upfirdn.fused_bias_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    got = upfirdn.fused_bias_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_discriminator_logits_and_gradients_match_jax():
    cfg = {k: v for k, v in DISC.items() if k != "type"}
    port = StyleGAN2Discriminator(**cfg)
    assert not list(port.buffers())
    params = _params(flax_param_shapes(port), 4)
    port.load_state_dict(state_dict_from_flax(port, params))
    jd = JaxStyleGAN2(**cfg)
    image = vt._images(5)
    w = np.random.default_rng(6).standard_normal((vt.BATCH, 1)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jd.apply({"params": p}, x, train=True) * w)

    want = jd.apply({"params": params}, jnp.asarray(image))
    timage = torch.from_numpy(image).requires_grad_(True)
    got = port(timage, train=True)
    assert got.shape == (vt.BATCH, 1)
    vt._close(got, want, "logits")
    jgrads, jimage_grad = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(image))
    (got * torch.from_numpy(w)).sum().backward()
    vt._close(timage.grad, jimage_grad, "image gradient")
    grads = params_to_flax(port, {n: p.grad for n, p in port.named_parameters()})
    vt._close_trees(grads, jgrads, "gradients")
    assert set(vt._flat(params_to_flax(port))) == set(vt._flat(params))


def test_vqgan_two_train_steps_with_stylegan2_and_r1_match_jax(monkeypatch):
    override = dict(discriminator=DISC, r1_weight=10.0, recon_losses=dict(l1=dict(), mse=dict()))
    monkeypatch.setitem(vt.CASES, "stylegan2_r1", (override, 0))
    monkeypatch.setattr(vt, "_numpy_params", _params)
    vt.test_vqgan_two_train_steps_match_jax("stylegan2_r1")
