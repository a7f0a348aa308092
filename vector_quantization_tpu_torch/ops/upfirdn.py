"""upfirdn2d and the fused bias + leaky ReLU of the StyleGAN2 discriminator
(port of ``vector_quantization_tpu/ops/upfirdn.py``; mmcv's
``upfirdn2d`` / ``FusedBiasLeakyReLU`` semantics).

- :func:`upfirdn2d`: zero-insertion upsampling by ``up``, then padding
  (a negative pad crops), then the FIR filter as a true convolution (the
  taps flipped, since ``F.conv2d`` correlates), then stride-``down``
  decimation: a depthwise ``F.conv2d`` with ``groups=C`` and stride
  ``down``.
- :func:`fused_bias_leaky_relu`: ``leaky_relu(x + bias, 0.2)·√2``.

Compositions of torch ops, as the JAX package's are of XLA ops: no kernel
stands behind them. :func:`upfirdn2d` takes NHWC as the JAX function does;
:func:`upfirdn2d_nchw` is the same on NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["blur_kernel_2d", "fused_bias_leaky_relu", "upfirdn2d", "upfirdn2d_nchw"]


def blur_kernel_2d(taps=(1.0, 3.0, 3.0, 1.0)) -> np.ndarray:
    """The normalised separable blur kernel (StyleGAN2's [1, 3, 3, 1])."""
    k = np.asarray(taps, np.float32)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def upfirdn2d_nchw(x: torch.Tensor, kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """x (B, C, H, W); kernel (kh, kw); pad (x0, x1) for both axes or
    (x0, x1, y0, y1)."""
    px0, px1, py0, py1 = (*pad, *pad) if len(pad) == 2 else pad
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    k = torch.as_tensor(np.ascontiguousarray(np.asarray(kernel, np.float32)[::-1, ::-1]), device=x.device)
    weight = k.to(x.dtype)[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, weight, stride=down, groups=c)


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """:func:`upfirdn2d_nchw` on x (B, H, W, C)."""
    return upfirdn2d_nchw(x.permute(0, 3, 1, 2), kernel, up, down, pad).permute(0, 2, 3, 1)


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                          scale: float = 2.0**0.5, channel_dim: int = -1) -> torch.Tensor:
    """``leaky_relu(x + bias)·scale``, ``bias`` (C,) along ``channel_dim``."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return F.leaky_relu(x + bias.reshape(shape), negative_slope) * scale
