"""Image resizing by weight matrices: the JAX package's
``jax.image.resize`` (``scale_and_translate``, antialiased) on NHWC tensors.

Each axis whose size changes is resampled by one (out, in) f32 matrix,
built on the host as JAX's ``compute_weight_mat`` builds it (scale out/in,
no translation): output i samples input position (i + 0.5)/scale − 0.5
through the kernel widened by max(1/scale, 1) (the antialiasing of a
downscale); each output's weights are divided by their sum (zero where that
sum is ~0), and an output whose sample lies outside [−0.5, in − 0.5] gets
none. The kernels:

- ``bicubic``: Keys' cubic with a = -0.5 (``F.interpolate``'s takes
  a = -0.75);
- ``linear`` (``bilinear``): the triangle max(0, 1 − |x|). ``F.interpolate``
  does not antialias by default, and its ``antialias=True`` form is not held
  to JAX's edge weights.

The matrices are cached by (in, out, kernel) and applied by ``einsum``; an
axis whose size does not change is left as it is.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize", "resize_weights"]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at |distance| ``x`` (f32)."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - x)


_KERNELS = {"bicubic": _keys_cubic, "linear": _triangle, "bilinear": _triangle}


@lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """The (out, in) f32 resampling matrix of one axis (module docstring),
    in JAX's f32 arithmetic: 1/scale rounded once from float64, the sample
    positions, distances, kernel and sums in f32."""
    kernel = _KERNELS[method]
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / max(inv_scale, f32(1.0))
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(f32).eps)), w / np.where(total != 0, total, f32(1)),
                 f32(0))
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, f32(0))
    return np.ascontiguousarray(w.T, dtype=f32)


def resize(x: torch.Tensor, height: int, width: int, method: str = "bicubic") -> torch.Tensor:
    """NHWC ``x`` (float) resized to (height, width) with ``method``'s
    kernel, f32 products: one weight matrix per axis that changes."""
    if x.shape[1] != height:
        w = torch.from_numpy(resize_weights(x.shape[1], height, method)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", w, x)
    if x.shape[2] != width:
        w = torch.from_numpy(resize_weights(x.shape[2], width, method)).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", w, x)
    return x
