"""InceptionV3 feature extractor for FID, pytorch-fid's variant (port of
``vector_quantization_tpu/models/metrics/inception.py``).

uint8 (B, H, W, 3) -> /255 -> the JAX package's ``jax.image.resize(...,
(B, 299, 299, 3), "bilinear")`` (:func:`...ops.resize.resize`: the triangle
kernel, antialiased on a downscale) -> 2x − 1 -> the network (NCHW inside)
-> the spatial mean of ``Mixed_7c``: (B, 2048) f32.

- stem: 3×3/2 conv(32), 3×3 conv(32), 3×3 pad-1 conv(64), 3×3/2 max pool,
  1×1 conv(80), 3×3 conv(192), 3×3/2 max pool;
- 3× InceptionA (pool features 32/64/64), InceptionB, 4× InceptionC (c7
  128/160/160/192), InceptionD, 2× InceptionE;
- every conv is Conv (no bias) + BatchNorm (eps 1e-3, the running
  statistics always, also inside a training runner) + ReLU;
- FID's quirks: the pool branches of InceptionA, InceptionC and the first
  InceptionE average 3×3/1 pad 1 with the padding left out of the count
  (``count_include_pad=False``); the last InceptionE (``Mixed_7c``) max
  pools 3×3/1 pad 1; the 1×7 / 7×1 and 1×3 / 3×1 paddings are per axis.

Parameter names are pytorch-fid's (``Mixed_5b.branch1x1.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``), so a ``pt_inception`` state dict
loads with ``strict=True`` once its ``fc.*`` and ``AuxLogits.*`` keys are
dropped (:func:`load_inception`). Without weights the network is drawn
from a fixed generator: conv kernels N(0, 2/fan_in), BatchNorm scale 1,
bias 0, mean 0, var 1. The gain of 2 makes up for ReLU's halving of the
second moment, so the features are O(1): at N(0, 1/fan_in) they are about
1e-5, and every FID is then the constant -2·2048·1e-6 of the diagonal
offset whatever the images.
"""

from __future__ import annotations

import glob
import os

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize

__all__ = ["InceptionV3Features", "load_inception", "pt_inception_state_dict"]


class ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = ConvBN(c_in, 64, 1)
        self.branch5x5_1 = ConvBN(c_in, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(c_in, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(c_in, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x)),
        ], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int) -> None:
        super().__init__()
        self.branch3x3 = ConvBN(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(c_in, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, 2),
        ], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = ConvBN(c_in, 192, 1)
        self.branch7x7_1 = ConvBN(c_in, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(c_in, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(c_in, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int) -> None:
        super().__init__()
        self.branch3x3_1 = ConvBN(c_in, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(c_in, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int, pool: str) -> None:
        super().__init__()
        self.pool = pool  # "avg" (Mixed_7b) | "max" (Mixed_7c, FID's quirk)
        self.branch1x1 = ConvBN(c_in, 320, 1)
        self.branch3x3_1 = ConvBN(c_in, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(c_in, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(c_in, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """uint8 (B, H, W, 3) -> (B, 2048) pool features (module docstring)."""

    def __init__(self, resize_input: bool = True) -> None:
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    @torch.no_grad()
    def random_init(self, generator: torch.Generator) -> "InceptionV3Features":
        """Conv kernels N(0, 2/fan_in) from ``generator``; BatchNorm to
        scale 1, bias 0, mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32) / 255.0
        if self.resize_input:
            x = resize(x, 299, 299, "bilinear")
        x = (2.0 * x - 1.0).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def pt_inception_state_dict(path: str) -> dict[str, torch.Tensor]:
    """pytorch-fid's ``pt_inception`` state dict from ``path`` (a ``.pth``
    file, or a directory holding one) without the ``fc.*`` and
    ``AuxLogits.*`` keys, which the feature extractor does not use."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "*.pth")) + glob.glob(os.path.join(path, "*.pt")))
        if not found:
            raise FileNotFoundError(f"no .pth state dict in {path}")
        path = found[0]
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if not k.startswith(("fc.", "AuxLogits."))}


def load_inception(weights: str | None, device: torch.device | str) -> tuple[InceptionV3Features, bool]:
    """The network on ``device`` in eval mode with ``weights`` (a
    pytorch-fid state dict, strict), or drawn from a generator of seed 0
    where ``weights`` is None; and whether it is that random init."""
    model = InceptionV3Features()
    if weights:
        model.load_state_dict(pt_inception_state_dict(weights), strict=True)
    else:
        model.random_init(torch.Generator().manual_seed(0))
    return model.to(device).eval(), not weights
