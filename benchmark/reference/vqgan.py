"""The VQGAN tokenizer and its GAN losses, plain PyTorch, float32, NCHW
inside and NHWC at the model's edges.

Esser et al., "Taming Transformers" (arXiv:2012.09841), as LlamaGen's VQ-16
configures it (Sun et al., arXiv:2406.06525): a conv encoder of residual
blocks over five resolutions (width 128, multipliers 1, 1, 2, 2, 4, two
blocks each, self-attention at the last, a res-attn-res refine block),
GroupNorm(32, eps 1e-6) + SiLU + conv projector to 8 channels; an
l2-normalised 16384 x 8 codebook, nearest code by the full distance
matrix; the mirrored decoder (three blocks a resolution, nearest x2
upsampling); the PatchGAN discriminator (4x4 stride-2 convs, LeakyReLU
0.2, BatchNorm); LPIPS on VGG16 taps.

Departures, as the repository computes them: the downsample pads right
and bottom by one before a VALID stride-2 conv (flax's SAME); BatchNorm is
flax's (biased batch variance E[x^2] - E[x]^2, momentum 0.99); LPIPS runs
at random weights (no pretrained file is in the repository).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def normalize(x, dim: int = -1, eps: float = 1e-12):
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=dim, keepdim=True) + eps)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class GroupNorm32(nn.GroupNorm):
    def __init__(self, c: int) -> None:
        super().__init__(32 if c % 32 == 0 else c, c, eps=1e-6)


def conv3x3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding="same")


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(c_in)
        self.conv1 = conv3x3(c_in, c_out)
        self.norm2 = GroupNorm32(c_out)
        self.conv2 = conv3x3(c_out, c_out)
        self.shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.norm = GroupNorm32(c)
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)
        q, k, v = self.qkv(y).chunk(3, dim=-1)
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        return x + self.proj(attn @ v).transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.conv = conv3x3(c, c)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Refine(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.res1, self.attn, self.res2 = ResBlock(c, c), AttnBlock(c), ResBlock(c, c)

    def forward(self, x):
        return self.res2(self.attn(self.res1(x)))


class Backbone(nn.Module):
    def __init__(self, c_in, c_out, hidden, width, mults, depth, attention_layer, refine_layer, resample):
        super().__init__()
        self.conv_in = conv3x3(c_in, hidden)
        self.order = ["conv_in"]
        c, n = hidden, len(mults)
        for i in range(n):
            if refine_layer == i:
                self.add("refine", Refine(c))
            for d in range(depth):
                self.add(f"layer{i}_res{d}", ResBlock(c, width * mults[i]))
                c = width * mults[i]
                if attention_layer == i:
                    self.add(f"layer{i}_attn{d}", AttnBlock(c))
            if i < n - 1:
                self.add(f"down{i}" if resample == "down" else f"up{i}",
                         Downsample(c) if resample == "down" else Upsample(c))
        if refine_layer == n:
            self.add("refine", Refine(c))
        self.norm_out = GroupNorm32(c)
        self.proj_out = conv3x3(c, c_out)

    def add(self, name, module):
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x):
        for name in self.order:
            x = getattr(self, name)(x)
        return self.proj_out(F.silu(self.norm_out(x)))


class Encoder(nn.Module):
    def __init__(self, out_channels: int, width: int, width_mults=(1, 1, 2, 2, 4), depth_mult: int = 2):
        super().__init__()
        n = len(width_mults)
        self.downsample_factor = 2 ** (n - 1)
        self.backbone = Backbone(3, out_channels, width, width, width_mults, depth_mult, n - 1, n, "down")

    def forward(self, x):
        return self.backbone(x)


class Decoder(nn.Module):
    def __init__(self, in_channels: int, width: int, width_mults=(4, 2, 2, 1, 1), depth_mult: int = 3):
        super().__init__()
        self.backbone = Backbone(in_channels, 3, width * width_mults[0], width, width_mults, depth_mult,
                                 0, 0, "up")

    def forward(self, x):
        return self.backbone(x)


class Quantizer(nn.Module):
    """l2-normalised features against the l2-normalised codebook; the
    nearest code by the whole score matrix ``0.5·‖e‖² − x·e`` (its first
    argmin), in float64: the exact nearest code of the float32 features,
    where float32 scores would settle a near tie by their rounding;
    LlamaGen's codebook + 0.25 x commitment loss; the straight-through
    output."""

    def __init__(self, codebook_size: int, embedding_dim: int, beta: float = 0.25) -> None:
        super().__init__()
        self.beta = beta
        self.codebook = nn.Parameter(torch.zeros(codebook_size, embedding_dim))

    def codes(self, x, e, block: int = 4096):
        x, e = x.detach().double(), e.detach().double()
        half = 0.5 * torch.sum(e * e, dim=1)
        return torch.cat([torch.argmin(half[None] - x[i:i + block] @ e.T, dim=1)
                          for i in range(0, x.shape[0], block)])

    def forward(self, x):
        x = normalize(x)
        e = normalize(self.codebook)
        codes = self.codes(x, e)
        z = e[codes]
        loss = torch.mean(torch.square(z - x.detach())) + self.beta * torch.mean(torch.square(z.detach() - x))
        return x + (z - x).detach(), codes, loss


class Autoencoder(nn.Module):
    def __init__(self, codebook_size: int = 16384, embedding_dim: int = 8, width: int = 128,
                 enc_mults=(1, 1, 2, 2, 4), dec_mults=(4, 2, 2, 1, 1), enc_depth: int = 2,
                 dec_depth: int = 3, decoder: bool = True) -> None:
        super().__init__()
        self.encoder = Encoder(embedding_dim, width, enc_mults, enc_depth)
        self.quantizer = Quantizer(codebook_size, embedding_dim)
        self.decoder = Decoder(embedding_dim, width, dec_mults, dec_depth) if decoder else None

    def features(self, image):
        """pixels (B, H, W, 3) -> normalised features (B·h·w, D), row-major."""
        f = nhwc(self.encoder(nchw(image)))
        return normalize(f.reshape(-1, f.shape[-1]))

    def encode_to_quant(self, image):
        f = nhwc(self.encoder(nchw(image)))
        b, h, w, d = f.shape
        return self.quantizer.codes(normalize(f.reshape(-1, d)), normalize(self.quantizer.codebook)).reshape(b, h, w)

    def forward(self, image):
        f = nhwc(self.encoder(nchw(image)))
        b, h, w, d = f.shape
        z, codes, q_loss = self.quantizer(f.reshape(-1, d))
        pred = nhwc(self.decoder(nchw(z.reshape(b, h, w, d))))
        return pred, codes.reshape(b, h, w), q_loss


class BatchNorm(nn.Module):
    def __init__(self, c: int, momentum: float = 0.99, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(torch.square(x).mean(dim=(0, 2, 3)) - torch.square(mean), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class PatchGAN(nn.Module):
    def __init__(self, width: int = 64, depth: int = 3) -> None:
        super().__init__()
        self.layers = []  # (conv, batch norm or None)
        plan = [(3, width, 2, False, True)]
        c = width
        for n in range(1, depth):
            plan.append((c, width * min(2 ** n, 8), 2, True, False))
            c = width * min(2 ** n, 8)
        plan.append((c, width * min(2 ** depth, 8), 1, True, False))
        plan.append((width * min(2 ** depth, 8), 1, 1, False, True))
        bn_i = 0
        for i, (ci, co, s, norm, bias) in enumerate(plan):
            self.add_module(f"Conv_{i}", nn.Conv2d(ci, co, 4, stride=s, padding=1, bias=bias))
            bn = None
            if norm:
                bn = f"BatchNorm_{bn_i}"
                self.add_module(bn, BatchNorm(co))
                bn_i += 1
            self.layers.append((f"Conv_{i}", bn))

    def forward(self, x, train: bool):
        x = nchw(x)
        for i, (conv, bn) in enumerate(self.layers):
            x = getattr(self, conv)(x)
            if bn:
                x = getattr(self, bn)(x, train)
            if i < len(self.layers) - 1:
                x = F.leaky_relu(x, 0.2)
        return nhwc(x)


_VGG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class LPIPS(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.vgg = nn.Module()
        c, i = 3, 0
        for width, depth in _VGG:
            for _ in range(depth):
                self.vgg.add_module(f"conv{i}", nn.Conv2d(c, width, 3, padding=1))
                c, i = width, i + 1
        for j, (width, _) in enumerate(_VGG):
            self.add_module(f"lin{j}", nn.Conv2d(width, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor((-0.030, -0.088, -0.188)).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor((0.458, 0.448, 0.450)).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def taps(self, x):
        x = (nchw(x) - self.shift) / self.std
        out, i = [], 0
        for s, (_, depth) in enumerate(_VGG):
            for _ in range(depth):
                x = F.relu(getattr(self.vgg, f"conv{i}")(x))
                i += 1
            out.append(x)
            if s < len(_VGG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return out

    def forward(self, pred, target):
        total = torch.zeros((), device=pred.device)
        for j, (fp, ft) in enumerate(zip(self.taps(pred), self.taps(target))):
            fp = fp * torch.rsqrt(torch.sum(torch.square(fp), dim=1, keepdim=True) + 1e-10)
            ft = ft * torch.rsqrt(torch.sum(torch.square(ft), dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{j}")(torch.square(fp - ft)).mean(dim=(1, 2, 3)).mean()
        return total


def hinge_d_loss(fake, real):
    return torch.mean((F.relu(1.0 + fake) + F.relu(1.0 - real)) / 2.0)


def fan_in_rule(name: str, shape) -> tuple:
    """Seeded weights of a conv net's leaf: N(0, 1/(3·fan_in)) for conv and
    linear weights (the variance of PyTorch's default uniform init), zero
    biases, unit norm scales; N(0, 1) codebook rows; LPIPS's 1x1 ``lin``
    heads at 1 (their init); PatchGAN's BatchNorm scales N(1, 0.02)."""
    if name.endswith("codebook"):
        return ("normal", 1.0)
    if name.startswith("lin") and name.endswith(".weight"):
        return ("ones",)
    if "BatchNorm" in name and name.endswith(".scale"):
        return ("normal", 0.02, 1.0)
    if name.endswith(".weight") and len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return ("normal", 1.0 / math.sqrt(3.0 * fan_in))
    if name.endswith(".weight") or name.endswith(".scale"):
        return ("ones",)
    return ("zeros",)
