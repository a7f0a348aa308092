"""A taming-transformers VQGAN in its upstream layout, the module whose
fixed-seed state dict is the ``synthetic_taming_vqgan`` anchor's checkpoint
(``record_published``). Under ``torch.manual_seed(0)`` ``TamingVQGAN()``
draws the state dict of the repo's own taming fixture, tensor for tensor:
the same modules are built in the same order.

Defaults are the anchor's tiny layout (width 32, mults (1, 2), encoder
depth 2, decoder depth 3, 8-dim codes, 16 codes); ``synthetic_checkpoint``
also makes one at full width (``configs/vqgan/16384_imagenet_ddp.py``:
width 128, mults (1, 1, 2, 2, 4), 256-dim, 16384 codes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TamingVQGAN", "synthetic_checkpoint"]


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32 if c % 32 == 0 else c, c, eps=1e-6)


class _ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _Attn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        b, c, hh, ww = q.shape
        q = q.reshape(b, c, hh * ww).permute(0, 2, 1)
        w = torch.softmax(torch.bmm(q, k.reshape(b, c, hh * ww)) * c**-0.5, dim=2)
        h = torch.bmm(v.reshape(b, c, hh * ww), w.permute(0, 2, 1)).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class _Down(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Up(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: ``block``/``attn`` lists and a resample."""

    def __init__(self, cin, cout, depth, attend, resample):
        super().__init__()
        blocks, attns, c = [], [], cin
        for _ in range(depth):
            blocks.append(_ResBlock(c, cout))
            c = cout
            if attend:
                attns.append(_Attn(cout))
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample == "down":
            self.downsample = _Down(cout)
        elif resample == "up":
            self.upsample = _Up(cout)

    def forward(self, x):
        for i, blk in enumerate(self.block):
            x = blk(x)
            if len(self.attn):
                x = self.attn[i](x)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return x


class _Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block_1 = _ResBlock(c, c)
        self.attn_1 = _Attn(c)
        self.block_2 = _ResBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Encoder(nn.Module):
    def __init__(self, width, mults, depth, zdim):
        super().__init__()
        widths, n = [width * m for m in mults], len(mults)
        self.conv_in = nn.Conv2d(3, width, 3, padding=1)
        self.down = nn.ModuleList(
            _Level(widths[i - 1] if i else width, widths[i], depth, attend=(i == n - 1),
                   resample="down" if i < n - 1 else None)
            for i in range(n))
        self.mid = _Mid(widths[-1])
        self.norm_out = _norm(widths[-1])
        self.conv_out = nn.Conv2d(widths[-1], zdim, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down:
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(self.mid(x))))


class _Decoder(nn.Module):
    def __init__(self, width, mults, depth, zdim):
        super().__init__()
        widths, n = [width * m for m in mults], len(mults)
        self.conv_in = nn.Conv2d(zdim, widths[-1], 3, padding=1)
        self.mid = _Mid(widths[-1])
        self.up = nn.ModuleList(  # up[t]: t = n - 1 runs first (the lowest resolution)
            _Level(widths[min(t + 1, n - 1)], widths[t], depth, attend=(t == n - 1),
                   resample="up" if t > 0 else None)
            for t in range(n))
        self.norm_out = _norm(widths[0])
        self.conv_out = nn.Conv2d(widths[0], 3, 3, padding=1)

    def forward(self, x):
        x = self.mid(self.conv_in(x))
        for t in reversed(range(len(self.up))):
            x = self.up[t](x)
        return self.conv_out(F.silu(self.norm_out(x)))


class TamingVQGAN(nn.Module):
    def __init__(self, width=32, mults=(1, 2), enc_depth=2, dec_depth=3, zdim=8, codes=16):
        super().__init__()
        self.encoder = _Encoder(width, mults, enc_depth, zdim)
        self.decoder = _Decoder(width, mults, dec_depth, zdim)
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Embedding(codes, zdim)
        self.quant_conv = nn.Conv2d(zdim, zdim, 1)
        self.post_quant_conv = nn.Conv2d(zdim, zdim, 1)

    def forward(self, x):
        feat = self.quant_conv(self.encoder(x))
        b, z, h, w = feat.shape
        codes = torch.cdist(feat.permute(0, 2, 3, 1).reshape(-1, z), self.quantize.embedding.weight).argmin(1)
        zq = self.quantize.embedding(codes).reshape(b, h, w, z).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(zq)), codes.reshape(b, h, w)


def synthetic_checkpoint(path: str, seed: int = 0, **layout) -> str:
    """``torch.manual_seed(seed)``, then ``TamingVQGAN(**layout)``'s state
    dict saved under ``state_dict`` at ``path``, as taming's ``last.ckpt``
    nests it."""
    torch.manual_seed(seed)
    torch.save({"state_dict": TamingVQGAN(**layout).state_dict()}, path)
    return path
