"""The yardstick: the card's peaks, and the operations and bytes of each
measured piece of work, from the configuration's shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s, its dense bf16 rate and the highest dense
floating-point rate it has, and 3.35 TB/s of HBM3. A piece of work's least
time is the larger of its operations at the one and its bytes at the
other. The configurations compute in float32, whose rate outside the
tensor cores is 67 TFLOP/s, so shares of 989 read low on purpose: no
implementation, whatever precision it finds exact enough, reads over 100%.

Operations are counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference (``benchmark/reference``) run on the meta device
at the cell's shapes: every matrix product and convolution of the step,
forward, input gradient and weight gradient, as autograd needs them, two
operations a multiply-add. Never from the program's modules.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import steps as ref

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def k1(n: int, k: int, d: int) -> tuple[int, int]:
    """The nearest-code lookup of n rows over k codes of width d: 2·n·k·d
    operations; x, the codebook (f32) and the int32 codes, each once."""
    return 2 * n * k * d, 4 * (n * d + k * d) + 4 * n


def gpt2_forward_per_token(d: int, layers: int, vocab: int, t: int) -> int:
    """By hand: the four projections (12·d² weights), attention's two
    products over all t columns (the mask is additive), the tied head."""
    return layers * (2 * 12 * d * d + 4 * t * d) + 2 * d * vocab


def _key(cfg: dict) -> str:
    return json.dumps(cfg, sort_keys=True)


def _meta_images(b: int, s: int):
    return torch.zeros((b, s, s, 3), device="meta")


def _params(*modules) -> int:
    return sum(p.numel() for m in modules for p in m.parameters())


@functools.lru_cache(maxsize=None)
def _encode(cfg_key: str, b: int, s: int) -> tuple[int, int]:
    ir = json.loads(cfg_key)
    ae = ref.built(lambda: ref.autoencoder(ir, False), "meta")
    flops = counted(lambda: ae.encode_to_quant(_meta_images(b, s)))
    return flops, b * s * s * 3 + 4 * _params(ae)


def encode(ir: dict, b: int, s: int) -> tuple[int, int]:
    """The tokenizer's encode of b images of s px: (operations, bytes), the
    bytes the uint8 images and the weights, each once."""
    return _encode(_key(ir), b, s)


@functools.lru_cache(maxsize=None)
def _ar_step(cfg_key: str, b: int, s: int) -> tuple[int, int]:
    cfg = json.loads(cfg_key)
    model = ref.built(lambda: ref.gpt2(cfg), "meta")
    ae = ref.built(lambda: ref.autoencoder(cfg["ir"], False), "meta")
    labels = torch.zeros((b,), dtype=torch.long, device="meta")

    def step():
        loss, _ = ref.ar_loss(model, ae, _meta_images(b, s), labels, cfg["num_categories"])
        torch.autograd.grad(loss, list(model.parameters()))

    # AdamW: the weights and both moments read and written, the gradient read
    return counted(step), 28 * _params(model) + b * s * s * 3


def ar_step(cfg: dict, b: int, s: int) -> tuple[int, int]:
    """One AR training step from b images of s px: the frozen encoder and
    lookup, GPT-2's forward and backward. (operations, bytes)."""
    return _ar_step(_key(cfg), b, s)


@functools.lru_cache(maxsize=None)
def _vqgan_step(cfg_key: str, b: int, s: int) -> tuple[int, int]:
    cfg = json.loads(cfg_key)
    ae = ref.built(lambda: ref.autoencoder(cfg, True), "meta")
    disc = ref.built(ref.vq.PatchGAN, "meta")
    lpips = ref.built(ref.vq.LPIPS, "meta")

    def step():
        image = _meta_images(b, s)
        total, pred, _ = ref.vqgan_losses(ae, disc, lpips, image, cfg["aglw_gain"])
        torch.autograd.grad(total, list(ae.parameters()))
        torch.autograd.grad(ref.vqgan_d_loss(disc, pred, image), list(disc.parameters()))

    return counted(step), 28 * _params(ae, disc) + b * s * s * 3


def vqgan_step(cfg: dict, b: int, s: int) -> tuple[int, int]:
    """One GAN-on VQGAN training step at b images of s px: generator,
    LPIPS, the adaptive weight's two gradients, the generator's backward,
    the discriminator's two passes and backward. (operations, bytes)."""
    return _vqgan_step(_key(cfg), b, s)
