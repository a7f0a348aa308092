"""Checkpoint remaps onto the port's modules (port of
``vector_quantization_tpu/utils/converters.py``): ``convert_taming_vqgan``
only.

The JAX converter maps a taming-transformers VQGAN state dict to flax
params; the port has no flax tree in between, so this maps it straight to
an ``AutoencoderModel`` state dict. taming's convs are OIHW like the
port's and are copied as they are; its attention block's 1x1 ``q``,
``k``, ``v`` convs become one ``qkv`` Linear (rows in q, k, v order) and
``proj_out`` the ``proj`` Linear; ``mid`` is the ``refine`` block; the
decoder's layer ``i`` is taming's level ``levels − 1 − i`` (taming indexes
``up`` by resolution); ``quant_conv``/``post_quant_conv`` are the
``post_encode``/``pre_decode`` connectors.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

__all__ = ["convert_taming_vqgan"]


def _taming_half(
    out: dict[str, torch.Tensor],
    sd: Mapping[str, torch.Tensor],
    prefix: str,
    num_levels: int,
    depth: int,
    attention_layer: int,
    decoder: bool,
) -> None:
    dst = f"{prefix}.backbone."

    def copy(src: str, name: str, bias: bool = True) -> None:
        out[dst + name + ".weight"] = sd[src + ".weight"]
        if bias:
            out[dst + name + ".bias"] = sd[src + ".bias"]

    def res(src: str, name: str) -> None:
        for part in ("norm1", "conv1", "norm2", "conv2"):
            copy(f"{src}.{part}", f"{name}.{part}")
        if f"{src}.nin_shortcut.weight" in sd:
            copy(f"{src}.nin_shortcut", f"{name}.shortcut")

    def attn(src: str, name: str) -> None:
        copy(f"{src}.norm", f"{name}.norm")
        out[dst + name + ".qkv.weight"] = torch.cat([sd[f"{src}.{w}.weight"][:, :, 0, 0] for w in "qkv"])
        out[dst + name + ".qkv.bias"] = torch.cat([sd[f"{src}.{w}.bias"] for w in "qkv"])
        out[dst + name + ".proj.weight"] = sd[f"{src}.proj_out.weight"][:, :, 0, 0]
        out[dst + name + ".proj.bias"] = sd[f"{src}.proj_out.bias"]

    copy(f"{prefix}.conv_in", "conv_in")
    res(f"{prefix}.mid.block_1", "refine.res1")
    attn(f"{prefix}.mid.attn_1", "refine.attn")
    res(f"{prefix}.mid.block_2", "refine.res2")
    copy(f"{prefix}.norm_out", "norm_out")
    copy(f"{prefix}.conv_out", "proj_out")
    updown = "up" if decoder else "down"
    for i in range(num_levels):
        t = num_levels - 1 - i if decoder else i
        for d in range(depth):
            res(f"{prefix}.{updown}.{t}.block.{d}", f"layer{i}_res{d}")
            if attention_layer == i:
                attn(f"{prefix}.{updown}.{t}.attn.{d}", f"layer{i}_attn{d}")
        if i < num_levels - 1:
            resample = "upsample" if decoder else "downsample"
            copy(f"{prefix}.{updown}.{t}.{resample}.conv", f"{updown}{i}.conv")


def convert_taming_vqgan(
    sd: Mapping[str, Any],
    *,
    enc_width_mults: Sequence[int] = (1, 1, 2, 2, 4),
    enc_depth: int = 2,
    dec_depth: int = 3,
) -> dict[str, torch.Tensor]:
    """A taming-transformers VQGAN state dict (tensors or numpy arrays) ->
    a state dict for the port's ``AutoencoderModel`` of that layout
    (``VQGANEncoder``/``VQGANDecoder`` with ``len(enc_width_mults)``
    levels, encoder attention at the last level, decoder attention at the
    first; ``ConvConnector``s where the checkpoint has ``quant_conv`` /
    ``post_quant_conv``)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    n = len(enc_width_mults)
    out: dict[str, torch.Tensor] = {}
    _taming_half(out, sd, "encoder", n, enc_depth, n - 1, decoder=False)
    _taming_half(out, sd, "decoder", n, dec_depth, 0, decoder=True)
    out["quantizer.codebook"] = sd["quantize.embedding.weight"]
    for src, dst in (("quant_conv", "post_encode"), ("post_quant_conv", "pre_decode")):
        if f"{src}.weight" in sd:
            out[f"{dst}.conv.weight"] = sd[f"{src}.weight"]
            out[f"{dst}.conv.bias"] = sd[f"{src}.bias"]
    return out
