"""Checkpoint remaps onto the port's modules (port of
``vector_quantization_tpu/utils/converters.py``).

The JAX converters map upstream torch state dicts to flax params; the port
has no flax tree in between, so each of these maps one straight to a state
dict of the port's module, to load with ``load_state_dict(strict=True)``.
Every function takes tensors or numpy arrays by name
(:func:`load_torch_state_dict` reads a ``.pth`` file).

- ``convert_taming_vqgan``: a taming-transformers VQGAN -> an
  ``AutoencoderModel`` of ``VQGANEncoder``/``VQGANDecoder``. taming's convs
  are OIHW like the port's and are copied as they are; its attention
  block's 1x1 ``q``, ``k``, ``v`` convs become one ``qkv`` Linear (rows in
  q, k, v order) and ``proj_out`` the ``proj`` Linear; ``mid`` is the
  ``refine`` block; the decoder's layer ``i`` is taming's level
  ``levels − 1 − i`` (taming indexes ``up`` by resolution);
  ``quant_conv``/``post_quant_conv`` are the ``post_encode``/``pre_decode``
  connectors.
- ``convert_vgg16_lpips``: torchvision's ``vgg16`` features and LPIPS's
  ``lin`` 1x1 convs -> ``LPIPS``.
- ``convert_clip_visual``: OpenAI CLIP's ``visual.*`` -> ``CLIPTeacher``
  (the attention's packed ``in_proj`` split into flax's per-head
  ``query``/``key``/``value`` kernels (D, H, Dh), ``out_proj`` into (H, Dh,
  D)).
- ``convert_gpt2``: HF GPT-2 -> ``GPT2Transformer`` (HF's ``Conv1D``
  weights are already (in, out)).
- ``convert_hf_llama``: HF ``LlamaForCausalLM`` -> ``LlamaTransformer``
  (Linear weights transposed to (in, out)).
- ``convert_beit_vqkd``: a BEiT-v2 VQ-KD checkpoint -> an
  ``AutoencoderModel`` of ``ViTEncoder``/``ViTDecoder`` (``qkv`` transposed
  to flax's ``qkv_kernel``; the task layers ``{0, 2}`` are ``task1``/
  ``task2``).

pytorch-fid's Inception needs no remap: ``models/metrics/inception.py``
loads its file by its own names.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

__all__ = [
    "load_torch_state_dict",
    "convert_beit_vqkd",
    "convert_clip_visual",
    "convert_gpt2",
    "convert_hf_llama",
    "convert_taming_vqgan",
    "convert_vgg16_lpips",
]


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` file's tensors by name, unwrapped from a ``state_dict``,
    ``model`` or ``module`` entry where the file nests them."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _tensors(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _strip(sd: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The entries under ``prefix``, without it; all of them where none is."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)} or dict(sd)


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
    sd = _tensors(sd)
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


# -- LPIPS: torchvision vgg16 features + LPIPS's lin convs -----------------------

_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_vgg16_lpips(
    vgg_sd: Mapping[str, Any], lin_sd: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """torchvision ``vgg16`` ``features.N.weight/bias`` (its 13 convs) and
    LPIPS's lin 1x1 convs (``{i}.weight`` or ``lins.{i}.weight``, (1, C, 1,
    1), no bias) -> an ``LPIPS`` state dict (without ``lin{i}`` where
    ``lin_sd`` is None)."""
    vgg_sd = _tensors(vgg_sd)
    out = {}
    for i, idx in enumerate(_VGG16_CONV_IDX):
        out[f"vgg.conv{i}.weight"] = vgg_sd[f"features.{idx}.weight"]
        out[f"vgg.conv{i}.bias"] = vgg_sd[f"features.{idx}.bias"]
    if lin_sd is not None:
        lin_sd = _tensors(lin_sd)
        for i in range(5):
            key = f"{i}.weight" if f"{i}.weight" in lin_sd else f"lins.{i}.weight"
            out[f"lin{i}.weight"] = lin_sd[key]
    return out


# -- CLIP visual tower -> CLIPTeacher --------------------------------------------


def _clip_num_heads(d: int) -> int:
    return {768: 12, 1024: 16, 1280: 16}.get(d, max(1, d // 64))


def convert_clip_visual(sd: Mapping[str, Any], num_heads: int | None = None) -> dict[str, torch.Tensor]:
    """OpenAI CLIP ``visual.*`` (or the tower's own names) -> a
    ``CLIPTeacher`` state dict; ``num_heads`` by the width (ViT-B 12, L 16)
    where not given."""
    v = _strip(_tensors(sd), "visual.")
    d = v["class_embedding"].shape[-1]
    heads = num_heads or _clip_num_heads(d)
    dh = d // heads
    out = {
        "backbone.patch_embed.weight": v["conv1.weight"],
        "backbone.cls_token": v["class_embedding"].reshape(1, 1, d),
        "backbone.pos_embed": v["positional_embedding"][None],
    }
    for name in ("ln_pre", "ln_post"):
        out[f"backbone.{name}.weight"], out[f"backbone.{name}.bias"] = v[f"{name}.weight"], v[f"{name}.bias"]
    if "proj" in v:
        out["backbone.proj"] = v["proj"]
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in v:
        src, dst = f"transformer.resblocks.{i}", f"backbone.block{i}"
        ws = v[f"{src}.attn.in_proj_weight"].chunk(3, dim=0)
        bs = v[f"{src}.attn.in_proj_bias"].chunk(3, dim=0)
        for name, w, b in zip(("query", "key", "value"), ws, bs):
            out[f"{dst}_attn.{name}.kernel"] = w.t().reshape(d, heads, dh)
            out[f"{dst}_attn.{name}.bias"] = b.reshape(heads, dh)
        out[f"{dst}_attn.out.kernel"] = v[f"{src}.attn.out_proj.weight"].t().reshape(heads, dh, d)
        out[f"{dst}_attn.out.bias"] = v[f"{src}.attn.out_proj.bias"]
        for port, up in (("norm1", "ln_1"), ("norm2", "ln_2"), ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            out[f"{dst}_{port}.weight"] = v[f"{src}.{up}.weight"]
            out[f"{dst}_{port}.bias"] = v[f"{src}.{up}.bias"]
        i += 1
    return {k: t.contiguous() for k, t in out.items()}


# -- HF GPT-2 / Llama -> GPT2Transformer / LlamaTransformer ----------------------


def convert_gpt2(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """HF GPT-2 (``transformer.*`` or bare) -> a ``GPT2Transformer`` state
    dict; HF's ``Conv1D`` weights are (in, out), the port's layout."""
    g = _strip(_tensors(sd), "transformer.")
    out = {"wte": g["wte.weight"], "wpe": g["wpe.weight"],
           "ln_f.scale": g["ln_f.weight"], "ln_f.bias": g["ln_f.bias"]}
    i = 0
    while f"h.{i}.ln_1.weight" in g:
        for port, up in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            out[f"h{i}.{port}.scale"] = g[f"h.{i}.{up}.weight"]
            out[f"h{i}.{port}.bias"] = g[f"h.{i}.{up}.bias"]
        for port, up in (("c_attn", "attn.c_attn"), ("c_proj", "attn.c_proj"), ("mlp_fc", "mlp.c_fc"),
                         ("mlp_proj", "mlp.c_proj")):
            out[f"h{i}.{port}.kernel"] = g[f"h.{i}.{up}.weight"]
            out[f"h{i}.{port}.bias"] = g[f"h.{i}.{up}.bias"]
        i += 1
    return out


_LLAMA_PROJ = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
               "o_proj": "self_attn.o_proj", "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
               "down_proj": "mlp.down_proj"}


def convert_hf_llama(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` (``model.*`` + ``lm_head.weight``, or bare)
    -> a float ``LlamaTransformer`` state dict (unfused projections; the lm
    head only where the checkpoint has one)."""
    sd = _tensors(sd)
    m = _strip(sd, "model.")
    out = {"embedding": m["embed_tokens.weight"], "final_norm.scale": m["norm.weight"]}
    if "lm_head.weight" in sd:
        out["lm_head"] = sd["lm_head.weight"].t()
    i = 0
    while f"layers.{i}.input_layernorm.weight" in m:
        src = f"layers.{i}"
        out[f"layer{i}.input_norm.scale"] = m[f"{src}.input_layernorm.weight"]
        out[f"layer{i}.post_norm.scale"] = m[f"{src}.post_attention_layernorm.weight"]
        for port, up in _LLAMA_PROJ.items():
            out[f"layer{i}.{port}.kernel"] = m[f"{src}.{up}.weight"].t()
        i += 1
    return {k: t.contiguous() for k, t in out.items()}


# -- BEiT-v2 VQ-KD -> AutoencoderModel(ViTEncoder / ViTDecoder) ------------------


def _beit_vit(out: dict, sd: Mapping[str, torch.Tensor], prefix: str, task_prefix: str) -> None:
    dst = f"{prefix}.backbone."
    for name in ("cls_token", "pos_embed"):
        out[dst + name] = sd[f"{prefix}.{name}"]
    for port, src in (("patch_embed", f"{prefix}.patch_embed.proj"), ("fc_norm", f"{prefix}.fc_norm"),
                      ("task1", f"{task_prefix}.0"), ("task2", f"{task_prefix}.2")):
        out[dst + port + ".weight"], out[dst + port + ".bias"] = sd[src + ".weight"], sd[src + ".bias"]
    i = 0
    while f"{prefix}.blocks.{i}.norm1.weight" in sd:
        src, blk = f"{prefix}.blocks.{i}", f"{dst}block{i}."
        out[blk + "attn.qkv_kernel"] = sd[f"{src}.attn.qkv.weight"].t()
        out[blk + "attn.q_bias"] = sd[f"{src}.attn.q_bias"]
        out[blk + "attn.v_bias"] = sd[f"{src}.attn.v_bias"]
        for port, up in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.proj", "attn.proj"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[blk + port + ".weight"] = sd[f"{src}.{up}.weight"]
            out[blk + port + ".bias"] = sd[f"{src}.{up}.bias"]
        i += 1


def convert_beit_vqkd(sd: Mapping[str, Any], with_decoder: bool = True) -> dict[str, torch.Tensor]:
    """A BEiT-v2 VQ-KD checkpoint (``encoder.*``, ``decoder.*``,
    ``encode_task_layer``/``decode_task_layer``, ``quantize.embedding``)
    -> an ``AutoencoderModel(ViTEncoder, ViTDecoder)`` state dict; the
    decoder only ``with_decoder`` and where the checkpoint has one;
    ``post_quant_conv`` (a 1x1 conv, or a Linear read as one) is the
    ``pre_decode`` connector."""
    sd = _tensors(sd)
    out: dict[str, torch.Tensor] = {}
    _beit_vit(out, sd, "encoder", "encode_task_layer")
    out["quantizer.codebook"] = sd["quantize.embedding.weight"]
    if with_decoder and "decoder.cls_token" in sd:
        _beit_vit(out, sd, "decoder", "decode_task_layer")
    if "post_quant_conv.weight" in sd:
        w = sd["post_quant_conv.weight"]
        out["pre_decode.conv.weight"] = w if w.dim() == 4 else w[:, :, None, None]
        out["pre_decode.conv.bias"] = sd["post_quant_conv.bias"]
    return {k: t.contiguous() for k, t in out.items()}
