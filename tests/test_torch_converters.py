"""The port's weight converters against the JAX package's, on the CPU.

Each upstream checkpoint is faked at a tiny width from a seed with numpy,
in the upstream layout and names: torchvision's ``vgg16`` features with
LPIPS's lin convs, OpenAI CLIP's visual tower, HF GPT-2, HF Llama and a
BEiT-v2 VQ-KD tokenizer. One side runs the JAX converter and the JAX
module on the flax tree it gives; the other the port's converter, a
strict ``load_state_dict`` and the port's module. Outputs agree within
1e-5 of max|ref| (f32 in another order).

Then the LPIPS repair: ``ReconstructionAlgorithm`` loads
``$PRETRAINED/lpips`` (torchvision's and LPIPS's files, written here from
a seed), and its LPIPS value equals the JAX LPIPS run with the JAX
converter's tree from the same files, within 1e-5 relative; without the
directory LPIPS keeps its random init.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.vqkd  # noqa: F401  (registers the JAX teachers)
import vector_quantization_tpu.models  # noqa: F401  (registers the JAX modules)
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.models.losses.lpips import LPIPS as JaxLPIPS
from vector_quantization_tpu.models.transformers.gpt2 import GPT2Transformer as JaxGPT2
from vector_quantization_tpu.models.transformers.llama import LlamaTransformer as JaxLlama
from vector_quantization_tpu.registries import ModelRegistry as JaxModelRegistry
from vector_quantization_tpu.registries import TeacherRegistry as JaxTeacherRegistry
from vector_quantization_tpu.utils import converters as jax_converters
from vector_quantization_tpu_torch.models.losses.lpips import LPIPS, LPIPS_LIN_FILE, LPIPS_VGG_FILE
from vector_quantization_tpu_torch.models.transformers.gpt2 import GPT2Transformer
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, ModelRegistry, TeacherRegistry
from vector_quantization_tpu_torch.utils import converters
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
REL = 1e-5
D, HEADS, DEPTH, SIZE, PATCH = 32, 2, 2, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def _fake(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    """An upstream state dict: weights N(0, 1/fan_in) (fan_in: all axes but
    the first), ``*norm*``/``ln*`` weights 1 + N(0, 0.05²), biases and
    embeddings N(0, 0.05²)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        norm = any(k in name for k in ("norm", "ln_", "ln_pre", "ln_post", "layernorm"))
        if norm and leaf == "weight":
            v = 1.0 + rng.normal(0.0, 0.05, shape)
        elif leaf == "weight" and len(shape) > 1 and "embed" not in name and not name.startswith(("wte", "wpe")):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = rng.normal(0.0, 0.05, shape)
        out[name] = v.astype(np.float32)
    return out


def _torch(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# -- LPIPS ----------------------------------------------------------------------

_VGG = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 512),
        (512, 512), (512, 512), (512, 512), (512, 512), (512, 512))
_LPIPS_WIDTHS = (64, 128, 256, 512, 512)


def _vgg_and_lin(seed, lin_prefix=""):
    shapes = {}
    for idx, (cin, cout) in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28), _VGG):
        shapes[f"features.{idx}.weight"] = (cout, cin, 3, 3)
        shapes[f"features.{idx}.bias"] = (cout,)
    rng = np.random.default_rng(seed + 1)
    lin = {f"{lin_prefix}{i}.weight": rng.uniform(0.0, 1.0, (1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate(_LPIPS_WIDTHS)}
    return _fake(shapes, seed), lin


def _images(seed, b=2, s=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("lin_prefix", ["", "lins."])
def test_vgg16_lpips_matches_jax(lin_prefix):
    vgg, lin = _vgg_and_lin(0, lin_prefix)
    pred, target = _images(1), _images(2)
    want = JaxLPIPS().apply({"params": jax_converters.convert_vgg16_lpips(vgg, lin)},
                            jnp.asarray(pred), jnp.asarray(target))
    port = _load(LPIPS(), converters.convert_vgg16_lpips(_torch(vgg), _torch(lin)))
    got = port(torch.from_numpy(pred), torch.from_numpy(target))
    _close(got, want, "lpips")
    assert set(converters.convert_vgg16_lpips(vgg)) == {k for k in port.state_dict() if not k.startswith("lin")}


def _lpips_algorithm():
    cfg = Config.load(SMOKE)["trainer"]["algorithm"]
    cfg["recon_losses"] = dict(l1=dict(), lpips=dict(weight=1.0))
    return AlgorithmRegistry.build(cfg, device="cpu")


def test_reconstruction_algorithm_loads_pretrained_lpips(tmp_path, monkeypatch):
    vgg, lin = _vgg_and_lin(3)
    (tmp_path / "lpips").mkdir()
    torch.save(_torch(vgg), tmp_path / "lpips" / LPIPS_VGG_FILE)
    torch.save({"state_dict": _torch(lin)}, tmp_path / "lpips" / LPIPS_LIN_FILE)
    monkeypatch.setenv("PRETRAINED", str(tmp_path))
    algo = _lpips_algorithm()
    state = algo.init_state(0)
    assert torch.equal(state.extra["lpips_params"]["vgg.conv0.weight"], torch.from_numpy(vgg["features.0.weight"]))
    files = [jax_converters.load_torch_state_dict(str(tmp_path / "lpips" / name))
             for name in (LPIPS_VGG_FILE, LPIPS_LIN_FILE)]
    params = jax_converters.convert_vgg16_lpips(*files)
    pred, target = _images(4), _images(5)
    want = float(JaxLPIPS().apply({"params": params}, jnp.asarray(pred), jnp.asarray(target)))
    got = float(algo._recon("lpips", {}, torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - want) <= REL * abs(want), (got, want)
    # without the directory: the random init, not the files
    monkeypatch.setenv("PRETRAINED", str(tmp_path / "absent"))
    other = _lpips_algorithm().lpips_module
    assert not torch.equal(other.vgg.conv0.weight, algo.lpips_module.vgg.conv0.weight)
    assert torch.equal(other.lin0.weight, torch.ones_like(other.lin0.weight))
    (tmp_path / "lpips" / LPIPS_LIN_FILE).unlink()
    monkeypatch.setenv("PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=LPIPS_LIN_FILE):
        _lpips_algorithm()


# -- CLIP visual tower ----------------------------------------------------------


def _clip_shapes(proj: int | None):
    n = (SIZE // PATCH) ** 2 + 1
    shapes = {"visual.conv1.weight": (D, 3, PATCH, PATCH), "visual.class_embedding": (D,),
              "visual.positional_embedding": (n, D), "visual.ln_pre.weight": (D,), "visual.ln_pre.bias": (D,),
              "visual.ln_post.weight": (D,), "visual.ln_post.bias": (D,)}
    if proj:
        shapes["visual.proj"] = (D, proj)
    for i in range(DEPTH):
        p = f"visual.transformer.resblocks.{i}"
        shapes.update({f"{p}.ln_1.weight": (D,), f"{p}.ln_1.bias": (D,), f"{p}.ln_2.weight": (D,),
                       f"{p}.ln_2.bias": (D,), f"{p}.attn.in_proj_weight": (3 * D, D),
                       f"{p}.attn.in_proj_bias": (3 * D,), f"{p}.attn.out_proj.weight": (D, D),
                       f"{p}.attn.out_proj.bias": (D,), f"{p}.mlp.c_fc.weight": (4 * D, D),
                       f"{p}.mlp.c_fc.bias": (4 * D,), f"{p}.mlp.c_proj.weight": (D, 4 * D),
                       f"{p}.mlp.c_proj.bias": (D,)})
    return shapes


@pytest.mark.parametrize("proj", [16, None])
def test_clip_visual_matches_jax(proj):
    sd = _fake(_clip_shapes(proj), 6)
    cfg = dict(type="CLIPTeacher", patch_size=PATCH, proj_dim=proj, embed_dim=D, depth=DEPTH, num_heads=HEADS)
    u8 = np.random.default_rng(7).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    want = JaxTeacherRegistry.build(dict(cfg)).apply(
        {"params": jax_converters.convert_clip_visual(sd, num_heads=HEADS)}, jnp.asarray(u8), return_2d=True)
    port = _load(TeacherRegistry.build({**cfg, "img_size": SIZE}), converters.convert_clip_visual(sd, HEADS))
    _close(port(torch.from_numpy(u8), return_2d=True), want, f"clip proj={proj}")
    # the tower's own names (no ``visual.``) and torch tensors give the same dict
    bare = converters.convert_clip_visual(_torch({k[len("visual."):]: v for k, v in sd.items()}), HEADS)
    assert all(torch.equal(bare[k], v) for k, v in port.state_dict().items())


# -- GPT-2 and Llama --------------------------------------------------------------

VOCAB, MAX_LEN = 40, 16


def _gpt2_shapes():
    shapes = {"transformer.wte.weight": (VOCAB, D), "transformer.wpe.weight": (MAX_LEN, D),
              "transformer.ln_f.weight": (D,), "transformer.ln_f.bias": (D,)}
    for i in range(DEPTH):
        p = f"transformer.h.{i}"
        shapes.update({f"{p}.ln_1.weight": (D,), f"{p}.ln_1.bias": (D,), f"{p}.ln_2.weight": (D,),
                       f"{p}.ln_2.bias": (D,), f"{p}.attn.c_attn.weight": (D, 3 * D),
                       f"{p}.attn.c_attn.bias": (3 * D,), f"{p}.attn.c_proj.weight": (D, D),
                       f"{p}.attn.c_proj.bias": (D,), f"{p}.mlp.c_fc.weight": (D, 4 * D),
                       f"{p}.mlp.c_fc.bias": (4 * D,), f"{p}.mlp.c_proj.weight": (4 * D, D),
                       f"{p}.mlp.c_proj.bias": (D,)})
    return shapes


def _tokens(seed, b=2, t=MAX_LEN):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


def test_gpt2_matches_jax():
    sd = _fake(_gpt2_shapes(), 8)
    widths = dict(vocabulary_size=VOCAB, hidden_size=D, num_layers=DEPTH, num_heads=HEADS, max_length=MAX_LEN)
    tokens = _tokens(9)
    want = JaxGPT2(**widths).apply({"params": jax_converters.convert_gpt2(sd)}, jnp.asarray(tokens))
    port = _load(GPT2Transformer(**widths), converters.convert_gpt2(sd))
    with torch.no_grad():
        _close(port(torch.from_numpy(tokens)), want, "gpt2 logits")


FFN = 64


def _llama_shapes(head: bool):
    shapes = {"model.embed_tokens.weight": (VOCAB, D), "model.norm.weight": (D,)}
    if head:
        shapes["lm_head.weight"] = (VOCAB, D)
    for i in range(DEPTH):
        p = f"model.layers.{i}"
        shapes.update({f"{p}.input_layernorm.weight": (D,), f"{p}.post_attention_layernorm.weight": (D,),
                       **{f"{p}.self_attn.{n}_proj.weight": (D, D) for n in "qkvo"},
                       f"{p}.mlp.gate_proj.weight": (FFN, D), f"{p}.mlp.up_proj.weight": (FFN, D),
                       f"{p}.mlp.down_proj.weight": (D, FFN)})
    return shapes


def test_hf_llama_matches_jax():
    sd = _fake(_llama_shapes(head=True), 10)
    widths = dict(vocabulary_size=VOCAB, hidden_size=D, num_layers=DEPTH, num_heads=HEADS, ffn_dim=FFN,
                  max_length=MAX_LEN)
    tokens = _tokens(11)
    want = JaxLlama(**widths).apply({"params": jax_converters.convert_hf_llama(sd)}, jnp.asarray(tokens))
    port = _load(LlamaTransformer(**widths), converters.convert_hf_llama(sd))
    with torch.no_grad():
        _close(port(torch.from_numpy(tokens)), want, "llama logits")
    headless = converters.convert_hf_llama(_fake(_llama_shapes(head=False), 10))
    assert "lm_head" not in headless and set(headless) == set(port.state_dict()) - {"lm_head"}


# -- BEiT-v2 VQ-KD ----------------------------------------------------------------

EMBED, K, GRID = 8, 16, SIZE // PATCH


def _beit_half(prefix, task, in_ch, patch, n, out):
    shapes = {f"{prefix}.cls_token": (1, 1, D), f"{prefix}.pos_embed": (1, n + 1, D),
              f"{prefix}.patch_embed.proj.weight": (D, in_ch, patch, patch), f"{prefix}.patch_embed.proj.bias": (D,),
              f"{prefix}.fc_norm.weight": (D,), f"{prefix}.fc_norm.bias": (D,),
              f"{task}.0.weight": (D, D), f"{task}.0.bias": (D,), f"{task}.2.weight": (out, D), f"{task}.2.bias": (out,)}
    for i in range(DEPTH):
        p = f"{prefix}.blocks.{i}"
        shapes.update({f"{p}.norm1.weight": (D,), f"{p}.norm1.bias": (D,), f"{p}.norm2.weight": (D,),
                       f"{p}.norm2.bias": (D,), f"{p}.attn.qkv.weight": (3 * D, D), f"{p}.attn.q_bias": (D,),
                       f"{p}.attn.v_bias": (D,), f"{p}.attn.proj.weight": (D, D), f"{p}.attn.proj.bias": (D,),
                       f"{p}.mlp.fc1.weight": (4 * D, D), f"{p}.mlp.fc1.bias": (4 * D,),
                       f"{p}.mlp.fc2.weight": (D, 4 * D), f"{p}.mlp.fc2.bias": (D,)})
    return shapes


def _beit_model_cfg():
    vit = dict(embed_dim=D, depth=DEPTH, num_heads=HEADS)
    return dict(
        type="AutoencoderModel",
        encoder=dict(type="ViTEncoder", img_size=SIZE, patch_size=PATCH, out_channels=EMBED, **vit),
        quantizer=dict(type="VectorQuantizer", codebook_size=K, embedding_dim=EMBED, distance="cosine",
                       normalize_inputs=True),
        pre_decode=dict(type="ConvConnector", out_channels=EMBED),
        decoder=dict(type="ViTDecoder", img_size=GRID, patch_size=1, in_channels=EMBED, out_channels=24, **vit),
    )


def test_beit_vqkd_matches_jax():
    shapes = {**_beit_half("encoder", "encode_task_layer", 3, PATCH, GRID**2, EMBED),
              **_beit_half("decoder", "decode_task_layer", EMBED, 1, GRID**2, 24),
              "quantize.embedding.weight": (K, EMBED), "post_quant_conv.weight": (EMBED, EMBED, 1, 1),
              "post_quant_conv.bias": (EMBED,)}
    sd = _fake(shapes, 12)
    image = _images(13)
    jmodel = JaxModelRegistry.build(_beit_model_cfg())
    want = jmodel.apply({"params": jax_converters.convert_beit_vqkd(sd)}, jnp.asarray(image))
    port = _load(ModelRegistry.build(_beit_model_cfg(), device="cpu"), converters.convert_beit_vqkd(sd))
    with torch.no_grad():
        got = port(torch.from_numpy(image))
    _close(got["quantizer"].z, want["quantizer"].z, "beit z")
    assert np.array_equal(got["quantizer"].codes.numpy(), np.asarray(want["quantizer"].codes))
    _close(got["pred"], want["pred"], "beit pred")
    # a Linear post_quant_conv is the 1x1 conv; without the decoder, the encoder half only
    linear = dict(sd, **{"post_quant_conv.weight": sd["post_quant_conv.weight"][:, :, 0, 0]})
    assert torch.equal(converters.convert_beit_vqkd(linear)["pre_decode.conv.weight"],
                       port.state_dict()["pre_decode.conv.weight"])
    enc = converters.convert_beit_vqkd(sd, with_decoder=False)
    assert not any(k.startswith("decoder.") for k in enc) and "encoder.backbone.task2.weight" in enc
