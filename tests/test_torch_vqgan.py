"""The port's VQGAN tokenizer against the JAX package, at test widths:
each layer, the encoder and decoder, and the whole ``AutoencoderModel``
(encode_to_quant, decode_from_quant, forward), built from the same config
through each package's registry. JAX params come from ``init`` (perturbed
so no bias is 0 and no norm scale 1) and reach the port through the bridge;
inputs are made with numpy. Outputs agree within 1e-4 of max|ref| (f32,
another summation order in the convolutions and GroupNorm's E[x²]−E[x]²),
codes by the lookup's near-tie rule."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vector_quantization_tpu.models  # noqa: F401  (registers the JAX classes)
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.data.base import pixel_decode as jax_pixel_decode
from vector_quantization_tpu.data.base import pixel_encode as jax_pixel_encode
from vector_quantization_tpu.models import connectors as jax_connectors
from vector_quantization_tpu.models import layers as jax_layers
from vector_quantization_tpu.models.autoencoders import vqgan as jax_vqgan
from vector_quantization_tpu.registries import ModelRegistry as JaxModelRegistry
from vector_quantization_tpu.utils.config import Config as JaxConfig
from vector_quantization_tpu_torch.data.base import pixel_decode, pixel_encode
from vector_quantization_tpu_torch.models import connectors, layers
from vector_quantization_tpu_torch.models.autoencoders import vqgan
from vector_quantization_tpu_torch.ops.distances import normalize
from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes
from vector_quantization_tpu_torch.registries import ModelRegistry
from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes, state_dict_from_flax
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
LLAMAGEN_VQGAN = str(REPO / "configs/llamagen/vqgan_imagenet_ddp.py")
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _flax_params(module, *inputs, seed=0):
    """``init`` params as numpy, each leaf moved by N(0, 0.05²)."""
    params = module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs)).get("params", {})
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0.0, 0.05, p.shape).astype(np.float32), params
    )


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(module, params))
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


_LAYERS = [
    ("groupnorm_32_groups", jax_layers.GroupNorm32(), layers.GroupNorm32(64), (2, 4, 4, 64)),
    ("groupnorm_c_groups", jax_layers.GroupNorm32(), layers.GroupNorm32(24), (2, 4, 4, 24)),
    ("resblock_shortcut", jax_layers.ResBlock(32), layers.ResBlock(16, 32), (2, 8, 8, 16)),
    ("resblock", jax_layers.ResBlock(32), layers.ResBlock(32, 32), (2, 8, 8, 32)),
    ("attnblock", jax_layers.AttnBlock(), layers.AttnBlock(32), (2, 4, 4, 32)),
    ("downsample", jax_layers.Downsample(), layers.Downsample(16), (2, 8, 8, 16)),
    ("downsample_odd", jax_layers.Downsample(), layers.Downsample(16), (2, 7, 7, 16)),
    ("upsample", jax_layers.Upsample(), layers.Upsample(16), (2, 4, 4, 16)),
    ("identity_connector", jax_connectors.IdentityConnector(8, 8), connectors.IdentityConnector(8, 8),
     (2, 4, 4, 8)),
    ("composed_connectors",
     jax_connectors.ComposedConnector((jax_connectors.ConvConnector(16), jax_connectors.ConvConnector(8, 3))),
     connectors.ComposedConnector((connectors.ConvConnector(8, 16), connectors.ConvConnector(16, 8, 3))),
     (2, 4, 4, 8)),
]


@pytest.mark.parametrize("name,jax_module,port_module,shape", _LAYERS, ids=[c[0] for c in _LAYERS])
def test_layer_matches_jax(name, jax_module, port_module, shape):
    x = _randn(shape, seed=len(name))
    params = _flax_params(jax_module, x)
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(port_module, params)(_nchw(x)).permute(0, 2, 3, 1)
    _assert_close(got, want)


def test_upsample_nearest_equals_jax_resize():
    x = _randn((2, 5, 3, 4), seed=1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), method="nearest"))
    got = F.interpolate(_nchw(x), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


_ENC = dict(width=32, out_channels=8, width_mults=(1, 2), depth_mult=1)
_DEC = dict(width=32, in_channels=8, width_mults=(2, 1), depth_mult=1)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_decoder_match_jax(part):
    if part == "encoder":
        jm, pm, x = jax_vqgan.VQGANEncoder(**_ENC), vqgan.VQGANEncoder(**_ENC), _randn((2, 32, 32, 3), 3)
    else:
        jm, pm, x = jax_vqgan.VQGANDecoder(**_DEC), vqgan.VQGANDecoder(**_DEC), _randn((2, 16, 16, 8), 4)
    params = _flax_params(jm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(pm, params)(_nchw(x)).permute(0, 2, 3, 1)
    _assert_close(got, want)


_MODELS = {
    "vqgan": dict(
        type="AutoencoderModel",
        encoder=dict(type="VQGANEncoder", **_ENC),
        quantizer=dict(type="VectorQuantizer", codebook_size=64, embedding_dim=8,
                       normalize_inputs=True, losses=dict(vqgan=dict(beta=0.25))),
        decoder=dict(type="VQGANDecoder", **_DEC),
    ),
    # connector widths inferred from the neighbours by build_pre_hook
    "connectors": dict(
        type="AutoencoderModel",
        encoder=dict(type="VQGANEncoder", **{**_ENC, "out_channels": 16}),
        post_encode=dict(type="ConvConnector"),
        quantizer=dict(type="VectorQuantizer", codebook_size=64, embedding_dim=8,
                       losses=dict(vqgan=dict(beta=0.25))),
        pre_decode=dict(type="ConvConnector"),
        decoder=dict(type="VQGANDecoder", **{**_DEC, "in_channels": 16}),
    ),
}


@pytest.fixture(scope="module", params=sorted(_MODELS))
def autoencoders(request):
    cfg = _MODELS[request.param]
    jax_model = JaxModelRegistry.build(copy.deepcopy(cfg))
    x = _randn((2, 32, 32, 3), seed=5)
    params = _flax_params(jax_model, x)
    port = _load(ModelRegistry.build(copy.deepcopy(cfg), device="cpu"), params)
    return jax_model, {"params": params}, port, x


def _jax_call(model, variables, x, method=None):
    return model.apply(variables, jnp.asarray(x), method=method)


def _near_tie_check(port, feat, got, want):
    q = port.quantizer
    x = normalize(feat.reshape(-1, feat.shape[-1])) if q.normalize_inputs else feat.reshape(-1, feat.shape[-1])
    rep = compare_codes(x, q.effective_codebook().detach(), got, want)
    assert rep["ok"], rep
    return rep


def test_autoencoder_encode_to_quant(autoencoders):
    jax_model, variables, port, x = autoencoders
    want = np.array(_jax_call(jax_model, variables, x, jax_model.encode_to_quant))
    with torch.no_grad():
        got = port.encode_to_quant(torch.from_numpy(x))
        feat = port.encode(torch.from_numpy(x))
    assert got.shape == (2, 16, 16) and got.dtype in (torch.int32, torch.int64)
    _near_tie_check(port, feat, got, torch.from_numpy(want))


def test_autoencoder_decode_from_quant(autoencoders):
    jax_model, variables, port, x = autoencoders
    codes = np.random.default_rng(6).integers(0, 64, (2, 16, 16)).astype(np.int32)
    want = _jax_call(jax_model, variables, codes, jax_model.decode_from_quant)
    with torch.no_grad():
        got = port.decode_from_quant(torch.from_numpy(codes))
    assert got.shape == (2, 32, 32, 3)
    _assert_close(got, want)


def test_autoencoder_forward(autoencoders):
    jax_model, variables, port, x = autoencoders
    want = _jax_call(jax_model, variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _assert_close(got["feat"], want["feat"])
    q, jq = got["quantizer"], want["quantizer"]
    _near_tie_check(port, got["feat"], q.codes.reshape(-1), torch.from_numpy(np.array(jq.codes)).reshape(-1))
    same = q.codes.numpy() == np.asarray(jq.codes)
    np.testing.assert_allclose(q.z.numpy()[same], np.asarray(jq.z)[same], rtol=0, atol=1e-5)
    assert set(q.losses) == set(jq.losses) == {"loss_vqgan"}
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * max(1.0, abs(float(want["loss"])))
    # the reconstruction of the port's own codes (a near-tie may pick
    # another code than JAX's)
    want_pred = _jax_call(jax_model, variables, q.codes.numpy(), jax_model.decode_from_quant)
    _assert_close(got["pred"], want_pred)


def test_flax_param_shapes_match_flax_init(autoencoders):
    _, variables, port, _ = autoencoders
    want = jax.tree_util.tree_map(lambda p: tuple(p.shape), variables["params"])
    assert flax_param_shapes(port) == want


def test_bridge_consumes_every_leaf():
    enc = jax_vqgan.VQGANEncoder(**_ENC)
    params = _flax_params(enc, _randn((1, 32, 32, 3), 7))
    port = vqgan.VQGANEncoder(**_ENC)
    extra = {**params, "backbone": {**params["backbone"], "stray": {"kernel": np.zeros(3)}}}
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_flax(port, extra)
    missing = {**params, "backbone": {k: v for k, v in params["backbone"].items() if k != "proj_out"}}
    with pytest.raises(KeyError, match="proj_out"):
        state_dict_from_flax(port, missing)
    sd = state_dict_from_flax(port, params)
    assert set(sd) == set(port.state_dict())


def test_llamagen_config_builds_at_full_width():
    # the same model dict through both loaders; the port's build counts
    # the parameters flax would make, module by module (no forward)
    cfg = Config.load(LLAMAGEN_VQGAN)["trainer"]["algorithm"]["model"]
    jax_cfg = JaxConfig.load(LLAMAGEN_VQGAN)["trainer"]["algorithm"]["model"]
    assert cfg == jax_cfg
    port = ModelRegistry.build(copy.deepcopy(cfg), device="cpu")
    jax_model = JaxModelRegistry.build(copy.deepcopy(jax_cfg))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))
    want = {name: sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(sub))
            for name, sub in shapes["params"].items()}
    got = {name: sum(p.numel() for p in child.parameters()) for name, child in port.named_children()
           if child is not None}
    assert got == want == {"encoder": 28_155_144, "quantizer": 131_072, "decoder": 41_307_011}
    assert sum(got.values()) == 69_593_227


def test_every_config_file_loads_as_in_jax():
    # the port's copy of the loader: _base_ chains, _kwargs_, Config.load
    # inside config files, _export_ and _delete_
    files = sorted(REPO.glob("configs/**/*.py"))
    assert len(files) > 100
    for f in files:
        assert Config.load(str(f)) == JaxConfig.load(str(f)), f


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pixel_codec_matches_jax(kind):
    u8 = np.random.default_rng(8).integers(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    want = jax_pixel_encode(u8)
    x = u8 if kind == "numpy" else torch.from_numpy(u8)
    enc = pixel_encode(x)
    np.testing.assert_array_equal(np.asarray(enc), want)
    noisy = want + np.random.default_rng(9).normal(0, 0.3, want.shape).astype(np.float32)
    dec = pixel_decode(noisy if kind == "numpy" else torch.from_numpy(noisy))
    np.testing.assert_array_equal(np.asarray(dec), jax_pixel_decode(noisy))
    assert np.asarray(dec).dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(pixel_decode(enc)), u8)  # lossless round trip
