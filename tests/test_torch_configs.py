"""Config coverage: every file under ``configs/`` loads with the port's
config loader, and every ``type`` it names resolves in the port, except
the types still queued (``QUEUED``, ROADMAP.md queue A), a list that must
shrink as the slices land: each entry must still be missing.

Registry types must resolve in the port's registry tree; the
``optimizer``/``d_optimizer`` entries (with their ``schedule``) must build
through ``training.optim.build_optimizer``; a ``codebook_update`` must name
an update and a CVQ anchor the port applies.

Then the configs of the tokenizer zoo's last slice (FSQ, SQ, GPT-2, the
resizing and ConvNeXt teachers, StyleGAN2, CVQ-VAE with each anchor) build
their algorithms at full width on the meta device: shapes only, no memory
and no arithmetic. The evaluation slice's configs build too: the linear
probe's (``configs/ic``), the six domain VQGAN and VQ-KD configs (the
algorithm on the meta device, both datasets over a folder of JPEGs written
here), ``configs/fid/interface.py`` over the synthetic dataset and
``configs/ar/generation_eval.py`` with its ``FIDMetric`` and
``AccuracyMetric``. The VQGAN + VQ-KD hybrid, which no shipped config
names, builds at the full width ``chip_smoke.py`` trains it at.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import vector_quantization_tpu_torch  # noqa: F401  (registers the port's classes)
from vector_quantization_tpu_torch.ops.codebook import ANCHORS
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, DatasetRegistry, MetricRegistry, VQRegistry
from vector_quantization_tpu_torch.training.optim import build_optimizer
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.py"))

# registry types the port does not have yet (ROADMAP.md queue A): none since
# the hybrid's (VQGANVQKDAlgorithm, VQGANVQKDModel)
QUEUED: set[str] = set()
QUEUED_OPTIMIZERS: set[str] = set()
# registered, but building it raises
QUEUED_BUILDS: set[str] = set()
UPDATES = {"normalize", "kmeans", "cvq"}
NOT_REGISTRY = {"optimizer", "d_optimizer", "schedule", "codebook_update"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _typed(node, key=""):
    """(the key a typed dict sits under, the dict) for every dict with a
    ``type``, depth first."""
    if isinstance(node, dict):
        if isinstance(node.get("type"), str):
            yield key, node
        for k, v in node.items():
            yield from _typed(v, k)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _typed(v, key)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_types_resolve_in_the_port(path):
    cfg = Config.load(str(REPO / path))
    known = set(VQRegistry.keys())
    for key, node in _typed(dict(cfg)):
        kind = node["type"]
        if key in ("optimizer", "d_optimizer"):
            paths = ["encoder/kernel", "quantizer/codebook"]  # an ``exclude`` mask needs paths
            if kind in QUEUED_OPTIMIZERS:
                with pytest.raises(NotImplementedError):
                    build_optimizer(dict(node), paths)
            else:
                build_optimizer(dict(node), paths)
        elif key == "codebook_update":
            assert kind in UPDATES, (path, kind)
            assert node.get("anchor", "nearest") in ANCHORS, (path, node)
        elif key not in NOT_REGISTRY:
            assert kind in known or kind in QUEUED, (path, key, kind)


def test_the_queued_list_is_still_missing():
    known = set(VQRegistry.keys())
    assert not QUEUED & known, QUEUED & known
    assert QUEUED_BUILDS <= known
    for kind in QUEUED_BUILDS:
        with pytest.raises(NotImplementedError):
            MetricRegistry.build(dict(type=kind))


SLICE = [
    ("configs/fsq/8000_imagenet_ddp.py", {}, "FiniteScalarQuantizer"),
    ("configs/fsq/64000_imagenet_ddp.py", {}, "FiniteScalarQuantizer"),
    ("configs/fsq/interface.py", {}, "FiniteScalarQuantizer"),
    ("configs/sq/interface.py", {}, "ScalarQuantizer"),
    ("configs/ar/c2i_gpt2_medium_imagenet_ddp.py", {}, "GPT2Transformer"),
    ("configs/ar/c2i_gpt2_medium_cfg_imagenet_ddp.py", {}, "GPT2Transformer"),
    ("configs/vqkd/convnext_8192_imagenet_ddp.py", {}, "ConvNeXtTeacher"),
    ("configs/vqkd/evaclip_8192_imagenet_ddp.py", {}, "CLIPTeacher"),
    ("configs/vqkd/openclip_L_14_8192_imagenet_ddp.py", {}, "CLIPTeacher"),
    ("configs/vqkd/openclip_bigG_14_8192_imagenet_ddp.py", {}, "CLIPTeacher"),
    ("configs/vqgan/8192_stylegan2_imagenet_ddp.py", {}, "StyleGAN2Discriminator"),
    ("configs/llamagen/vqgan_stylegan2_imagenet_ddp.py", {}, "StyleGAN2Discriminator"),
    *[("configs/cvqvae/interface.py", {"anchor": a}, a) for a in ("nearest", "multinomial", "random", "cached")],
]


@pytest.mark.parametrize("path,kwargs,what", SLICE, ids=[f"{p.split('/', 1)[1]}-{w}" for p, _, w in SLICE])
def test_slice_config_builds_at_full_width(path, kwargs, what):
    cfg = Config.load(str(REPO / path), **kwargs)["trainer"]["algorithm"]
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(cfg, device="meta")
    if what in ("FiniteScalarQuantizer", "ScalarQuantizer"):
        q = algo.model.quantizer
        assert type(q).__name__ == what and q.embedding_dim == len(q.levels)
        assert algo.model.post_encode.conv.out_channels == q.embedding_dim
    elif what == "GPT2Transformer":
        t = algo.model
        assert type(t).__name__ == what and (t.hidden_size, t.num_layers, t.num_heads) == (1024, 24, 16)
        # 1000 classes (+ the uncondition token with CFG) + 16384 codes
        assert (t.vocabulary_size, t.max_length, t.dtype) == (17384 + (algo.cfg is not None), 257, torch.float32)
        assert not algo._use_fused()
    elif what in ("ConvNeXtTeacher", "CLIPTeacher"):
        assert type(algo.teacher).__name__ == what
        assert algo.teacher.output_size in (None, 14)
        assert algo.model.decoder.out_channels == algo.teacher.out_channels
    elif what == "StyleGAN2Discriminator":
        assert type(algo.discriminator).__name__ == what and not list(algo.discriminator.buffers())
    else:
        assert algo.codebook_update["anchor"] == what


DOMAIN_CONFIGS = [f"configs/{kind}/{prefix}_{domain}_ddp.py" for kind, prefix in (("vqgan", "8192"),
                                                                                   ("vqkd", "clip_8192"))
                  for domain in ("laion_aesthetics", "sa_med2d_20m", "satin")]


@pytest.mark.parametrize("path", DOMAIN_CONFIGS)
def test_domain_config_builds(tmp_path, path):
    for i in range(3):
        Image.fromarray(np.full((40, 48, 3), 40 * i, np.uint8)).save(tmp_path / f"{i}.jpg")
    cfg = Config.load(str(REPO / path))
    for split, n in (("trainer", 0), ("validator", 3)):  # the 25,000-image val carve-out takes all 3
        node = cfg[split]["dataset"]
        node = node.get("dataset", node)  # SA-Med2D and SATIN split a folder dataset
        node["root"] = str(tmp_path)
        dataset = DatasetRegistry.build(cfg[split]["dataset"])
        assert type(dataset).__name__ in ("LAIONAestheticsDataset", "SplitDataset") and len(dataset) == n
    assert dataset[0].category == 0
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(cfg["trainer"]["algorithm"], device="meta")
    assert algo.model.quantizer.codebook_size == 8192


@pytest.mark.parametrize("path", ["configs/ic/interface.py", "configs/ic/imagenet_ddp.py"])
def test_probe_config_builds_at_full_width(path):
    cfg = Config.load(str(REPO / path))
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(cfg["trainer"]["algorithm"], device="meta")
    assert type(algo).__name__ == "ClassificationAlgorithm" and algo.tx().kind == "lars"
    assert set(cfg["validator"]["metrics"]) == {"accuracy"}


def test_fid_config_builds_over_synthetic():
    cfg = Config.load(str(REPO / "configs/fid/interface.py"), dataset="synthetic")
    dataset = DatasetRegistry.build(cfg["validator"]["dataset"])
    assert type(dataset).__name__ == "SyntheticDataset" and cfg["validator"]["fid_batch_size"] == 128


def test_generation_eval_config_builds_its_metrics():
    cfg = Config.load(str(REPO / "configs/ar/generation_eval.py"))["validator"]
    metrics = {name: MetricRegistry.build(m, dataset=None) for name, m in cfg["metrics"].items()}
    assert metrics["fid"].pred == "generated_image" and metrics["fid"].random_init
    assert type(metrics["accuracy"]).__name__ == "AccuracyMetric"
    assert cfg["algorithm"]["eval_generate"] is True


def test_hybrid_builds_at_full_width():
    """The full-width hybrid ``chip_smoke.py`` trains (no shipped config
    names it): the LlamaGen VQGAN (16384 x 8, 256 px) with VQ-KD's
    3-block decoder to 512 features on its 16 x 16 grid and the CLIP
    ViT-B/16 teacher (224 px, 14 x 14 resized to 16 x 16), on the meta
    device."""
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_config")
    cfg = smoke["hybrid_config"]()
    with torch.device("meta"):
        algo = AlgorithmRegistry.build(cfg, device="meta")
    model, teacher = algo.model, algo.teacher
    assert type(model).__name__ == "VQGANVQKDModel" and tuple(model.quantizer.codebook.shape) == (16384, 8)
    assert algo.codebook_update == {"type": "normalize"}  # the LlamaGen config's own
    dec = model.vqkd_decoder
    assert (dec.in_channels, dec.out_channels) == (32, 512) == (model.vqkd_pre_decode.conv.out_channels,
                                                                 teacher.out_channels)
    assert (teacher.image_size, teacher.output_size, teacher.backbone.pos_embed.shape[1]) == (224, 16, 197)
    branch = sum(p.numel() for n, p in model.named_parameters() if n.startswith("vqkd_"))
    assert (sum(p.numel() for p in model.parameters()) - branch, branch) == (69_593_227,
                                                                            smoke["HYBRID_BRANCH_PARAMS"])
