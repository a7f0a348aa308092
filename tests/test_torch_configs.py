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
and no arithmetic.
"""

from pathlib import Path

import pytest
import torch

import vector_quantization_tpu_torch  # noqa: F401  (registers the port's classes)
from vector_quantization_tpu_torch.ops.codebook import ANCHORS
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, MetricRegistry, VQRegistry
from vector_quantization_tpu_torch.training.optim import build_optimizer
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.py"))

# registry types the port does not have yet (ROADMAP.md queue A)
QUEUED = {
    "ClassificationAlgorithm",  # the linear probe
    "VQGANVQKDAlgorithm", "VQGANVQKDModel",  # the hybrid
    "COCODataset", "LAIONAestheticsDataset", "SAMed2DDataset", "SATINDataset",  # data/domains.py
}
QUEUED_OPTIMIZERS = {"lars"}  # the LARS optimizer (linear probe)
# registered, but building it raises: FID needs the Inception network
QUEUED_BUILDS = {"FIDMetric"}
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
    with pytest.raises(NotImplementedError, match="Metrics and CLI"):
        MetricRegistry.build(dict(type="FIDMetric"))


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
