"""Package boundaries of the port: it imports neither JAX nor the JAX
package, runs on CUDA unless asked for the CPU, and counts a kernel launch
only where a kernel launches."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vector_quantization_tpu_torch
from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
from vector_quantization_tpu_torch.ops import flash_attention as fa
from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_w8a8, int8_mm
from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention
from vector_quantization_tpu_torch.ops.vq_lookup import nearest_codes, vq_quantize
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, ModelRegistry
from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook, pack_c2i_tokens
from vector_quantization_tpu_torch.tasks.serving import ARServer
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, runpy, sys
import vector_quantization_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
runpy.run_path("chip_smoke.py", run_name="not_main")
bad = [k for k in sys.modules if k in ("jax", "jaxlib", "flax", "vector_quantization_tpu", "tools", "tests")
       or k.startswith(("vector_quantization_tpu.", "tools.", "tests."))]
print("LOADED", bad)
"""

TOOLS = ["tokenize_llamagen", "visualize_patches", "golden_eval", "record_published", "fid", "fidelity",
         "model_ema", "convert_weights", "prepare_checkpoints"]

_TOOL_PROBE = """
import runpy, sys
sys.argv = [{name!r}, "--help"]
try:
    runpy.run_module("vector_quantization_tpu_torch.tools." + {name!r}, run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
bad = [k for k in sys.modules if k in ("jax", "jaxlib", "flax", "vector_quantization_tpu", "tools", "tests")
       or k.startswith(("vector_quantization_tpu.", "tools.", "tests."))]
print("LOADED", bad)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_no_jax_or_jax_package_imported():
    # a fresh interpreter: this test process has JAX loaded already
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_all_submodules_listed():
    names = {m.name for m in pkgutil.walk_packages(
        vector_quantization_tpu_torch.__path__, "vector_quantization_tpu_torch.")}
    assert {
        "vector_quantization_tpu_torch.ops.int8_matmul",
        "vector_quantization_tpu_torch.ops.paged_attention",
        "vector_quantization_tpu_torch.ops.paged_kv",
        "vector_quantization_tpu_torch.models.transformers.llama",
        "vector_quantization_tpu_torch.models.transformers.sampling",
        "vector_quantization_tpu_torch.tasks.serving",
        "vector_quantization_tpu_torch.tasks.sequence_modeling",
        "vector_quantization_tpu_torch.utils.bridge",
        "vector_quantization_tpu_torch.utils.registry",
        "vector_quantization_tpu_torch.registries",
        "vector_quantization_tpu_torch.ops.vq_lookup",
        "vector_quantization_tpu_torch.ops.distances",
        "vector_quantization_tpu_torch.ops.losses",
        "vector_quantization_tpu_torch.ops.ste",
        "vector_quantization_tpu_torch.models.layers",
        "vector_quantization_tpu_torch.models.connectors",
        "vector_quantization_tpu_torch.models.quantizers.base",
        "vector_quantization_tpu_torch.models.quantizers.vq",
        "vector_quantization_tpu_torch.models.autoencoders.vqgan",
        "vector_quantization_tpu_torch.tasks.image_tokenization",
        "vector_quantization_tpu_torch.tasks.image_reconstruction",
        "vector_quantization_tpu_torch.data.base",
        "vector_quantization_tpu_torch.utils.config",
        "vector_quantization_tpu_torch.ops.flash_attention",
        "vector_quantization_tpu_torch.ops.fused_ce",
        "vector_quantization_tpu_torch.training.optim",
        "vector_quantization_tpu_torch.training.state",
        "vector_quantization_tpu_torch.algorithms.base",
        "vector_quantization_tpu_torch.algorithms.ar",
        "vector_quantization_tpu_torch.algorithms.vqgan",
        "vector_quantization_tpu_torch.models.losses.recon",
        "vector_quantization_tpu_torch.models.losses.gan",
        "vector_quantization_tpu_torch.models.losses.lpips",
        "vector_quantization_tpu_torch.models.discriminators.patchgan",
        "vector_quantization_tpu_torch.training.metrics",
        "vector_quantization_tpu_torch.data.datasets",
        "vector_quantization_tpu_torch.utils.converters",
        "vector_quantization_tpu_torch.utils.filters",
        "vector_quantization_tpu_torch.ops.codebook",
        "vector_quantization_tpu_torch.models.autoencoders.vit",
        "vector_quantization_tpu_torch.models.teachers.base",
        "vector_quantization_tpu_torch.models.teachers.vit",
        "vector_quantization_tpu_torch.models.teachers.encoder",
        "vector_quantization_tpu_torch.algorithms.vqkd",
        "vector_quantization_tpu_torch.utils.flags",
        "vector_quantization_tpu_torch.data.loader",
        "vector_quantization_tpu_torch.data.native",
        "vector_quantization_tpu_torch.parallel.mesh",
        "vector_quantization_tpu_torch.parallel.sharding",
        "vector_quantization_tpu_torch.training.checkpoints",
        "vector_quantization_tpu_torch.training.callbacks",
        "vector_quantization_tpu_torch.training.runner",
        "vector_quantization_tpu_torch.cli.common",
        "vector_quantization_tpu_torch.cli.train",
        "vector_quantization_tpu_torch.cli.test",
        "vector_quantization_tpu_torch.cli.tokenize",
        "vector_quantization_tpu_torch.cli.demo",
        "vector_quantization_tpu_torch.algorithms.exp_vqgan_vqkd",
        *(f"vector_quantization_tpu_torch.tools.{t}" for t in TOOLS),
    } <= names


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_as_a_module_without_jax(name):
    """``python -m vector_quantization_tpu_torch.tools.<name> --help`` in a
    fresh interpreter: it parses, and imports nothing of JAX, the JAX
    package, ``tools/`` or ``tests/``."""
    out = subprocess.run([sys.executable, "-c", _TOOL_PROBE.format(name=name)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout and "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("name,argv", [
    ("tokenize_llamagen", ["t", "configs/regression/golden_synthetic.py", "--out", "{tmp}/out"]),
    ("visualize_patches", ["t", "configs/regression/golden_synthetic.py", "--tokens", "0", "--out", "{tmp}/p.png"]),
    ("golden_eval", ["taming_vqgan", "--checkpoint", "{tmp}/missing.pth",
                     "--config", "configs/regression/golden_synthetic.py"]),
    ("record_published", ["--check", "--families", "synthetic_taming_vqgan", "--work-dir", "{tmp}/w"]),
    ("fid", ["--pred", "{tmp}", "--gt", "{tmp}"]),
    ("fidelity", ["--pred", "{tmp}"]),
])
def test_tools_without_a_gpu_fail_loudly(name, argv, tmp_path):
    """Without ``--device cpu`` each tool runs on CUDA: with no GPU it
    exits non-zero naming CUDA and writes no result."""
    cmd = [sys.executable, "-m", f"vector_quantization_tpu_torch.tools.{name}",
           *(a.format(tmp=tmp_path) for a in argv)]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr, (out.stdout, out.stderr[-2000:])
    assert not (tmp_path / "out").exists() and not (tmp_path / "p.png").exists()
    assert not (tmp_path / "w" / "published_torch.json").exists() and "FID=" not in out.stdout


def test_jax_log_converter_reads_the_ports_run_log(tmp_path, capsys):
    """``tools/convert_log_to_tensorboard.py`` (it imports nothing of
    either package) parses the ``run.log`` of the port's ``cli.train``:
    nothing to port."""
    from tests.test_tools import _run_tool
    from vector_quantization_tpu_torch.cli import train

    trainer = train.main(["smoke", str(REPO / "configs/vqgan/smoke.py"), "--work-dir", str(tmp_path / "w"),
                          "--device", "cpu"])
    lines = [ln for ln in (tmp_path / "w/run.log").read_text().splitlines() if "Iter [" in ln]
    assert len(lines) == trainer.max_iters == 5
    capsys.readouterr()
    _run_tool("convert_log_to_tensorboard.py", [str(tmp_path / "w/run.log"), str(tmp_path / "tb")])
    n_keys = len(lines[0].split("ETA ")[1].split()) - 1
    assert f"wrote {5 * n_keys} scalars" in capsys.readouterr().out and n_keys >= 5
    assert any("tfevents" in f for f in os.listdir(tmp_path / "tb"))


def test_server_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = LlamaTransformer(vocabulary_size=32, hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ARServer(tr, None, TokenCodebook(11, 16), image_tokens=4, batch_slots=2, paged=True)


def test_tokenizer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(
        type="AutoencoderModel",
        encoder=dict(type="VQGANEncoder", width=32, out_channels=8, width_mults=(1,), depth_mult=1),
        quantizer=dict(type="VectorQuantizer", codebook_size=16, embedding_dim=8),
        decoder=dict(type="VQGANDecoder", width=32, in_channels=8, width_mults=(1,), depth_mult=1),
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry.build(cfg)
    model = ModelRegistry.build(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_ar_algorithm_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.load(str(REPO / "configs/regression/ar_anchor.py"))["trainer"]["algorithm"]
    with pytest.raises(RuntimeError, match="CUDA"):
        AlgorithmRegistry.build(cfg)
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    devices = {p.device.type for p in [*algo.model.parameters(), *algo.ir_model.parameters()]}
    assert devices == {"cpu"}


def test_vqgan_algorithm_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.load(str(REPO / "configs/regression/smoke_anchor.py"))["trainer"]["algorithm"]
    cfg["recon_losses"] = dict(l1=dict(), lpips=dict(weight=1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        AlgorithmRegistry.build(cfg)
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    modules = (algo.model, algo.discriminator, algo.lpips_module)
    assert {t.device.type for m in modules for t in [*m.parameters(), *m.buffers()]} == {"cpu"}


@pytest.mark.parametrize("config", ["configs/vqkd/clip_8192_imagenet_ddp.py",
                                    "configs/cluster/clip_8192_imagenet_ddp.py"])
def test_vqkd_and_cluster_algorithms_default_to_cuda(monkeypatch, config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.load(str(REPO / config))["trainer"]["algorithm"]
    with pytest.raises(RuntimeError, match="CUDA"):
        AlgorithmRegistry.build(cfg)


def test_hybrid_algorithm_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.load(str(REPO / "configs/regression/smoke_anchor.py"))["trainer"]["algorithm"]
    cfg["type"] = "VQGANVQKDAlgorithm"
    cfg["model"] = dict(cfg["model"], type="VQGANVQKDModel", vqkd_pre_decode=dict(type="ConvConnector"),
                        vqkd_decoder=dict(type="ViTDecoder", img_size=16, patch_size=1, in_channels=8,
                                          out_channels=16, embed_dim=32, depth=1, num_heads=2))
    cfg["teacher"] = dict(type="PixelTeacher", patch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        AlgorithmRegistry.build(cfg)
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    modules = (algo.model, algo.discriminator, algo.teacher)
    assert {t.device.type for m in modules for t in [*m.parameters(), *m.buffers()]} == {"cpu"}


def test_cpu_calls_never_count_launches():
    k4 = (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    x = torch.ones(1, 5, 2, 32, requires_grad=True)
    fa.flash_attention(x, x, x).sum().backward()
    assert (fa.flash_attention_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == k4
    i0, a0, v0, m0 = int8_matmul.launches, paged_decode_attention.launches, nearest_codes.launches, int8_mm.calls
    x = torch.ones(2, 8)
    int8_matmul(x, torch.ones(8, 4, dtype=torch.int8), torch.full((4,), 0.5))
    int8_matmul_w8a8(x, torch.ones(8, 8, dtype=torch.int8), torch.full((8,), 0.5))
    pool = torch.zeros(1, 2, 4, 2, 8)
    paged_decode_attention(
        torch.ones(2, 2, 8), pool, pool, torch.zeros(2, 1, dtype=torch.int32),
        torch.ones(2, dtype=torch.int32), 0,
    )
    nearest_codes(torch.ones(3, 8), torch.ones(5, 8), "cosine")
    vq_quantize(torch.ones(3, 8), torch.ones(5, 8))
    assert (int8_matmul.launches, paged_decode_attention.launches, nearest_codes.launches,
            int8_mm.calls) == (i0, a0, v0, m0)


def test_pack_c2i_tokens():
    cb = TokenCodebook(start=11, size=16)
    codes = torch.from_numpy(np.arange(8).reshape(2, 2, 2))
    out = pack_c2i_tokens(torch.tensor([3, 4]), codes, cb)
    assert out.dtype == torch.int32
    assert out.tolist() == [[3, 11, 12, 13, 14], [4, 15, 16, 17, 18]]
    assert cb.debias(out[:, 1:]).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
