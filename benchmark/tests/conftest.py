"""Test helpers: a copy of the checkout with tiny cells, run on the CPU.

``tiny_root`` copies ``BENCHMARK.json`` and ``benchmark/`` into a
temporary directory and adds, as new files only, tiny versions of the
three cells (``tiny_ar``, ``tiny_export``, ``tiny_vqgan``): the same
drivers and references at a few dozen channels and 32 px images, with the
cells' own limits. ``BENCHMARK.json`` gains their entries.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SEED = 2 ** 31 + 12345
IR = {"codebook_size": 64, "embedding_dim": 8, "width": 32, "enc_width_mults": [1, 2], "enc_depth": 1,
      "dec_width_mults": [2, 1], "dec_depth": 1}
IR_MODEL = {"type": "AutoencoderModel",
            "encoder": {"type": "VQGANEncoder", "width": 32, "out_channels": 8, "width_mults": [1, 2],
                        "depth_mult": 1},
            "quantizer": {"type": "VectorQuantizer", "codebook_size": 64, "embedding_dim": 8,
                          "normalize_inputs": True, "losses": {"vqgan": {"beta": 0.25}}},
            "decoder": {"type": "VQGANDecoder", "width": 32, "in_channels": 8, "width_mults": [2, 1],
                        "depth_mult": 1}}
TINY = {  # cell: (the full cell it shrinks, config, traffic)
    "tiny_ar": ("gpt2m_c2i_train_images_b64", "tiny_gpt2", "tiny_b4"),
    "tiny_export": ("vqgan_tencrop_export", "tiny_vqgan", "tiny_crop"),
    "tiny_vqgan": ("vqgan_train_gan_b12", "tiny_vqgan", "tiny_b4"),
}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_root(dst: Path) -> Path:
    """A checkout with the tiny cells added as new files."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = dst / "benchmark"
    g = json.loads((b / "configs/gpt2_medium_c2i.json").read_text())
    g.update(n_embd=64, n_layer=2, n_head=4, vocab_size=74, n_positions=257, num_categories=10, ir=IR)
    g["algorithm"].update(transformer={"type": "GPT2Transformer", "hidden_size": 64, "num_layers": 2,
                                       "num_heads": 4}, ir=IR_MODEL, num_categories=10, image_size=32)
    _dump(g, b / "configs/tiny_gpt2.json")
    v = json.loads((b / "configs/vqgan_f16_c16384.json").read_text())
    v.update(IR, model=IR_MODEL)
    v["algorithm"]["model"] = IR_MODEL
    _dump(v, b / "configs/tiny_vqgan.json")
    _dump({"batch": 4, "image_size": 32, "classes": 10, "items_per_second": 20, "extra_items": 3},
          b / "traffic/tiny_b4.json")
    _dump({"batch": 1, "image_size": 20, "crop": 16, "classes": 10, "items_per_second": 50, "extra_items": 3},
          b / "traffic/tiny_crop.json")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for name, (full, cfg, traffic) in TINY.items():
        w = json.loads((b / f"workloads/{full}.json").read_text())
        w.update(config=cfg, traffic=traffic)
        _dump(w, b / f"workloads/{name}.json")
        spec["workloads"].append({"name": name, "config": cfg, "traffic": traffic, "chips": 1, "why": "tiny"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if full in m.get("workloads", []):
                m["workloads"].append(name)
    _dump(spec, dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
