"""The code-grid cells' driver (``drivers/train_ar_codes.py``) end to end at
a tiny size on the CPU against its reference, for the GPT-2 and the
DeepSeek-V3 prior, and the check that decides ``correct`` failing on each
fault such a cell can have, planted in the program underneath a run: a
step that returns its state unchanged, half of each batch left out, one
code altered where the tokens are made (GPT-2), one token's routing
altered where the router chooses (DeepSeek-V3). Also the control script's
fault readings at that size, and the code-grid traffic's items.

The tiny checkout is ``conftest.make_root``'s with the two tiny code-grid
cells added as new files."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import codes, controls_codes, harness
from conftest import REPO, SEED, make_root

import vector_quantization_tpu_torch.algorithms.ar as ar_module
from vector_quantization_tpu_torch.algorithms.ar import ARAlgorithm
from vector_quantization_tpu_torch.models.transformers import deepseek_v3
from vector_quantization_tpu_torch.tasks.sequence_modeling import next_token_ce

REPO_BENCH = REPO / "benchmark"
# the tiny DeepSeek-V3: 1 dense + 4 MoE layers, 16 experts of which rank 1 holds 4, 3 a token
TINY_DEEPSEEK = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
                 "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 24,
                 "n_routed_experts": 4, "router_experts": 16, "num_experts_per_tok": 3, "n_shared_experts": 2,
                 "first_k_dense_replace": 1, "num_hidden_layers": 5, "vocab_size": 74, "max_position_embeddings": 17,
                 "expert_rank": 1, "num_categories": 10}
TINY_CELLS = {  # cell: (the full cell it shrinks, config)
    "tiny_gpt2_codes": ("gpt2m_c2i_train_codes_b64", "tiny_gpt2_codes"),
    "tiny_deepseek_codes": ("moonlight_c2i_train_codes_b64", "tiny_deepseek"),
}
IR = {"type": "AutoencoderModel",
      "encoder": {"type": "VQGANEncoder", "width": 16, "out_channels": 8, "width_mults": [1, 2], "depth_mult": 1},
      "quantizer": {"type": "VectorQuantizer", "codebook_size": 64, "embedding_dim": 8, "normalize_inputs": True,
                    "losses": {"vqgan": {"beta": 0.25}}},
      "decoder": {"type": "VQGANDecoder", "width": 16, "in_channels": 8, "width_mults": [2, 1], "depth_mult": 1}}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_codes_root(dst: Path) -> Path:
    """``make_root``'s checkout with the tiny code-grid cells: 4 grids of
    4 x 4 codes over 64 a step (17 tokens), 10 classes."""
    make_root(dst)
    b = dst / "benchmark"
    g = json.loads((b / "configs/tiny_gpt2.json").read_text())
    g["algorithm"]["ir"] = IR
    g["algorithm"]["image_size"] = 8
    g["n_positions"] = 17
    _dump(g, b / "configs/tiny_gpt2_codes.json")
    d = json.loads((b / "configs/moonlight_16b_a3b_c2i.json").read_text())
    d.update(TINY_DEEPSEEK)
    t = d["algorithm"]["transformer"]
    t.update(hidden_size=64, num_layers=5, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=24, n_routed_experts=16,
             num_experts_per_tok=3, experts_held=4, expert_rank=1)
    d["algorithm"].update(ir=IR, num_categories=10, image_size=8)
    _dump(d, b / "configs/tiny_deepseek.json")
    _dump({"batch": 4, "grid": 4, "codebook_size": 64, "classes": 10, "items_per_second": 20, "extra_items": 3},
          b / "traffic/tiny_codes.json")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for name, (full, cfg) in TINY_CELLS.items():
        w = json.loads((b / f"workloads/{full}.json").read_text())
        w.update(config=cfg, traffic="tiny_codes")
        _dump(w, b / f"workloads/{name}.json")
        spec["workloads"].append({"name": name, "config": cfg, "traffic": "tiny_codes", "chips": 1, "why": "tiny"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if full in m.get("workloads", []):
                m["workloads"].append(name)
    _dump(spec, dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="module")
def codes_root(tmp_path_factory) -> Path:
    return make_codes_root(tmp_path_factory.mktemp("codes_checkout"))


def run(root, cell, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", root)


@pytest.mark.parametrize("cell", list(TINY_CELLS))
def test_sound_run_is_correct(codes_root, cell):
    result, detail = run(codes_root, cell)
    assert result["correct"], (result["checks"], detail)
    assert result["attempted"] > 0 and result["failed"] == 0
    limits = harness.load_json(codes_root / "benchmark/workloads" / f"{cell}.json")["limits"]
    assert set(result["checks"]) == set(limits)


def _unchanged(self, state, batch):
    tokens = self._tokens(state, batch, train=True)
    with torch.no_grad():
        loss = next_token_ce(state.model(tokens), tokens)
    return state, {"loss": loss}


def _half(monkeypatch):
    orig = ARAlgorithm.train_step

    def half(self, state, batch):
        return orig(self, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(ARAlgorithm, "train_step", half)


def _altered_code(monkeypatch):
    orig = ar_module.pack_c2i_tokens

    def altered(category, codes, codebook):
        codes = codes.clone()
        codes.view(-1)[0] = (codes.view(-1)[0] + 7) % codebook.size
        return orig(category, codes, codebook)

    monkeypatch.setattr(ar_module, "pack_c2i_tokens", altered)


def _altered_route(monkeypatch):
    orig = deepseek_v3._MoE.route

    def altered(self, x):
        idx, w, s = orig(self, x)
        idx = idx.clone()
        chosen = set(idx[0].tolist())
        idx[0, 0] = next(e for e in range(self.num_experts) if e not in chosen)
        return idx, self.weigh(s, idx), s

    monkeypatch.setattr(deepseek_v3._MoE, "route", altered)


FAULTS = [
    ("tiny_gpt2_codes", "unchanged", lambda mp: mp.setattr(ARAlgorithm, "train_step", _unchanged)),
    ("tiny_gpt2_codes", "half_batch", _half),
    ("tiny_gpt2_codes", "altered_code", _altered_code),
    ("tiny_deepseek_codes", "unchanged", lambda mp: mp.setattr(ARAlgorithm, "train_step", _unchanged)),
    ("tiny_deepseek_codes", "half_batch", _half),
    ("tiny_deepseek_codes", "altered_route", _altered_route),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(codes_root, monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    result, detail = run(codes_root, cell, seconds=0.2)
    assert not result["correct"], (fault, result["checks"], detail)


@pytest.mark.parametrize("cell", list(TINY_CELLS))
def test_fault_readings_fail_at_tiny_size(codes_root, cell):
    limits = harness.load_json(codes_root / "benchmark/workloads" / f"{cell}.json")["limits"]
    got = controls_codes.readings(cell, SEED, "cpu", codes_root)
    altered = "altered_route" if cell == "tiny_deepseek_codes" else "altered_code"
    assert {r["reading"] for r in got} == {"control", "half_batch", altered}
    for r in got:
        if r["reading"] != "control":
            assert any(r[k] > v for k, v in limits.items()), r


def test_code_grid_items_depend_on_the_seed_and_index_alone():
    traffic = {"batch": 3, "grid": 4, "codebook_size": 64, "classes": 10, "items_per_second": 2, "extra_items": 1}
    short, long = codes.make_pool(traffic, SEED, 1.0, False), codes.make_pool(traffic, SEED, 3.0, False)
    assert len(short) == 3 and len(long) == 7
    assert torch.equal(short.images, long.images[:3]) and torch.equal(short.labels, long.labels[:3])
    assert short.images.dtype == torch.int32 and short.images.shape == (3, 3, 4, 4)
    assert int(long.images.min()) >= 0 and int(long.images.max()) < 64 and int(long.labels.max()) < 10
    other = codes.make_pool(traffic, SEED + 1, 1.0, False)
    assert not torch.equal(short.images, other.images)


def test_deepseek_step_count_equals_the_flop_counter():
    """``flops_codes.deepseek_step`` by hand against ``FlopCounterMode`` over
    the reference's step at the tiny configuration, on the rows its router
    sent to the held experts; and GPT-2's step as ``flops.py`` counts it."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import flops_codes
    from benchmark.reference import codes_steps as cs

    cfg = dict(json.loads((REPO_BENCH / "configs/moonlight_16b_a3b_c2i.json").read_text()), **TINY_DEEPSEEK)
    model = cs.build(cs.factory(cfg), "cpu", cs.weights(cfg, SEED, "cpu"), "deepseek.")
    tok = torch.randint(0, 74, (3, 17), generator=torch.Generator().manual_seed(8))
    with FlopCounterMode(display=False) as fc:
        logits, aux = model(tok)
        torch.autograd.grad(logits.square().mean() + aux["balance"], list(model.parameters()), allow_unused=True)
    rows = sum(int(((r >= 4) & (r < 8)).sum()) for r in aux["routes"])
    assert 0 < rows < 3 * 17 * 3 * 4
    assert flops_codes.deepseek_step(cfg, 3, 17, rows)[0] == fc.get_total_flops()
    g = json.loads((REPO_BENCH / "configs/gpt2_medium_c2i.json").read_text())
    f, _ = flops_codes.gpt2_step(g, 64, 257)
    assert f == 3 * 2 * 64 * 257 * (24 * (12 * 1024 ** 2 + 2 * 257 * 1024) + 1024 * 17384)

