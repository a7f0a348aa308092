"""Each driver end to end at a tiny size on the CPU against its reference,
and the check that decides ``correct`` failing on each fault a cell can
have, planted in the program underneath a run: a step that returns its
state unchanged, half of each batch left out (the mean over the rest), a
code altered where it is produced. (The exchange between chips is no
fault of these one-chip cells.)"""

import pytest
import torch

from benchmark import harness
from conftest import SEED

import vector_quantization_tpu_torch.ops.vq_lookup as vq_lookup
from vector_quantization_tpu_torch.algorithms.ar import ARAlgorithm
from vector_quantization_tpu_torch.algorithms.vqgan import VQGANAlgorithm
from vector_quantization_tpu_torch.tasks.image_tokenization import TokenizerModel
from vector_quantization_tpu_torch.tasks.sequence_modeling import next_token_ce

CELLS = ["tiny_ar", "tiny_export", "tiny_vqgan"]


def run(root, cell, seconds=0.5):
    result, detail = harness.run_cell(cell, SEED, seconds, False, "cpu", root)
    return result, detail


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result, detail = run(tiny_root, cell)
    assert result["correct"], (result["checks"], detail)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def _altered_lookup(monkeypatch):
    orig = vq_lookup.nearest_codes

    def altered(x, codebook, metric="l2"):
        codes = orig(x, codebook, metric).clone()
        codes[0] = (codes[0] + codebook.shape[0] // 2) % codebook.shape[0]
        return codes

    monkeypatch.setattr(vq_lookup, "nearest_codes", altered)


def _ar_unchanged(self, state, batch):
    tokens = self._tokens(state, batch, train=True)
    with torch.no_grad():
        loss = next_token_ce(state.model(tokens), tokens)
    return state, {"loss": loss}


def _vqgan_unchanged(self, state, batch):
    with torch.no_grad():
        state.model.quantize(state.model.encode(batch["image"]), train=True)
    zero = torch.zeros(())
    return state, {"loss": zero, "d_loss": zero}


def _half(cls, monkeypatch):
    orig = cls.train_step

    def half(self, state, batch):
        return orig(self, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(cls, "train_step", half)


def _half_export(monkeypatch):
    orig = TokenizerModel.encode_to_quant

    def half(self, x):
        return orig(self, x[: x.shape[0] // 2])

    monkeypatch.setattr(TokenizerModel, "encode_to_quant", half)


FAULTS = [
    ("tiny_ar", "unchanged", lambda mp: mp.setattr(ARAlgorithm, "train_step", _ar_unchanged)),
    ("tiny_ar", "half_batch", lambda mp: _half(ARAlgorithm, mp)),
    ("tiny_ar", "altered_code", _altered_lookup),
    ("tiny_export", "half_batch", _half_export),
    ("tiny_export", "altered_code", _altered_lookup),
    ("tiny_vqgan", "unchanged", lambda mp: mp.setattr(VQGANAlgorithm, "train_step", _vqgan_unchanged)),
    ("tiny_vqgan", "half_batch", lambda mp: _half(VQGANAlgorithm, mp)),
    ("tiny_vqgan", "altered_code", _altered_lookup),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    result, detail = run(tiny_root, cell, seconds=0.3)
    assert not result["correct"], (fault, result["checks"], detail)
