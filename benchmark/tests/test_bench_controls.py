"""The control and the faults against each cell's limits.

On the card (marked ``cuda``; skipped without one): for each cell at its
own sizes, the reference computed in TF32 in the program's place, and the
faults, read above a limit. On the CPU, the same readings at the tiny
cells' sizes: the faults read above a limit (TF32 does not exist there)."""

import pytest

from benchmark import controls, harness
from conftest import REPO, SEED

CELLS = ["gpt2m_c2i_train_images_b64", "vqgan_tencrop_export", "vqgan_train_gan_b12"]


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card computes")
    limits = harness.load_json(REPO / "benchmark/workloads" / f"{cell}.json")["limits"]
    for r in controls.readings(cell, SEED):
        assert _fails(r, limits), r


@pytest.mark.parametrize("cell", ["tiny_ar", "tiny_export", "tiny_vqgan"])
def test_faults_fail_at_tiny_size(tiny_root, cell):
    limits = harness.load_json(tiny_root / "benchmark/workloads" / f"{cell}.json")["limits"]
    got = controls.readings(cell, SEED, "cpu", tiny_root)
    assert {r["reading"] for r in got} == {"control", "half_batch", "altered_code"}
    for r in got:
        if r["reading"] != "control":
            assert _fails(r, limits), r
