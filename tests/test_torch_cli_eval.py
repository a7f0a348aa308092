"""The port's evaluation entry points and domain datasets on the CPU.

- ``cli.val``'s ``CheckpointMonitor``: the order (oldest first), the
  whitelist and blacklist, a save in progress skipped until it completes,
  ``max_idle_rounds``, and the sleep (600 s, 10 s under ``DRY_RUN``), with
  ``time.sleep`` patched.
- ``cli.val`` over the two checkpoints of a tiny ``cli.train`` run: each
  validated once, oldest first, ``val/<metric>`` scalars written at each
  step, the last one's metrics equal to ``cli.test``'s on it; ``--load-from``
  stops it once drained, without sleeping.
- ``cli.fid`` on a tiny synthetic split: its ``n``, ``sum`` and
  ``sum_outer`` equal ``FIDStatistics`` over the same network's features of
  the same images.
- The four domain datasets over JPEG folders written here: names and
  category 0, LAION's split ids against the JAX package's, each domain
  config under ``configs/datasets/`` built through the registry, and
  LAION's retry rule (10 attempts, each a valid index, the last exception
  raised again).
"""

import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import vector_quantization_tpu.data.domains as jax_domains
from vector_quantization_tpu_torch.cli import fid as cli_fid
from vector_quantization_tpu_torch.cli import test as test_cli
from vector_quantization_tpu_torch.cli import train as train_cli
from vector_quantization_tpu_torch.cli import val as val_cli
from vector_quantization_tpu_torch.cli.val import CheckpointMonitor
from vector_quantization_tpu_torch.data import domains
from vector_quantization_tpu_torch.data.datasets import SplitDataset, SyntheticDataset
from vector_quantization_tpu_torch.models.metrics.fid import FIDStatistics
from vector_quantization_tpu_torch.models.metrics.inception import load_inception
from vector_quantization_tpu_torch.registries import DatasetRegistry
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/vqgan/smoke.py")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (see ``test_torch_runner.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _checkpoint(root: Path, name: str, complete: bool = True) -> Path:
    path = root / name
    path.mkdir(parents=True)
    if complete:
        (path / "state.pt").write_bytes(b"")
    time.sleep(0.02)  # distinct ctimes
    return path


def test_monitor_yields_new_checkpoints_oldest_first(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(val_cli, "time", SimpleNamespace(sleep=sleeps.append))
    for name in ("iter_30", "iter_4", "iter_100", "iter_7"):
        _checkpoint(tmp_path, name)
    partial = _checkpoint(tmp_path, "iter_200", complete=False)
    monitor = CheckpointMonitor(str(tmp_path), blacklist=["iter_7"], max_idle_rounds=2)
    got = []
    for path in monitor:
        got.append(os.path.basename(path))
        if len(got) == 3:  # the save in progress completes, and a new one lands
            (partial / "state.pt").write_bytes(b"")
            time.sleep(0.02)
            _checkpoint(tmp_path, "iter_5")
    assert got == ["iter_30", "iter_4", "iter_100", "iter_200", "iter_5"]
    assert sleeps == [600]  # two idle rounds: the first sleeps, the second stops
    white = CheckpointMonitor(str(tmp_path), whitelist=["iter_4", "iter_7", "iter_9"], max_idle_rounds=1)
    assert [os.path.basename(p) for p in white] == ["iter_4", "iter_7"]
    assert sleeps == [600]


def test_monitor_sleeps_10s_under_dry_run(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(val_cli, "time", SimpleNamespace(sleep=sleeps.append))
    monkeypatch.setenv("DRY_RUN", "1")
    assert list(CheckpointMonitor(str(tmp_path / "none"), max_idle_rounds=3)) == []
    assert sleeps == [10, 10]


def _read_scalars(log_dir: Path) -> dict[str, list[tuple[int, float]]]:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _no_sleep(seconds):
    raise AssertionError(f"cli.val slept {seconds} s")


def test_cli_val_validates_each_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(val_cli, "time", SimpleNamespace(sleep=_no_sleep))
    work = tmp_path / "work"
    train_cli.main(["smoke", SMOKE, "--work-dir", str(work), *CPU, "--override", "trainer.max_iters=4",
                    "trainer.callbacks[1].interval=2"])
    results = val_cli.main(["smoke", SMOKE, "--work-dir", str(work), *CPU, "--max-idle-rounds", "1"])
    assert list(results) == ["iter_2", "iter_4"]
    assert set(results["iter_2"]) == {"codebook_usage", "psnr"}
    scalars = _read_scalars(work / "tensorboard")
    for metric in ("codebook_usage", "psnr"):
        assert scalars[f"val/{metric}"] == [(2, pytest.approx(results["iter_2"][metric])),
                                            (4, pytest.approx(results["iter_4"][metric]))]
    assert results["iter_4"] == test_cli.main(["smoke", SMOKE, "--work-dir", str(tmp_path / "test"), *CPU,
                                               "--load-model-from", str(work / "checkpoints" / "iter_4")])
    drained = val_cli.main(["smoke", SMOKE, "--work-dir", str(work), *CPU, "--load-from", "iter_2"])
    assert drained == {"iter_2": results["iter_2"]}


def test_cli_fid_statistics_equal_direct_ones(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default output lands under ./work_dirs
    config = tmp_path / "fid.py"
    config.write_text(f"""_base_ = [{str(REPO / 'configs/datasets/synthetic.py')!r}]
validator = dict(dataset=dict(image_size=32, size=8), fid_batch_size=4)
""")
    path = cli_fid.main(["fid", str(config), *CPU])
    assert path == os.path.join("work_dirs", "fid", "synthetic_fid.npz")
    got = FIDStatistics.load(path)
    model, random_init = load_inception(None, "cpu")
    data = SyntheticDataset(size=8, image_size=32, num_categories=10)
    want = FIDStatistics()
    with torch.inference_mode():
        for start in (0, 4):
            images = np.stack([data[i].original_image for i in range(start, start + 4)])
            want.update(model(torch.from_numpy(images)).numpy())
    assert random_init and got.n == want.n == 8
    np.testing.assert_array_equal(got.sum, want.sum)
    np.testing.assert_array_equal(got.sum_outer, want.sum_outer)


def _jpegs(root: Path, n: int, corrupt: tuple[int, ...] = ()) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(n)
    for i in range(n):
        path = root / f"{i:03d}.jpg"
        if i in corrupt:
            path.write_bytes(b"not a jpeg")
        else:
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
    return root


def test_domain_datasets_names_and_category(tmp_path):
    _jpegs(tmp_path / "coco" / "val2014", 3)
    _jpegs(tmp_path / "flat", 10)
    cases = [
        (domains.COCODataset, jax_domains.COCODataset, dict(root=str(tmp_path / "coco"), split="val2014"),
         "coco_val2014", 3),
        (domains.SAMed2DDataset, jax_domains.SAMed2DDataset, dict(root=str(tmp_path / "flat")), "sa_med2d", 10),
        (domains.SATINDataset, jax_domains.SATINDataset, dict(root=str(tmp_path / "flat")), "satin", 10),
    ]
    for split in ("train", "val"):
        cases.append((domains.LAIONAestheticsDataset, jax_domains.LAIONAestheticsDataset,
                      dict(root=str(tmp_path / "flat"), split=split, val_size=3),
                      f"laion_aesthetics_{split}", 7 if split == "train" else 3))
    for cls, jax_cls, kwargs, name, n in cases:
        ds, ref = cls(image_size=32, **kwargs), jax_cls(image_size=32, **kwargs)
        assert ds.name == ref.name == name and len(ds) == len(ref) == n
        if isinstance(ds, SplitDataset):
            assert ds.indices == ref.indices
        item = ds[n - 1]
        assert item.category == 0 and item.original_image.shape == (32, 32, 3)
        np.testing.assert_array_equal(item.original_image, ref[n - 1].original_image)


@pytest.mark.parametrize("name,prefix,sizes", [("coco_2014", "coco_2014_", (2, 3)),
                                               ("laion_aesthetics", "laion_aesthetics_", (0, 4)),
                                               ("sa_med2d_20m", "sa_med2d_", (0, 4)),
                                               ("satin", "satin_", (0, 4))])
def test_domain_configs_build(tmp_path, name, prefix, sizes):
    _jpegs(tmp_path / "train2014", 2)
    _jpegs(tmp_path / "val2014", 3)
    flat = _jpegs(tmp_path / "flat", 4)
    cfg = Config.load(str(REPO / f"configs/datasets/{name}.py"), image_size=32)
    for (split, suffix), n in zip((("trainer", "train"), ("validator", "val")), sizes):
        node = cfg[split]["dataset"]
        node = node.get("dataset", node)
        node["root"] = str(tmp_path if name == "coco_2014" else flat)
        ds = DatasetRegistry.build(cfg[split]["dataset"])
        assert ds.image_size == 32 and ds.name == prefix + suffix and len(ds) == n  # val carve-out: 25,000


def test_laion_retries_then_raises(tmp_path, monkeypatch):
    ds = domains.LAIONAestheticsDataset(root=str(_jpegs(tmp_path, 6, corrupt=(0,))), split="train", val_size=1,
                                        image_size=32)
    assert ds[0].category == 0  # the corrupt file is retried at another index
    calls = []

    def failing(self, index):
        calls.append(index)
        raise OSError(f"attempt {len(calls)}")

    monkeypatch.setattr(SplitDataset, "__getitem__", failing)
    with pytest.raises(OSError, match="attempt 10"):
        ds[3]
    assert len(calls) == 10 and calls[0] == 3 and all(0 <= i < len(ds) for i in calls)
