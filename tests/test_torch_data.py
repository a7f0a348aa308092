"""The port's data plane and config against the JAX package's, on the CPU.

The same seeds, datasets and loader settings go through
``vector_quantization_tpu.data`` and ``vector_quantization_tpu_torch.data``:
- ``DataLoader``: the same per-batch index lists, batches (ids, images,
  categories, shapes), ``_item_seed``s and ``drop_last=False`` wrap
  padding, with shuffle on and off, over two epochs, with
  ``num_processes``/``process_index`` given; every ``pipeline`` mode gives
  the same batches; ``seek`` starts at the batch asked for;
- ``ImageFolderDataset`` (with and without augmentation), ``ImageNetDataset``,
  ``SplitDataset`` and ``ConcatDataset`` items, and the native decoder's
  batches, on JPEGs that PIL writes to ``tmp_path``, equal bit for bit;
- ``Config.override`` and ``dump`` give the JAX copy's output.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import vector_quantization_tpu.data.datasets  # noqa: F401  (registers the JAX datasets)
from vector_quantization_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from vector_quantization_tpu.data.loader import DataLoader as JaxLoader
from vector_quantization_tpu.data.native import native_available
from vector_quantization_tpu.registries import DatasetRegistry as JaxDatasets
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.data.datasets import SyntheticDataset
from vector_quantization_tpu_torch.data.loader import DataLoader
from vector_quantization_tpu_torch.registries import DatasetRegistry
from vector_quantization_tpu_torch.utils.config import load_config
from vector_quantization_tpu_torch.utils.flags import Store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"id_", "original_image", "image", "category"}
        assert list(a["id_"]) == list(b["id_"])
        for k in ("original_image", "image", "category"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


LOADER_CASES = [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=4, shuffle=True, seed=5),
    dict(batch_size=3, shuffle=True, drop_last=False),
    dict(batch_size_in_total=6, shuffle=True, drop_last=False, num_processes=2, process_index=1),
    dict(batch_size_in_total=4, shuffle=False, drop_last=False, num_processes=2, process_index=0),
]


@pytest.mark.parametrize("kw", LOADER_CASES)
def test_loader_matches_jax_over_two_epochs(kw):
    size = 11
    port = DataLoader(SyntheticDataset(size=size, image_size=8), num_workers=2, **kw)
    ref = JaxLoader(JaxSynthetic(size=size, image_size=8), num_workers=2, **kw)
    assert len(port) == len(ref)
    assert (port.batch_size, port.global_batch_size) == (ref.batch_size, ref.global_batch_size)
    for _ in range(2):
        assert port._local_indices() == ref._local_indices()
        _assert_batches_equal(list(port), list(ref))
    assert port.epoch == ref.epoch == 2
    for epoch, index in [(0, 0), (1, 7), (3, 10**6), (2**20, 2**31 - 1)]:
        assert port._item_seed(epoch, index) == ref._item_seed(epoch, index)


@pytest.mark.parametrize("pipeline", ["inline", "thread", "auto"])
def test_loader_pipelines_give_the_same_batches(pipeline):
    kw = dict(batch_size=2, shuffle=True, seed=3)
    port = DataLoader(SyntheticDataset(size=12, image_size=8), num_workers=2, pipeline=pipeline, **kw)
    ref = JaxLoader(JaxSynthetic(size=12, image_size=8), num_workers=2, pipeline="inline", **kw)
    for _ in range(2):  # "auto" decides in the first epoch and keeps it
        _assert_batches_equal(list(port), list(ref))
    port = DataLoader(SyntheticDataset(size=12, image_size=8), num_workers=0, **kw)
    _assert_batches_equal(list(port), list(JaxLoader(JaxSynthetic(size=12, image_size=8), num_workers=0, **kw)))


def test_loader_seek_starts_at_the_batch():
    kw = dict(batch_size=2, shuffle=True)
    port = DataLoader(SyntheticDataset(size=8, image_size=8), num_workers=0, **kw)
    ref = JaxLoader(JaxSynthetic(size=8, image_size=8), num_workers=0, **kw)
    ref_batches = [list(ref) for _ in range(3)]
    port.seek(2, 3)
    _assert_batches_equal(list(port), ref_batches[2][3:])
    assert port.epoch == 3
    port.seek(1)
    _assert_batches_equal(list(port), ref_batches[1])


def test_batch_size_errors():
    ds = SyntheticDataset(size=4, image_size=8)
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ds, batch_size_in_total=3, num_processes=2, process_index=0)
    with pytest.raises(ValueError, match="need batch_size"):
        DataLoader(ds)
    with pytest.raises(ValueError, match="pipeline"):
        DataLoader(ds, batch_size=2, pipeline="fork")


def _write_jpeg(path, w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [0.5 + 0.5 * np.sin(2 * np.pi * (a * xx / w + b * yy / h) + p)
             for a, b, p in rng.uniform(0.5, 3.0, size=(3, 3))]
    Image.fromarray((np.stack(chans, -1) * 255).astype(np.uint8)).save(path, quality=95)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """root/{train,val}/{cls_a,cls_b}/img_i.jpg and one PNG, sorted last:
    the loader takes the native path only where item 0 is a JPEG."""
    root = tmp_path_factory.mktemp("images")
    sizes = [(40, 30), (30, 40), (32, 32), (23, 37), (50, 20), (33, 33)]
    for split in ("train", "val"):
        for i, (w, h) in enumerate(sizes):
            d = root / split / ("cls_a" if i % 2 else "cls_b")
            d.mkdir(parents=True, exist_ok=True)
            _write_jpeg(str(d / f"img_{i}.jpg"), w, h, seed=i)
        Image.fromarray(np.full((20, 28, 3), 90, np.uint8)).save(str(root / split / "cls_b" / "z.png"))
    return str(root)


def _items_equal(port_ds, ref_ds):
    assert len(port_ds) == len(ref_ds)
    assert (port_ds.name, port_ds.num_categories, port_ds.image_size) == (
        ref_ds.name, ref_ds.num_categories, ref_ds.image_size)
    for i in range(len(ref_ds)):
        a, b = port_ds[i], ref_ds[i]
        assert (a.id_, a.category) == (b.id_, b.category)
        np.testing.assert_array_equal(a.original_image, b.original_image)
        np.testing.assert_array_equal(a.image, b.image)
        assert port_ds.native_record(i) == ref_ds.native_record(i)


@pytest.mark.parametrize("augmentation", ["none", "default", "strong", "weak"])
def test_image_folder_items_match_jax(image_root, augmentation):
    cfg = dict(type="ImageFolderDataset", root=os.path.join(image_root, "train"), categorical=True,
               name="f", image_size=16, augmentation=augmentation, seed=4)
    _items_equal(DatasetRegistry.build(cfg), JaxDatasets.build(cfg))


def test_imagenet_split_and_concat_match_jax(image_root):
    imagenet = dict(type="ImageNetDataset", root=image_root, split="val", image_size=16)
    _items_equal(DatasetRegistry.build(imagenet), JaxDatasets.build(imagenet))
    for split in ("train", "val"):
        cfg = dict(type="SplitDataset", dataset=imagenet, split=split, val_size=3, stride=7)
        _items_equal(DatasetRegistry.build(cfg), JaxDatasets.build(cfg))
    cfg = dict(type="ConcatDataset", datasets=[
        imagenet, dict(type="SyntheticDataset", size=3, image_size=16),
        dict(type="ImageFolderDataset", root=os.path.join(image_root, "train"), name="t", image_size=16)])
    port, ref = DatasetRegistry.build(cfg), JaxDatasets.build(cfg)
    assert port.name == ref.name == "imagenet_val+synthetic+t"
    _items_equal(port, ref)


def test_dry_run_shrinks_like_jax(monkeypatch, image_root):
    monkeypatch.setenv("DRY_RUN", "1")
    assert Store.DRY_RUN is True
    assert len(SyntheticDataset(size=500, image_size=8)) == len(JaxSynthetic(size=500, image_size=8)) == 64
    cfg = dict(type="SplitDataset", dataset=dict(type="SyntheticDataset", size=40, image_size=8), val_size=30)
    assert len(DatasetRegistry.build(cfg)) == len(JaxDatasets.build(cfg)) == 40


@pytest.mark.parametrize("augmentation", ["none", "default"])
def test_native_loader_matches_jax(image_root, augmentation):
    if not native_available():
        pytest.skip("the native data plane (native/libvqtdata.so) does not load here")
    cfg = dict(type="ImageFolderDataset", root=os.path.join(image_root, "train"), categorical=True,
               name="f", image_size=16, augmentation=augmentation)
    kw = dict(batch_size=3, shuffle=True, drop_last=False, num_workers=2, seed=1)
    port, ref = DataLoader(DatasetRegistry.build(cfg), **kw), JaxLoader(JaxDatasets.build(cfg), **kw)
    for _ in range(2):
        _assert_batches_equal(list(port), list(ref))


CONFIG = os.path.join(REPO, "configs", "vqgan", "smoke.py")
OVERRIDES = {"trainer.max_iters": 7, "trainer.algorithm.optimizer.lr": 0.5,
             "trainer.callbacks[1].interval": 3, "validator.new.deep.key": [1, (2, 3)],
             "trainer.dataloader": {"batch_size": 2, "_delete_": True}}


def test_config_override_and_dump_match_jax(tmp_path):
    port, ref = load_config(CONFIG, image_size=16), jax_load_config(CONFIG, image_size=16)
    port.override(OVERRIDES)
    ref.override(OVERRIDES)
    assert port.dumps() == ref.dumps()
    assert port.trainer.callbacks[1].interval == 3 and port.validator.new.deep.key == [1, (2, 3)]
    copied = port.copy()
    copied.trainer.max_iters = 1
    assert port.trainer.max_iters == 7
    port.dump(str(tmp_path / "a.json"))
    ref.dump(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert json.loads((tmp_path / "a.json").read_text())["trainer"]["max_iters"] == 7
