"""FID and IS in the port on the CPU, held against the JAX package.

- The Inception network (``models/metrics/inception.py``) against JAX's
  ``InceptionV3Features(resize_input=False)`` at 75 px on 2 images, JAX's
  params carried over by the bridge with the BatchNorm statistics made
  random (1e-4 of max|ref|); a pytorch-fid-named state dict (the torch
  fixture ``_TorchFIDInception`` of ``test_parity_torch.py``, with
  ``fc.*``/``AuxLogits.*`` keys added) loads with ``strict=True`` and gives
  the fixture's features (1e-5 of max|ref|).
- The resize against ``jax.image.resize(..., "bilinear")`` at 32, 256 and
  512 -> 299 and the pixel features' 256 -> 4 "linear" (1e-5 of max|ref|).
- ``FIDStatistics`` with save and load, ``frechet_distance`` and
  ``inception_score`` against JAX's on the same features (dimension 64,
  one case at 2048), 1e-12 relative.
- ``FIDMetric``: ``features="pixel"`` within 1e-6 relative of JAX's;
  ``features="inception"`` self-contained on 8 images of 32 px from the
  bridged weights (features 1e-4 of max|ref|, FID 1e-3 relative or 1e-2
  absolute, the ``fid_random_init`` tag), and through ``fid_path`` reading
  a cache that the port's ``cli.fid`` wrote with the same weights. JAX's
  kernels are scaled by sqrt(2) for these, as the port's own random init
  draws them, so that each FID is a distance (> 1) and not the constant of
  the diagonal offset.
- The port's random init tells two image sets apart by FID, and an
  align-corners resize from JAX's by the statistics.

JAX's Inception runs at 299 px in two tests only, through one jitted apply
built once per module.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vector_quantization_tpu.models.metrics import fid as jax_fid
from vector_quantization_tpu.models.metrics.inception import InceptionV3Features as JaxInception
from vector_quantization_tpu.training.metrics import FIDMetric as JaxFIDMetric
from vector_quantization_tpu_torch.cli import fid as cli_fid
from vector_quantization_tpu_torch.data.datasets import SyntheticDataset
from vector_quantization_tpu_torch.models.metrics import fid
from vector_quantization_tpu_torch.models.metrics.inception import (
    InceptionV3Features,
    load_inception,
    pt_inception_state_dict,
)
from vector_quantization_tpu_torch.ops.resize import resize
from vector_quantization_tpu_torch.training.metrics import FIDMetric
from vector_quantization_tpu_torch.utils.bridge import state_dict_from_flax
from test_parity_torch import _TorchFIDInception  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops and numpy's BLAS/LAPACK on one thread in this module (see
    ``test_torch_runner.py``): beside the other test processes a 2048 x 2048
    ``eigvals`` on a full pool took 20x its one-thread time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def _random_stats(stats, seed):
    """``batch_stats`` with every mean U(-0.5, 0.5) and var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: rng.uniform(-0.5, 0.5, v.shape).astype(np.float32) if path[-1].key == "mean"
        else rng.uniform(0.5, 1.5, v.shape).astype(np.float32), stats)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX's Inception at its own random init (params and batch stats), each
    conv kernel times sqrt(2): the port's random-init gain, which keeps the
    features O(1) through the ReLUs. At flax's own scale they are about
    1e-5 and every FID is the diagonal offset's constant -2·2048·1e-6."""
    variables = jax.jit(JaxInception().init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * np.sqrt(2.0) if path[-1].key == "kernel" else v, variables["params"])
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def jax_metric(jax_variables):
    """JAX's self-contained ``FIDMetric`` on that network at 299 px, its
    ``update`` and ``summary`` as they are: the Inception branch of its
    constructor (an eager flax init, half a minute here) is done by the
    fixture above, jitted."""
    metric = JaxFIDMetric(dataset=None, features="pixel")
    metric.params, metric.batch_stats = jax_variables["params"], jax_variables["batch_stats"]
    metric._apply = jax.jit(lambda imgs: JaxInception().apply(jax_variables, imgs))
    metric.random_init = True
    return metric


def _port_metric(jm, **kw):
    """The port's ``FIDMetric`` with ``jm``'s Inception weights."""
    m = FIDMetric(**kw)
    m.model.load_state_dict(state_dict_from_flax(m.model, jm.params, jm.batch_stats))
    return m


def test_inception_matches_jax_at_75px(jax_variables):
    images = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), dtype=np.uint8)
    params, stats = jax_variables["params"], _random_stats(jax_variables["batch_stats"], 7)
    want = np.asarray(jax.jit(JaxInception(resize_input=False).apply)({"params": params, "batch_stats": stats},
                                                                      jnp.asarray(images)))
    port = InceptionV3Features(resize_input=False)
    port.load_state_dict(state_dict_from_flax(port, params, stats))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 2048)
    _close(got, want, 1e-4, "inception")


def test_pt_inception_names_load_strictly(tmp_path):
    ref = _TorchFIDInception()
    gen = torch.Generator().manual_seed(7)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    ref = ref.eval()
    state = {**ref.state_dict(), "fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
             "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)}
    torch.save(state, tmp_path / "pt_inception.pth")
    assert set(pt_inception_state_dict(str(tmp_path))) == set(ref.state_dict())
    port, random_init = load_inception(str(tmp_path / "pt_inception.pth"), "cpu")
    assert not random_init
    images = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), dtype=np.uint8)
    port.resize_input = False
    with torch.no_grad():
        want = ref(torch.from_numpy(images.astype(np.float32) / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)).numpy()
        got = port(torch.from_numpy(images)).numpy()
    _close(got, want, 1e-5, "pytorch-fid names")


@pytest.mark.parametrize("src,dst,method", [(32, 299, "bilinear"), (256, 299, "bilinear"), (512, 299, "bilinear"),
                                            (256, 4, "linear")])
def test_resize_matches_jax(src, dst, method):
    x = np.random.default_rng(src).random((2, src, src, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method))
    got = resize(torch.from_numpy(x), dst, dst, method).numpy()
    _close(got, want, 1e-5, (src, dst))


@pytest.mark.parametrize("dim", [64, 2048])
def test_statistics_and_distance_match_jax(tmp_path, dim):
    rng = np.random.default_rng(dim)
    stats, jstats = [], []
    for shift in (0.0, 0.3):
        s, js = fid.FIDStatistics(), jax_fid.FIDStatistics()
        for _ in range(3):
            f = (rng.standard_normal((dim // 2 + 5, dim)) + shift).astype(np.float32)
            s.update(f)
            js.update(f)
        assert s.n == js.n
        for key in ("sum", "sum_outer", "mean", "cov"):
            np.testing.assert_array_equal(getattr(s, key), getattr(js, key))
        stats.append(s)
        jstats.append(js)
    s.save(str(tmp_path / "port.npz"))
    js.save(str(tmp_path / "jax.npz"))
    for a, b in ((fid.FIDStatistics.load(str(tmp_path / "jax.npz")), s),
                 (jax_fid.FIDStatistics.load(str(tmp_path / "port.npz")), js)):
        assert a.n == b.n
        np.testing.assert_array_equal(a.cov, b.cov)
    args = (stats[0].mean, stats[0].cov, stats[1].mean, stats[1].cov)
    got, want = fid.frechet_distance(*args), jax_fid.frechet_distance(*args)
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)


def test_inception_score_matches_jax():
    logits = np.random.default_rng(0).standard_normal((100, 1000))
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    got, want = fid.inception_score(probs), jax_fid.inception_score(probs)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _memo(seed):
    """8 random 32 px images and a noisy [-1, 1] prediction of them."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    pred = np.clip(gt.astype(np.float32) / 127.5 - 1.0 + rng.normal(0, 0.3, gt.shape), -1, 1)
    return {"pred": pred.astype(np.float32), "batch": {"original_image": gt}}


def test_pixel_fid_matches_jax():
    """Synthetic gratings, the predictions other images than the ground
    truth: 4x4 means that differ, so the distance is not a cancellation."""
    data = SyntheticDataset(size=64, image_size=256)
    port, ref = FIDMetric(features="pixel"), JaxFIDMetric(dataset=None, features="pixel")
    for b in range(3):
        gt = np.stack([data[8 * b + i].original_image for i in range(8)])
        pred = np.stack([data[32 + 8 * b + i].image for i in range(8)])
        memo = {"pred": pred, "batch": {"original_image": gt}}
        _close(port.features(torch.from_numpy(gt)), ref._apply(jnp.asarray(gt)), 1e-6, "pixel features")
        port.update({**memo, "pred": torch.from_numpy(pred)})
        ref.update(memo)
    got, want = port.summary("fid"), ref.summary("fid")
    assert set(got) == set(want) == {"fid"}
    assert abs(got["fid"] - want["fid"]) <= 1e-6 * abs(want["fid"]), (got, want)


def test_inception_fid_matches_jax_self_contained(jax_metric):
    port = _port_metric(jax_metric)
    memo = _memo(1)
    u8 = memo["batch"]["original_image"]
    _close(port.features(torch.from_numpy(u8)), jax_metric._apply(jnp.asarray(u8)), 1e-4, "features")
    port.update({**memo, "pred": torch.from_numpy(memo["pred"])})
    jax_metric.update(memo)
    got, want = port.summary("fid"), jax_metric.summary("fid")
    assert got["fid_random_init"] == want["fid_random_init"] == 1.0
    assert abs(want["fid"]) > 1.0, want  # a distance, not the diagonal offset's constant
    assert abs(got["fid"] - want["fid"]) <= max(1e-3 * abs(want["fid"]), 1e-2), (got, want)


def test_inception_fid_reads_the_cli_fid_cache(jax_metric, tmp_path):
    weights = tmp_path / "inception.pth"
    torch.save(_port_metric(jax_metric).model.state_dict(), weights)
    config = tmp_path / "fid.py"
    config.write_text(f"""_base_ = [{str(REPO / 'configs/datasets/synthetic.py')!r}]
validator = dict(dataset=dict(image_size=32, size=8), fid_batch_size=4)
""")
    path = cli_fid.main(["fid", str(config), "--device", "cpu", "--inception-weights", str(weights),
                         "--fid-path", str(tmp_path / "cache.npz")])
    assert fid.FIDStatistics.load(path).n == 8
    port = FIDMetric(fid_path=path, weights=str(weights))
    ref = JaxFIDMetric(dataset=None, fid_path=path, features="pixel")  # its network swapped in as above
    ref._apply, ref.random_init = jax_metric._apply, True
    assert port.gt_stats is None and ref.gt_stats is None
    memo = _memo(2)
    port.update({**memo, "pred": torch.from_numpy(memo["pred"])})
    ref.update(memo)
    got, want = port.summary("fid"), ref.summary("fid")
    assert "fid_random_init" not in got  # weights given: the port does not tag it
    assert abs(want["fid"]) > 1.0, want
    assert abs(got["fid"] - want["fid"]) <= max(1e-3 * abs(want["fid"]), 1e-2), (got, want)


def test_random_init_tells_image_sets_and_resizes_apart():
    """The port's own random init (no weights) keeps the features O(1), so
    its FID and statistics see what a cache was built from: two sets of
    synthetic images give an FID far from the diagonal offset's constant
    -2·2048·1e-6, and an align-corners bilinear resize in place of JAX's
    moves the statistics (the network at 75 px, one 1 x 1 map at the end)."""
    model, random_init = load_inception(None, "cpu")
    model.resize_input = False
    data = SyntheticDataset(size=8, image_size=64)
    a, b = (torch.from_numpy(np.stack([data[i].original_image for i in idx])) for idx in (range(4), range(4, 8)))

    def u8(x):
        return x.round().clamp(0, 255).to(torch.uint8)

    same = u8(resize(a.float(), 75, 75, "bilinear"))
    corners = u8(torch.nn.functional.interpolate(a.float().permute(0, 3, 1, 2), size=(75, 75), mode="bilinear",
                                                 align_corners=True).permute(0, 2, 3, 1))
    stats = {}
    for key, images in (("a", same), ("b", u8(resize(b.float(), 75, 75, "bilinear"))), ("corners", corners)):
        stats[key] = fid.FIDStatistics()
        with torch.no_grad():
            stats[key].update(model(images).numpy())
    assert random_init and 1e-2 < np.abs(stats["a"].mean).max() < 1e2
    sa, sb = stats["a"], stats["b"]
    assert fid.frechet_distance(sa.mean, sa.cov, sb.mean, sb.cov) > 0.1
    moved = np.abs(stats["corners"].sum - sa.sum).max() / np.abs(sa.sum).max()
    assert moved > 1e-4, moved
