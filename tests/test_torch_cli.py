"""The port's CLI (``python -m vector_quantization_tpu_torch.cli.*``) on the
CPU: the cases of ``tests/test_cli.py`` that the port has (train then test,
the resume flags, ``--config-options``/``--override``, tokenize, demo), a
resume that equals a straight run bit for bit with the GAN, EMA and the
discriminator's BatchNorm in play, and the tokens and the demo's codes
against the JAX model's ``encode_to_quant`` on the same bridged weights
and pixels."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vector_quantization_tpu.models  # noqa: F401  (registers the JAX models)
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.data.base import Transform as JaxTransform
from vector_quantization_tpu.data.base import pixel_encode as jax_pixel_encode
from vector_quantization_tpu.registries import ModelRegistry as JaxModelRegistry
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.cli import demo as demo_cli
from vector_quantization_tpu_torch.cli import test as test_cli
from vector_quantization_tpu_torch.cli import tokenize as tok_cli
from vector_quantization_tpu_torch.cli import train as train_cli
from vector_quantization_tpu_torch.cli.common import build_parser, prepare
from vector_quantization_tpu_torch.data.datasets import SyntheticDataset
from vector_quantization_tpu_torch.training.runner import build_runner
from vector_quantization_tpu_torch.utils.bridge import params_to_flax

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "vqgan", "smoke.py")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores (7x slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train(work, *extra):
    return train_cli.main(["smoke", CONFIG, "--work-dir", str(work), *CPU, *extra])


def test_train_then_test(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DRY_RUN", "1")
    work = tmp_path / "work"
    trainer = _train(work)
    assert trainer.state.step == 5
    assert (work / "run.log").exists() and (work / "config.json").exists()
    assert json.loads((work / "config.json").read_text())["name"] == "smoke"
    ckpt = work / "checkpoints" / "iter_5"
    assert (ckpt / "state.pt").exists()
    capsys.readouterr()
    results = test_cli.main(["smoke", CONFIG, "--work-dir", str(work), *CPU, "--load-model-from", str(ckpt)])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):]) == results
    assert set(results) == {"codebook_usage", "psnr"} and all(np.isfinite(list(results.values())))
    assert "Iter [5/5]" in (work / "run.log").read_text()


def test_resume_flags(tmp_path):
    work = tmp_path / "work"
    assert _train(work, "--override", "trainer.max_iters=3").state.step == 3
    trainer = _train(work, "--auto-resume", "--override", "trainer.max_iters=5")
    assert (trainer.start_step, trainer.state.step) == (3, 5)
    assert sorted(os.listdir(work / "checkpoints")) == ["iter_3", "iter_5"]
    trainer = _train(work, "--load-from", str(work / "checkpoints" / "iter_3"), "--override", "trainer.max_iters=4")
    assert (trainer.start_step, trainer.state.step) == (3, 4)
    fresh = _train(tmp_path / "fresh", "--auto-resume", "--override", "trainer.max_iters=1")
    assert (fresh.start_step, fresh.state.step) == (0, 1)


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    gan_ema = ["trainer.algorithm.ema_decay=0.99", "trainer.algorithm.discriminator_start=0"]
    _train(tmp_path / "straight", "--override", "trainer.max_iters=3", *gan_ema)
    _train(tmp_path / "cut", "--override", "trainer.max_iters=2", *gan_ema)
    _train(tmp_path / "cut", "--load-from", str(tmp_path / "cut/checkpoints/iter_2"),
           "--override", "trainer.max_iters=3", *gan_ema)
    a = torch.load(str(tmp_path / "straight/checkpoints/iter_3/state.pt"), weights_only=True)
    b = torch.load(str(tmp_path / "cut/checkpoints/iter_3/state.pt"), weights_only=True)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb)
    for part in ("/extra/ema_params/", "/extra/d_batch_stats/", "/d_opt_state/mu/", "/params/discriminator/"):
        assert any(k.startswith(part) for k in la), part
    assert la["/step"] == 3 and la["/opt_state/count"] == la["/d_opt_state/count"] == 3
    for name, value in la.items():
        other = lb[name]
        assert torch.equal(value, other) if isinstance(value, torch.Tensor) else value == other, name


def test_config_options_and_override():
    args = build_parser("t").parse_args(
        ["smoke", CONFIG, "--override", "trainer.max_iters=7", "trainer.algorithm.optimizer.lr=0.5",
         "trainer.callbacks[1].interval=9", "validator.name=v"])
    cfg = prepare(args)
    assert cfg.trainer.max_iters == 7 and cfg.trainer.algorithm.optimizer.lr == 0.5
    assert cfg.trainer.callbacks[1] == {"type": "CheckpointCallback", "interval": 9}
    assert cfg.validator.name == "v" and cfg.name == "smoke"
    synthetic = os.path.join(os.path.dirname(CONFIG), "..", "datasets", "synthetic.py")
    cfg = prepare(build_parser("t").parse_args(["s", synthetic, "--config-options", "size=24", "image_size=16"]))
    assert cfg.trainer.dataset.image_size == 16 and cfg.trainer.dataset.size == 24


def _jax_codes(runner, pixels):
    jcfg = jax_load_config(CONFIG)["validator"]["algorithm"]["model"]
    jmodel = JaxModelRegistry.build(jcfg)
    params = params_to_flax(runner.algorithm.model)
    return np.asarray(jmodel.apply({"params": params}, jnp.asarray(pixels), method=jmodel.encode_to_quant))


def test_tokenize_matches_jax(tmp_path):
    work = tmp_path / "work"
    _train(work, "--override", "trainer.max_iters=1")
    ckpt = str(work / "checkpoints" / "iter_1")
    out = tok_cli.main(["smoke", CONFIG, "--work-dir", str(work), *CPU, "--load-model-from", ckpt])
    files = sorted(os.listdir(out))
    assert files == ["0_0.npz", "1_0.npz"]
    runner = build_runner(prepare(build_parser("t").parse_args(["smoke", CONFIG])), "validator", device="cpu",
                          work_dir=str(tmp_path / "ref"))
    runner.init_state()
    runner.load_model_from(ckpt)
    dataset = SyntheticDataset(size=16, image_size=32)
    for i, name in enumerate(files):
        data = np.load(os.path.join(out, name))
        items = [dataset[j] for j in range(8 * i, 8 * i + 8)]
        assert data["tokens"].dtype == np.int32 and data["tokens"].shape == (8, 16, 16)
        assert list(data["id_"]) == [it.id_ for it in items]
        assert data["category"].tolist() == [it.category for it in items]
        want = _jax_codes(runner, np.stack([it.image for it in items]))
        np.testing.assert_array_equal(data["tokens"], want)


def test_demo_matches_jax(tmp_path):
    img_path = str(tmp_path / "img.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(img_path)
    work = tmp_path / "work"
    out = demo_cli.main(["smoke", CONFIG, "--work-dir", str(work), *CPU, "--image", img_path])
    assert out == str(work / "demo")
    recon = np.asarray(Image.open(os.path.join(out, "reconstruction.png")))
    assert recon.shape == (32, 32, 3) and recon.dtype == np.uint8
    runner = build_runner(prepare(build_parser("t").parse_args(["smoke", CONFIG])), "validator", device="cpu",
                          work_dir=str(tmp_path / "ref"))
    with Image.open(img_path) as img:
        pixels = jax_pixel_encode(JaxTransform(32)(img))[None]
    np.testing.assert_array_equal(np.load(os.path.join(out, "codes.npy")), _jax_codes(runner, pixels)[0])


def test_demo_needs_an_image_argument():
    with pytest.raises(SystemExit):
        demo_cli.main(["smoke", CONFIG, *CPU])
