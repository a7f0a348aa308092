"""The port's tools (``vector_quantization_tpu_torch/tools``) on the CPU,
held against the JAX tools under ``tools/`` on the same inputs.

- ``ten_crop`` equal bit for bit; ``tokenize_llamagen`` on
  ``configs/regression/golden_synthetic.py``'s tokenizer with the JAX
  runner's initial weights (bridged into a port checkpoint, loaded with
  ``--load-model-from``), 24 px crops of 32 px images: the same files,
  names, dtypes and shapes, and the same codes (f32; a row may differ
  only as a near-tie of ``compare_codes``, counted and bounded here);
- ``visualize_patches`` on the same weights: the same PNG bytes;
- ``fid`` and ``fidelity`` on two folders of 4 images each, at 32 px, with
  JAX's Inception at its random init (kernels times sqrt(2), as
  ``test_torch_fid.py`` makes it) given to the JAX tools as an orbax
  checkpoint and to the port's as pytorch-fid's ``.pth``: FID within 1e-3
  relative or 1e-2 absolute, IS within 1e-4 relative, ``fid.txt``
  appended; without weights the line is tagged ``fid_random_init``;
- ``model_ema`` on a checkpoint with EMA (loaded back with
  ``--load-model-from``: the generator equals ``extra["ema_params"]``) and
  without (the JAX tool's message);
- ``convert_weights`` on a seeded fake checkpoint of every family, each
  loaded strictly into the port's module built from a config (``--check``),
  and a config of other widths refused;
- ``prepare_checkpoints``: the manifest, and a conversion of what it finds;
- ``merge_params`` and ``partition_params``/``filter_state_dict`` against
  JAX's on the same trees.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tools import _run_tool
from tests.test_torch_converters import (
    _clip_shapes,
    _fake,
    _gpt2_shapes,
    _llama_shapes,
    _vgg_and_lin,
)
from vector_quantization_tpu.models.metrics.inception import InceptionV3Features as JaxInception
from vector_quantization_tpu.training import checkpoints as jax_checkpoints
from vector_quantization_tpu.training.runner import build_runner as jax_build_runner
from vector_quantization_tpu.utils import filters as jax_filters
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.models.metrics.inception import InceptionV3Features
from vector_quantization_tpu_torch.ops.distances import normalize
from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes
from vector_quantization_tpu_torch.tools import (
    _taming,
    convert_weights,
    fid,
    fidelity,
    model_ema,
    prepare_checkpoints,
    tokenize_llamagen,
    visualize_patches,
)
from vector_quantization_tpu_torch.training import checkpoints
from vector_quantization_tpu_torch.training.runner import build_runner
from vector_quantization_tpu_torch.utils import filters
from vector_quantization_tpu_torch.utils.bridge import (
    flax_param_paths,
    flax_tree,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
GOLDEN = str(REPO / "configs/regression/golden_synthetic.py")
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
SMALL = ["--override", "validator.dataset.size=4", "validator.dataloader.batch_size=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the token export and the collage --------------------------------------

@pytest.mark.parametrize("h,w,size", [(32, 32, 24), (40, 29, 16), (16, 16, 16)])
def test_ten_crop_matches_jax(h, w, size):
    from tools.tokenize_llamagen import ten_crop as jax_ten_crop

    img = np.random.default_rng(h * w).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    got, want = tokenize_llamagen.ten_crop(img, size), jax_ten_crop(img, size)
    assert got.shape == (10, size, size, 3) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(got[5:], got[:5, :, ::-1])


@pytest.fixture(scope="module")
def golden_weights(tmp_path_factory):
    """The JAX validator's initial weights on ``golden_synthetic.py``
    (``PRNGKey(3407)``, what the JAX tools tokenize with), as a port
    checkpoint directory for ``--load-model-from``."""
    tmp = tmp_path_factory.mktemp("golden_weights")
    jv = jax_build_runner(jax_load_config(GOLDEN), "validator")
    jv.work_dir = str(tmp / "jax")
    jv.init_state()
    gen = jax.tree_util.tree_map(np.asarray, jv.state.params["generator"])
    port = build_runner(load_config(GOLDEN), "validator", device="cpu", work_dir=str(tmp / "port"))
    port.init_state()
    model = port.state.model
    tree = flax_tree(model, state_dict_from_flax(model, gen))
    path = tmp / "ckpt"
    path.mkdir()
    torch.save({"params": {"generator": tree}}, checkpoints.checkpoint_file(str(path)))
    return str(path)


def test_tokenize_llamagen_matches_jax(golden_weights, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DRY_RUN", "1")  # 8 items at most, as in JAX
    _run_tool("tokenize_llamagen.py", ["golden", GOLDEN, "--out", str(tmp_path / "jax"), "--crop-size", "24",
                                       "--work-dir", str(tmp_path / "wj"), *SMALL])
    tokenize_llamagen.main(["golden", GOLDEN, "--out", str(tmp_path / "port"), "--crop-size", "24",
                            "--work-dir", str(tmp_path / "wp"), "--device", "cpu",
                            "--load-model-from", golden_weights, *SMALL])
    out = capsys.readouterr().out
    assert f"exported 4 items to {tmp_path / 'jax'}" in out and f"exported 4 items to {tmp_path / 'port'}" in out
    jax_files = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*.npy"))
    port_files = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*.npy"))
    assert jax_files == port_files and len(port_files) == 8
    # the port's model, for the near-tie rule
    runner = build_runner(load_config(GOLDEN), "validator", device="cpu", work_dir=str(tmp_path / "wr"))
    runner.init_state()
    runner.load_model_from(golden_weights)
    model, data = runner.state.model, runner.dataloader.dataset
    differ = 0
    for i in range(4):
        for kind in ("codes", "labels"):
            name = f"imagenet24_{kind}/{i}.npy"
            got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if kind == "labels":
                assert np.array_equal(got, want) and want.dtype == np.int64
                continue
            assert got.shape == (10, 12, 12) and got.dtype == np.int32
            if not np.array_equal(got, want):  # only as near-ties of the f32 scores
                crops = torch.from_numpy(np.ascontiguousarray(tokenize_llamagen.ten_crop(data[i].image, 24)))
                q = model.quantizer
                with torch.no_grad():
                    x = model.encode(crops).reshape(-1, q.embedding_dim)
                    x = normalize(x) if q.normalize_inputs else x
                rep = compare_codes(x, q.effective_codebook(), torch.from_numpy(got), torch.from_numpy(want),
                                    q.distance)
                assert rep["ok"], (name, rep)
                differ += rep["differ"]
    assert differ <= 2


def test_visualize_patches_png_matches_jax(golden_weights, tmp_path, capsys):
    tokens = [str(t) for t in range(16)]
    _run_tool("visualize_patches.py", ["golden", GOLDEN, "--tokens", *tokens, "--per-token", "3",
                                       "--out", str(tmp_path / "jax.png"), *SMALL])
    visualize_patches.main(["golden", GOLDEN, "--tokens", *tokens, "--per-token", "3", "--device", "cpu",
                            "--work-dir", str(tmp_path / "w"), "--out", str(tmp_path / "port.png"),
                            "--load-model-from", golden_weights, *SMALL])
    assert f"saved {tmp_path / 'port.png'} (16 tokens)" in capsys.readouterr().out
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


# -- FID and IS of folders -------------------------------------------------

@pytest.fixture(scope="module")
def inception_weights(tmp_path_factory):
    """JAX's Inception at its random init, kernels times sqrt(2): an orbax
    checkpoint for the JAX tools, pytorch-fid's ``.pth`` for the port's."""
    import orbax.checkpoint as ocp

    tmp = tmp_path_factory.mktemp("inception")
    variables = jax.jit(JaxInception().init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * np.sqrt(2.0) if path[-1].key == "kernel" else v, variables["params"])
    variables = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": variables["batch_stats"]})
    with ocp.StandardCheckpointer() as saver:
        saver.save(str(tmp / "orbax"), variables)
    model = InceptionV3Features()
    model.load_state_dict(state_dict_from_flax(model, variables["params"], variables["batch_stats"]), strict=False)
    torch.save(model.state_dict(), tmp / "pt_inception.pth")
    return str(tmp / "orbax"), str(tmp / "pt_inception.pth")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("folders")
    rng = np.random.default_rng(5)
    for name, lo in (("a", 0), ("b", 96)):
        (tmp / name).mkdir()
        for i in range(4):
            img = rng.integers(lo, lo + 160, (40, 36, 3), dtype=np.uint8)
            Image.fromarray(img).save(tmp / name / f"{i}.png")
    (tmp / "a" / "notes.txt").write_text("not an image")
    return tmp


def _last_number(out: str, key: str) -> float:
    line = [ln for ln in out.splitlines() if key in ln][-1]
    return float(line.split(key)[1].split()[0])


def test_fid_and_fidelity_match_jax(inception_weights, folders, tmp_path, capsys):
    orbax_dir, pth = inception_weights
    common = ["--pred", str(folders / "a"), "--batch-size", "2", "--image-size", "32"]
    _run_tool("fid.py", [*common, "--gt", str(folders / "b"), "--inception-weights", orbax_dir,
                         "--out", str(tmp_path / "jax.txt")])
    _run_tool("fidelity.py", [*common, "--inception-weights", orbax_dir, "--splits", "2"])
    out = capsys.readouterr().out
    want_fid, want_is = _last_number(out, "FID="), _last_number(out, "IS: ")
    got_fid = fid.main([*common, "--gt", str(folders / "b"), "--inception-weights", pth, "--device", "cpu",
                        "--out", str(tmp_path / "port.txt")])
    got_is, _ = fidelity.main([*common, "--inception-weights", pth, "--splits", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert abs(got_fid - want_fid) <= max(1e-3 * abs(want_fid), 1e-2), (got_fid, want_fid)
    assert abs(got_is - want_is) <= 1e-4 * want_is, (got_is, want_is)
    assert "fid_random_init" not in out and "(n=4)" in out
    line = (tmp_path / "port.txt").read_text().splitlines()
    assert len(line) == 1 and line[0].startswith(f"{folders / 'a'}: FID=")


def test_random_init_results_are_tagged(folders, tmp_path, capsys):
    common = ["--pred", str(folders / "a"), "--batch-size", "4", "--image-size", "32", "--device", "cpu"]
    out_file = tmp_path / "fid.txt"
    for _ in range(2):
        fid.main([*common, "--gt", str(folders / "b"), "--out", str(out_file)])
    fidelity.main([*common, "--splits", "1"])
    out = capsys.readouterr().out
    assert out.count("WARNING: random inception init") == 3
    lines = out_file.read_text().splitlines()
    assert len(lines) == 2 and all(ln.endswith("fid_random_init") for ln in lines)
    assert [ln for ln in out.splitlines() if ln.startswith("IS: ")][0].endswith("fid_random_init")


# -- EMA extraction --------------------------------------------------------

@pytest.mark.parametrize("ema", [True, False])
def test_model_ema(ema, tmp_path, capsys):
    cfg = load_config(SMOKE)
    cfg.override({"trainer.max_iters": 2, "trainer.callbacks": []})
    if ema:
        cfg.override({"trainer.algorithm.ema_decay": 0.5})
    trainer = build_runner(cfg, "trainer", device="cpu", work_dir=str(tmp_path / "train"))
    trainer.run()
    trainer.save_checkpoint(2)
    src = checkpoints.checkpoint_path(str(tmp_path / "train"), 2)
    if not ema:
        with pytest.raises(SystemExit, match="^checkpoint has no extra/ema_params$"):
            model_ema.main([src, str(tmp_path / "out")])
        return
    model_ema.main([src, str(tmp_path / "out")])
    assert f"saved EMA params to {tmp_path / 'out'}" in capsys.readouterr().out
    shadow = trainer.state.extra["ema_params"]
    assert not all(torch.equal(p, shadow[n]) for n, p in trainer.state.model.named_parameters())
    fresh = build_runner(load_config(SMOKE), "validator", device="cpu", work_dir=str(tmp_path / "val"))
    fresh.init_state()
    fresh.load_model_from([str(tmp_path / "out")])
    for name, p in fresh.state.model.named_parameters():
        assert torch.equal(p, shadow[name]), name


# -- weight conversion -----------------------------------------------------

def _save(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
                for k, v in sd.items()}, path)
    return str(path)


def _config(tmp_path, key, module):
    path = tmp_path / "check.py"
    path.write_text(f"trainer = dict(algorithm=dict({key}={module!r}))\n")
    return str(path)


_TAMING_MODEL = dict(
    type="AutoencoderModel",
    encoder=dict(type="VQGANEncoder", width=32, depth_mult=2, out_channels=8),
    post_encode=dict(type="ConvConnector", out_channels=8),
    quantizer=dict(type="VectorQuantizer", codebook_size=16, embedding_dim=8),
    pre_decode=dict(type="ConvConnector", out_channels=8),
    decoder=dict(type="VQGANDecoder", width=32, depth_mult=3, in_channels=8),
)
_WIDTHS = dict(vocabulary_size=40, hidden_size=32, num_layers=2, num_heads=2, max_length=16)


def _family(kind, tmp_path):
    """(argv after the kind, the config key and module for --check, or None)."""
    if kind == "taming_vqgan":
        src = _taming.synthetic_checkpoint(str(tmp_path / "last.ckpt"), width=32, mults=(1, 1, 2, 2, 4))
        return ["--src", src], ("model", _TAMING_MODEL)
    if kind == "gpt2":
        return ["--src", _save(_fake(_gpt2_shapes(), 8), tmp_path / "gpt2.bin")], (
            "transformer", dict(type="GPT2Transformer", **_WIDTHS))
    if kind == "hf_llama":
        return ["--src", _save(_fake(_llama_shapes(head=True), 10), tmp_path / "llama.pth")], (
            "transformer", dict(type="LlamaTransformer", ffn_dim=64, **_WIDTHS))
    if kind == "clip_visual":
        return ["--src", _save(_fake(_clip_shapes(16), 6), tmp_path / "clip.pt")], (
            "teacher", dict(type="CLIPTeacher", patch_size=8, proj_dim=16, embed_dim=32, depth=2, num_heads=1,
                            img_size=32))
    if kind == "vgg16_lpips":
        vgg, lin = _vgg_and_lin(4)
        return ["--src", _save(vgg, tmp_path / "vgg16.pth"), "--lin", _save(lin, tmp_path / "vgg.pth")], None
    assert kind == "pt_inception"
    rng = np.random.default_rng(3)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)) if v.is_floating_point()
          else v for k, v in InceptionV3Features().state_dict().items()}
    sd.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
               "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    return ["--src", _save(sd, tmp_path / "pt_inception.pth")], None


@pytest.mark.parametrize("kind", list(convert_weights.KINDS))
def test_convert_weights_check(kind, tmp_path, capsys):
    argv, target = _family(kind, tmp_path)
    check = ["--check", _config(tmp_path, *target)] if target else []
    path = convert_weights.main([kind, *argv, "--out", str(tmp_path / "out"), *check])
    out = capsys.readouterr().out
    assert "check OK" in out and path == str(tmp_path / "out" / f"{kind}.pth")
    sd = torch.load(path, weights_only=True)
    if target:
        key, module_cfg = target
        from vector_quantization_tpu_torch.registries import ModelRegistry, TeacherRegistry, TransformerRegistry

        registry = {"model": ModelRegistry, "transformer": TransformerRegistry, "teacher": TeacherRegistry}[key]
        try:
            module = registry.build(module_cfg, device="cpu")
        except TypeError:
            module = registry.build(module_cfg)
        module.load_state_dict(sd, strict=True)
    elif kind == "pt_inception":
        assert not any(k.startswith(("fc.", "AuxLogits.")) for k in sd)
        InceptionV3Features().load_state_dict(sd, strict=False)


def test_convert_weights_check_refuses_other_widths(tmp_path, capsys):
    argv, (key, module) = _family("taming_vqgan", tmp_path)
    module = {**module, "quantizer": dict(type="VectorQuantizer", codebook_size=32, embedding_dim=8)}
    with pytest.raises(SystemExit) as e:
        convert_weights.main(["taming_vqgan", *argv, "--out", str(tmp_path / "out"),
                              "--check", _config(tmp_path, key, module)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "SHAPE MISMATCH (1):" in out and "quantizer.codebook: model (32, 8) vs converted (16, 8)" in out
    assert not (tmp_path / "out").exists()


def test_prepare_checkpoints(tmp_path, capsys):
    prepare_checkpoints.main(["--src-dir", str(tmp_path / "none"), "--out-dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "pt_inception-2015-12-05-6726825d.pth" in out and "nothing converted" in out
    src = tmp_path / "downloads"
    src.mkdir()
    argv, _ = _family("pt_inception", tmp_path)
    os.replace(argv[1], src / "pt_inception-2015-12-05-6726825d.pth")
    (src / "unrelated.bin").write_bytes(b"")
    prepare_checkpoints.main(["--src-dir", str(src), "--out-dir", str(tmp_path / "out")])
    assert "-m vector_quantization_tpu_torch.tools.convert_weights pt_inception" in capsys.readouterr().out
    assert (tmp_path / "out" / "inception" / "pt_inception.pth").is_file()


# -- merge_params and the filters against JAX's ----------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"enc": {"conv": {"kernel": rng.standard_normal((3, 2)).astype(np.float32),
                             "bias": rng.standard_normal(2).astype(np.float32)}},
            "codebook": rng.standard_normal((4, 2)).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("src", [
    {"codebook": np.ones((4, 2), np.float32)},
    {"enc": {"conv": {"bias": np.full(2, 3.0, np.float32)}}, "decoder": {"w": np.ones(1, np.float32)}},
    {"enc": {"conv": {"kernel": np.zeros((3, 2), np.float32), "extra": np.ones(2, np.float32)}}},
])
def test_merge_params_matches_jax(src, capsys):
    want = jax_checkpoints.merge_params(jax.tree_util.tree_map(jnp.asarray, _tree(0)), src)
    jax_out = capsys.readouterr().out
    live = _to_torch(_tree(0))
    got = checkpoints.merge_params(live, _to_torch(src))
    assert capsys.readouterr().out == jax_out  # the same "ignoring unknown key" lines
    assert _leaves(got).keys() == _leaves(want).keys()
    for k, v in _leaves(want).items():
        assert np.array_equal(_leaves(got)[k], v), k
    assert got is live  # in place, the live tensors
    with pytest.raises(ValueError, match="codebook"):
        checkpoints.merge_params(live, {"codebook": torch.ones(5, 2)})


@pytest.mark.parametrize("filt", ["kernel", {"prefixes": ["enc/"]}, {"names": ["codebook"]},
                                  {"regexes": [r"conv/\w+$"], "suffixes": ["book"]}])
def test_partition_params_matches_jax(filt):
    tree = _tree(1)
    want = jax_filters.partition_params(tree, filt)
    got = filters.partition_params(_to_torch(tree), filt)
    for w, g in zip(want, got):
        assert list(g) == list(w)
        assert all(np.array_equal(g[k].numpy(), w[k]) for k in w)
    assert list(filters.filter_state_dict(_to_torch(tree), filt)) == list(jax_filters.filter_state_dict(tree, filt))
    path = [jax.tree_util.DictKey("enc"), jax.tree_util.SequenceKey(0), "x"]
    assert filters.path_str(path) == jax_filters.path_str(path) == "enc/0/x"


def test_partition_params_of_a_module_uses_flax_paths(tmp_path):
    runner = build_runner(load_config(GOLDEN), "validator", device="cpu", work_dir=str(tmp_path))
    runner.init_state()
    model = runner.state.model
    tree = params_to_flax(model)
    for filt in ("GroupNorm", {"prefixes": ["decoder/"]}, {"names": ["quantizer/codebook"]}):
        want = jax_filters.partition_params(tree, filt)
        got = filters.partition_params(model, filt)
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        assert all(tuple(got[0][k].shape) == tuple(model.get_parameter(n).shape)
                   for n, k in flax_param_paths(model).items() if k in got[0])
