"""The port's runner, checkpoints and load modes on the CPU, held against
the JAX package where it has a counterpart.

- Checkpoints round-trip bit for bit for VQGAN (GAN, EMA, LPIPS, the
  discriminator's BatchNorm), VQ-KD (the teacher, the lazy init, the
  optimizer's ``exclude`` mask), Cluster (CVQ's ``probability``) and AR
  (the tokenizer in ``extra``): restored into another algorithm's live
  tensors, the whole state equals the saved one, and one more step on each
  gives equal states.
- ``load_model_from A B`` merges in order and ignores unknown keys with the
  JAX package's message; ``load_ir_from`` leaves the tokenizer unchanged on a
  VQGAN or reconstruction checkpoint in both packages (the JAX one saved by
  the JAX package's ``save_checkpoint``), naming the same ignored keys.
- The trainer takes the JAX runner's batches, also after a resume.
- The ``self_trained_smoke`` anchor through the port's ``Trainer`` and
  ``Validator`` (see ``test_self_trained_smoke_anchor`` for its tolerance).
"""

import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms  # noqa: F401  (registers the JAX algorithms)
import vector_quantization_tpu.training.callbacks  # noqa: F401
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.training import checkpoints as jax_ckpt
from vector_quantization_tpu.training.runner import build_runner as jax_build_runner
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.parallel.mesh import make_mesh
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, StrategyRegistry
from vector_quantization_tpu_torch.training import callbacks
from vector_quantization_tpu_torch.training import checkpoints as ckpt
from vector_quantization_tpu_torch.training.runner import build_runner
from vector_quantization_tpu_torch.utils.bridge import (
    batch_stats_to_flax,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import Config, load_config
from test_torch_vqkd import CLUSTER, VQKD, _algorithm_cfg  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
AR = str(REPO / "configs/regression/ar_anchor.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores (7x slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(cfg, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AlgorithmRegistry.build(cfg, device="cpu")


def _vqgan_cfg(**over):
    cfg = dict(Config.load(SMOKE)["trainer"]["algorithm"])
    return dict(cfg, **over)


def _images(seed, b, s=32):
    u8 = np.random.default_rng(seed).integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    return u8, torch.from_numpy(u8.astype(np.float32) / 127.5 - 1.0)


def _batch(kind, seed):
    u8, image = _images(seed, 2)
    batch = {"image": image}
    if kind in ("vqkd", "cluster"):
        batch["original_image"] = torch.from_numpy(u8)
    if kind == "ar":
        batch["category"] = torch.tensor([1, 7], dtype=torch.int32)
    return batch


ALGORITHMS = {
    "vqgan": lambda: _vqgan_cfg(ema_decay=0.9, recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)),
                                codebook_update=dict(type="normalize")),
    "vqkd": lambda: _algorithm_cfg(Config.load, VQKD, port=True),
    "cluster": lambda: _algorithm_cfg(Config.load, CLUSTER, port=True),
    "ar": lambda: dict(Config.load(AR)["trainer"]["algorithm"]),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        else:
            assert g == w, (name, g, w)


@pytest.mark.parametrize("kind", sorted(ALGORITHMS))
def test_checkpoint_round_trip_is_bit_for_bit(kind, tmp_path):
    cfg = ALGORITHMS[kind]()
    a, b = _build(cfg, 0), _build(cfg, 1)
    sa = a.init_state(3)
    sa, _ = a.train_step(sa, _batch(kind, 0))
    path = ckpt.save_checkpoint(str(tmp_path), a, sa, sa.step)
    assert path.endswith("checkpoints/iter_1") and ckpt.latest_checkpoint(str(tmp_path)) == path
    sb = b.init_state(4)
    live = dict(_leaves(ckpt.state_tree(b, sb)))
    assert ckpt.restore_checkpoint(path, b, sb) is sb
    _assert_trees_equal(ckpt.state_tree(b, sb), ckpt.state_tree(a, sa))
    after = dict(_leaves(ckpt.state_tree(b, sb)))
    for name, t in live.items():  # written in place: the modules still own the state's tensors
        if isinstance(t, torch.Tensor) and name != "/rng":
            assert after[name] is t, name
    sa, ma = a.train_step(sa, _batch(kind, 1))
    sb, mb = b.train_step(sb, _batch(kind, 1))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    _assert_trees_equal(ckpt.state_tree(b, sb), ckpt.state_tree(a, sa))


def test_restore_refuses_another_layout(tmp_path):
    a = _build(_vqgan_cfg(ema_decay=0.9), 0)
    path = ckpt.save_checkpoint(str(tmp_path), a, a.init_state(0), 0)
    b = _build(_vqgan_cfg(), 0)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore_checkpoint(path, b, b.init_state(0))
    c = _build(_vqgan_cfg(model=dict(_vqgan_cfg()["model"], quantizer=dict(
        _vqgan_cfg()["model"]["quantizer"], codebook_size=32))), 0)
    with pytest.raises(ValueError, match="codebook"):
        ckpt.restore_checkpoint(path, c, c.init_state(0))


def _save_params(path, params):
    Path(path).mkdir(parents=True)
    torch.save({"params": params}, str(Path(path) / "state.pt"))


def test_load_model_from_merges_in_order(tmp_path, capsys):
    a, b, c = (_build(_vqgan_cfg(), s) for s in (0, 1, 2))
    sa = a.init_state(0)
    first = ckpt.save_checkpoint(str(tmp_path / "a"), a, sa, 5)
    codebook = torch.full_like(a.model.quantizer.codebook, 0.25)
    _save_params(tmp_path / "b", {"generator": {"quantizer": {"codebook": codebook}, "unknown": {"w": codebook}},
                                  "other": {"x": codebook}})
    capsys.readouterr()
    sc = c.init_state(0)
    template = c.param_tree(sc)
    assert ckpt.load_model_from([first, str(tmp_path / "b")], template) is template
    out = capsys.readouterr().out.splitlines()
    assert out == ["[load_model_from] ignoring unknown key 'unknown'",
                   "[load_model_from] ignoring unknown key 'other'"]
    for (name, got), (_, want) in zip(_leaves(c.param_tree(sc)), _leaves(a.param_tree(sa))):
        assert torch.equal(got, codebook if name == "/generator/quantizer/codebook" else want), name
    assert not torch.equal(b.model.quantizer.codebook, codebook)


def _jax_state_of(algo, state, recon):
    """The port's weights as a JAX TrainState (flax layouts), for the JAX
    package's ``save_checkpoint``."""
    gen = params_to_flax(algo.model)
    if recon:
        params, extra = gen, {}
    else:
        params = {"generator": gen, "discriminator": params_to_flax(algo.discriminator)}
        extra = {"d_batch_stats": batch_stats_to_flax(algo.discriminator)}
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState.create(params=tree, opt_state={"mu": tree}, rng=jax.random.PRNGKey(0),
                                extra=jax.tree_util.tree_map(jnp.asarray, extra))


@pytest.mark.parametrize("source", ["vqgan", "reconstruction"])
def test_load_ir_from_matches_jax(source, tmp_path, capsys):
    """JAX's ``load_ir_from`` merges a checkpoint's ``params`` over
    ``{"params": ir_params}``: no key of a tokenizer checkpoint's ``params``
    matches, so the tokenizer comes back unchanged in both packages."""
    recon = source == "reconstruction"
    cfg = _vqgan_cfg()
    if recon:
        cfg = {k: v for k, v in cfg.items() if k not in ("discriminator", "d_optimizer")}
        cfg["type"] = "ReconstructionAlgorithm"
    tok = _build(cfg, 0)
    tok_state = tok.init_state(0)
    port_path = ckpt.save_checkpoint(str(tmp_path / "port"), tok, tok_state, 3)
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), _jax_state_of(tok, tok_state, recon), 3)

    ar = _build(dict(Config.load(AR)["trainer"]["algorithm"]), 0)
    state = ar.init_state(0)
    ir_before = params_to_flax(ar.ir_model)
    jalgo = JaxAlgorithmRegistry.build(jax_load_config(AR)["trainer"]["algorithm"])
    jstate = JaxTrainState.create(params={}, opt_state=(), rng=jax.random.PRNGKey(0),
                                  extra={"ir_params": jax.tree_util.tree_map(jnp.asarray, ir_before)})
    capsys.readouterr()
    jstate = jalgo.load_ir_from(jstate, jax_path)
    jax_said = capsys.readouterr().out.splitlines()
    assert ar.load_ir_from(state, port_path) is state
    port_said = capsys.readouterr().out.splitlines()
    want = ["encoder", "quantizer", "decoder"] if recon else ["generator", "discriminator"]
    assert sorted(port_said) == sorted(jax_said) == sorted(
        f"[load_model_from] ignoring unknown key {k!r}" for k in want)
    want = dict(_leaves(ir_before))
    for got in (params_to_flax(ar.ir_model), jstate.extra["ir_params"]):
        got = dict(_leaves(jax.tree_util.tree_map(np.asarray, dict(got))))
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _recording_trainer(cfg, work_dir, seen):
    """A trainer whose steps only record their batch and count."""
    trainer = build_runner(cfg, "trainer", device="cpu", work_dir=str(work_dir))

    def recorded(state, batch):
        seen.append(batch["image"].clone())
        state.step += 1
        return state, {}

    trainer.algorithm.train_step = recorded
    return trainer


def test_trainer_takes_the_jax_runners_batches(tmp_path):
    cfg = load_config(SMOKE)
    cfg.override({"trainer.max_iters": 6, "trainer.callbacks": [dict(type="CheckpointCallback", interval=3)]})
    jt = jax_build_runner(jax_load_config(SMOKE), "trainer")
    jt.work_dir = str(tmp_path / "jax")
    jt.dataloader.epoch += 1  # JAX's init_state draws one batch from a fresh epoch
    want = [b["image"] for b in itertools.islice(jt._batches(), 6)]
    seen = []
    _recording_trainer(cfg, tmp_path / "a", seen).run()
    assert len(seen) == 6 and all(np.array_equal(s.numpy(), w) for s, w in zip(seen, want))
    resumed, seen = _recording_trainer(cfg, tmp_path / "a", seen := []), seen
    resumed.resume(str(tmp_path / "a/checkpoints/iter_3"))
    resumed.run()
    assert resumed.start_step == 3 and resumed.state.step == 6
    assert len(seen) == 3 and all(np.array_equal(s.numpy(), w) for s, w in zip(seen, want[3:]))


def test_self_trained_smoke_anchor(tmp_path):
    """``configs/regression/smoke_anchor.py``: the port's ``Trainer``, from
    the JAX algorithm's ``init_state(PRNGKey(3407), first batch)`` weights
    (bridged), 20 iterations in the loader's order, then the ``Validator``.

    Tolerance: each metric within 1e-2 of the recorded value, relative, and
    the codebook usage within one code of 64. The steps agree with JAX's to
    4 digits in every loss through step 8; from step 9 they drift apart,
    because Adam turns the generator's rounding-noise gradients (ROADMAP C:
    the biases a one-channel GroupNorm cancels) into full steps of either
    sign. After 20 steps the port sat 1.3e-3 (PPL), 2.3e-4 (L1), 1.2e-4
    (MSE), 4.2e-3 (PSNR, dB) and 1.3e-3 (SSIM) from the record, at most
    3.5e-3 relative; the JAX package itself, run the same way today, sits
    up to 3.2e-3 (PPL) from its own record. 1e-2 leaves about 3x room over
    the worst and still fails a wrong data order or a wrong step (the first
    step's loss moves by 1e-1 with another batch)."""
    recorded = json.loads((REPO / "BASELINE.json").read_text())["published"]["self_trained_smoke"]["metrics"]
    jt = jax_build_runner(jax_load_config(SMOKE), "trainer")
    jt.work_dir = str(tmp_path / "jax")
    # the JAX runner's init_state, compiled without XLA's optimisation passes
    # (eager takes ~25 s on the CPU, optimised ~8 s, this ~3 s; the three
    # agree within one f32 ulp, 6e-8 at most)
    first = {k: v for k, v in next(iter(jt.dataloader)).items() if k != "id_"}
    key = jax.random.PRNGKey(3407)
    init = jax.jit(jt.algorithm.init_state).lower(key, first).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    jstate = init(key, first)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.extra["d_batch_stats"])
    cfg = load_config(SMOKE)
    trainer = build_runner(cfg, "trainer", device="cpu", work_dir=str(tmp_path / "port"))
    trainer.init_state()
    algo = trainer.algorithm
    algo.model.load_state_dict(state_dict_from_flax(algo.model, params["generator"]))
    algo.discriminator.load_state_dict(state_dict_from_flax(algo.discriminator, params["discriminator"], stats))
    state = trainer.run()
    assert state.step == 20
    validator = build_runner(cfg, "validator", device="cpu", work_dir=str(tmp_path / "port"))
    validator.init_state()
    got = validator.run(state)
    assert set(got) == set(recorded)
    assert abs(got["codebook_usage"] - recorded["codebook_usage"]) <= 1 / 64
    for name, want in recorded.items():
        assert abs(got[name] - want) <= 1e-2 * abs(want), (name, got[name], want)


def test_validator_dumps_visuals(tmp_path):
    cfg = load_config(SMOKE)
    for mode, n in (("batched", 2), ("unbatched", 16)):
        v = build_runner(cfg, "validator", device="cpu", work_dir=str(tmp_path / mode))
        v.visual = {"keys": ["pred", "missing"], "mode": mode}
        v.run()
        assert len(list((tmp_path / mode / "visuals").glob("pred_*.png"))) == n


def test_build_runner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_runner(load_config(SMOKE), "trainer")


def test_multi_device_strategies_raise():
    assert make_mesh({"dp": -1}).shape == make_mesh().shape == {"dp": 1}
    for axes in ({"dp": -1, "fsdp": 2}, {"dp": 2}, {"dp": -1, "tp": 2}):
        with pytest.raises(NotImplementedError, match="Parallelism"):
            make_mesh(axes)
    for name in ("FSDPStrategy", "TPStrategy"):
        with pytest.raises(NotImplementedError, match="Parallelism"):
            StrategyRegistry.build({"type": name})
    for name in ("SingleDeviceStrategy", "DataParallelStrategy"):
        batch = StrategyRegistry.build({"type": name}, device="cpu").shard_batch(
            {"image": np.ones((2, 3), np.float32), "category": np.arange(2, dtype=np.int32)})
        assert batch["image"].dtype == torch.float32 and batch["category"].tolist() == [0, 1]


def test_log_and_tensorboard_read_metrics_only_at_their_interval(monkeypatch, tmp_path):
    reads = []
    scalars = callbacks._scalars
    monkeypatch.setattr(callbacks, "_scalars", lambda m: reads.append(1) or scalars(m))

    class Runner:
        max_iters, work_dir = 7, str(tmp_path)

    log, tb = callbacks.LogCallback(interval=3), callbacks.TensorBoardCallback(interval=5)
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)  # not installed
    for cb in (log, tb):
        cb.bind(Runner())
        cb.before_run()
    assert tb._writer is None
    for step in range(1, 8):
        for cb in (log, tb):
            cb.after_run_iter(step, {"loss": torch.tensor(float(step))})
    assert len(reads) == 3  # LogCallback at 3, 6 and the last step; TensorBoard skipped


def test_profile_and_git_callbacks_write_their_files(tmp_path):
    cfg = load_config(SMOKE)
    cfg.override({"trainer.max_iters": 3, "trainer.callbacks": [
        dict(type="ProfileCallback", start=1, steps=1), dict(type="GitCallback"), dict(type="SyncCheckCallback")]})
    trainer = build_runner(cfg, "trainer", device="cpu", work_dir=str(tmp_path))
    assert trainer.run().step == 3
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "git.diff").exists()
