"""The VQGAN + VQ-KD hybrid (``VQGANVQKDModel``, ``VQGANVQKDAlgorithm``)
against the JAX package, on the CPU, at a tiny width: the smoke anchor's
VQGAN (32 px, 16 x 16 grid, 64 x 16 codebook, PatchGAN width 16), LPIPS,
a ``ConvConnector`` and a one-block ``ViTDecoder`` (width 32, 16
features) on the quantized features, and a one-block CLIP teacher (patch
8, projection 16) whose 4 x 4 map the bicubic resize takes to the
decoder's 16 x 16 grid, f32.

The same numpy-made weights reach both packages through ``utils/bridge.py``
(the generator with its branch, the discriminator and its running
statistics, LPIPS, the teacher), and the same batches (``image`` and the
uint8 ``original_image`` the teacher reads). Two ``train_step``s with the
GAN gates off (step 0) and two with them on (step 20,000): every metric
(``loss_distill`` among them) within 1e-4 relative, every parameter of
both models, Adam's moments and the discriminator's statistics within 1e-4
of max|ref|, where the elements whose first-step JAX gradient is f32
rounding noise are held to Adam's bound (2 steps x 2 x 1.1 lr, ROADMAP
queue C) as in ``tests/test_torch_vqgan_train.py``; the teacher unchanged.
The codebook update is the hybrid's default EMA k-means in both packages;
a config's own update wins in both. The branch runs once a step: in the
generation hook, never through the model's forward.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.exp_vqgan_vqkd  # noqa: F401  (registers the JAX hybrid)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.training.checkpoints import restore_checkpoint, save_checkpoint
from vector_quantization_tpu_torch.utils.bridge import (
    batch_stats_to_flax,
    extra_from_flax,
    flax_param_shapes,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import Config
from test_torch_vqgan_train import (  # noqa: E402
    NOISE_REL,
    REL,
    _adam_moments,
    _batch_stats,
    _check_second_gradients,
    _close_trees,
    _flat_copy,
    _mu_tree,
    _noise,
    _numpy_params,
    _synthetic_batches,
)

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
TEACHER = dict(type="CLIPTeacher", patch_size=8, proj_dim=16, embed_dim=32, depth=1, num_heads=2, output_size=16)
_JAX_STEP: list = []


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hybrid_cfg(load, port: bool, **override):
    cfg = dict(load(SMOKE)["trainer"]["algorithm"])
    model = dict(cfg["model"], type="VQGANVQKDModel", vqkd_pre_decode=dict(type="ConvConnector"),
                 vqkd_decoder=dict(type="ViTDecoder", img_size=16, patch_size=1, in_channels=8, out_channels=16,
                                   embed_dim=32, depth=1, num_heads=2))
    teacher = dict(TEACHER, **({"img_size": 32} if port else {}))
    cfg.update(type="VQGANVQKDAlgorithm", model=model, teacher=teacher, distill_weight=0.5,
               recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)), discriminator_start=20_000, **override)
    return cfg


def _batches():
    out = []
    for image in _synthetic_batches(2):
        u8 = np.clip(np.round((image + 1.0) * 127.5), 0, 255).astype(np.uint8)
        out.append({"image": image, "original_image": u8})
    return out


def _pair(seed=0):
    jalgo = JaxAlgorithmRegistry.build(_hybrid_cfg(jax_load_config, port=False))
    algo = AlgorithmRegistry.build(_hybrid_cfg(Config.load, port=True), device="cpu")
    g = _numpy_params(flax_param_shapes(algo.model), seed)
    d = _numpy_params(flax_param_shapes(algo.discriminator), seed + 1)
    stats = _batch_stats(algo.discriminator, seed + 2)
    lp = _numpy_params(flax_param_shapes(algo.lpips_module), seed + 3)
    teacher = _numpy_params(flax_param_shapes(algo.teacher), seed + 4)
    algo.model.load_state_dict(state_dict_from_flax(algo.model, g))
    algo.discriminator.load_state_dict(state_dict_from_flax(algo.discriminator, d, stats))
    algo.lpips_module.load_state_dict(state_dict_from_flax(algo.lpips_module, lp))
    state = algo.init_state(0)
    extra = {"d_batch_stats": stats, "lpips_params": lp, "teacher_params": teacher}
    extra_from_flax(algo, state, extra)
    jstate = JaxTrainState.create(
        params={"generator": g, "discriminator": d}, opt_state=jalgo.tx(g).init(g),
        d_opt_state=jalgo.d_tx(d).init(d), rng=jax.random.PRNGKey(0), extra=extra)
    if not _JAX_STEP:
        _JAX_STEP.append(jax.jit(jalgo.train_step))
    return jalgo, jax.tree_util.tree_map(jnp.asarray, jstate), algo, state


@pytest.mark.parametrize("start", [0, 20_000], ids=["gates_off", "gan_on"])
def test_hybrid_two_train_steps_match_jax(start):
    jalgo, jstate, algo, state = _pair()
    assert algo.codebook_update == jalgo.codebook_update == {"type": "kmeans", "decay": 0.99}
    jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
    state.step = start
    teacher = {k: v.clone() for k, v in algo.teacher.state_dict().items()}
    forwards = []
    algo.model.register_forward_hook(lambda *a: forwards.append(1))
    branch = []
    algo.model.vqkd_decoder.register_forward_hook(lambda *a: branch.append(1))
    pairs = ((algo.model, "opt_state", "g", algo.optimizer_cfg),
             (algo.discriminator, "d_opt_state", "d", algo.d_optimizer_cfg))
    for i, batch in enumerate(_batches()):
        jstate, jm = _JAX_STEP[0](jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm) and "loss_distill" in m, set(m) ^ set(jm)
        for name in jm:
            want = float(jm[name])
            assert abs(float(m[name]) - want) <= REL * max(abs(want), 1e-6), (i, name, float(m[name]), want)
        if i == 0:
            noise, mu1 = {}, {}
            for module, opt, what, _ in pairs:
                jmu, mu = _adam_moments(getattr(jstate, opt))[0], _mu_tree(module, getattr(state, opt))
                noise[what], top = _noise(jmu)
                mine, _ = _noise(mu, 10 * NOISE_REL)
                assert all(mine[k][noise[what][k]].all() for k in mine), (what, "port gradient not noise")
                noise[what + "_g"] = 10 * NOISE_REL * top / 0.5
                mu1[what] = _flat_copy(jmu), _flat_copy(mu)
        else:
            for module, opt, what, opt_cfg in pairs:
                jmu, mu = _adam_moments(getattr(jstate, opt))[0], _mu_tree(module, getattr(state, opt))
                _check_second_gradients((mu1[what][0], jmu), (mu1[what][1], mu), noise[what],
                                        opt_cfg["betas"][0], what)
    assert (len(forwards), len(branch)) == (0, 2)  # the branch in the hook only, once a step
    assert state.step == start + 2 and float(m["loss_distill"]) > 0
    assert all(torch.equal(teacher[k], v) for k, v in algo.teacher.state_dict().items())
    _close_trees(batch_stats_to_flax(algo.discriminator, state.extra["d_batch_stats"]),
                 jstate.extra["d_batch_stats"], "batch_stats")
    for module, opt, what, opt_cfg in pairs:
        mask, g_noise = noise[what], noise[what + "_g"]
        step_tol = 2 * 2 * 1.1 * opt_cfg["lr"]
        params = jstate.params["generator" if what == "g" else "discriminator"]
        _close_trees(params_to_flax(module), params, f"{what} params", mask, step_tol)
        jmu, jnu = _adam_moments(getattr(jstate, opt))
        _close_trees(_mu_tree(module, getattr(state, opt)), jmu, f"{what} adam mu", mask, 2 * g_noise)
        _close_trees(_mu_tree(module, getattr(state, opt), "nu"), jnu, f"{what} adam nu", mask, 2 * g_noise**2)


def test_hybrid_config_update_wins_and_forward_adds_the_branch():
    """A config's own ``codebook_update`` wins over the hybrid's default in
    both packages; the model's forward (the eval path) adds ``vqkd_pred``."""
    normalize = dict(codebook_update=dict(type="normalize"))
    jalgo = JaxAlgorithmRegistry.build(_hybrid_cfg(jax_load_config, port=False, **normalize))
    algo = AlgorithmRegistry.build(_hybrid_cfg(Config.load, port=True, **normalize), device="cpu")
    assert algo.codebook_update == jalgo.codebook_update == {"type": "normalize"}
    pd = algo.model.vqkd_pre_decode.conv
    assert (pd.in_channels, pd.out_channels) == (16, 8)  # the codebook's width -> the decoder's in_channels
    out = algo.model(torch.from_numpy(_batches()[0]["image"]), train=False)
    assert out["vqkd_pred"].shape == (4, 16, 16, 16) == algo.teacher(torch.from_numpy(
        _batches()[0]["original_image"]), return_2d=True).shape


def test_hybrid_checkpoint_carries_the_teacher(tmp_path):
    algo = AlgorithmRegistry.build(_hybrid_cfg(Config.load, port=True), device="cpu")
    state = algo.init_state(0)
    path = save_checkpoint(str(tmp_path), algo, state, 0)
    other = AlgorithmRegistry.build(_hybrid_cfg(Config.load, port=True), device="cpu")
    with torch.no_grad():
        for p in other.teacher.parameters():
            p.zero_()
    restored = restore_checkpoint(path, other, other.init_state(0))
    assert all(torch.equal(a, b) for a, b in zip(algo.teacher.parameters(), other.teacher.parameters()))
    assert "teacher_params" in restored.extra
