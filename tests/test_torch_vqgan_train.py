"""VQGAN tokenizer training through the port's entry points against the
JAX package, on the CPU, at the smoke anchor's widths
(``configs/regression/smoke_anchor.py``: width 32, codebook 64 x 16,
PatchGAN width 16 depth 2) and 32 px, f32.

The same numpy-made weights reach both packages (flax layout; the port
loads them through ``utils/bridge.py``), and the same batches go through
both (numpy; the train steps take ``SyntheticDataset`` images). Held
within 1e-4 of max|ref| (per tensor; per scalar its own magnitude):
- the recon losses (L1, MSE, cosine, PSNR, SSIM), the GAN losses and R1;
- LPIPS; PatchGAN's train and eval logits and its ``batch_stats`` after a
  train pass (flax's biased variance, momentum 0.99);
- ``ReconstructionAlgorithm.train_step`` (two steps);
- two consecutive ``VQGANAlgorithm.train_step``s: every metric, the
  updated generator and discriminator weights, the BatchNorm running
  statistics, both optimizers' Adam moments and the EMA shadow, with the
  gates off, GAN on (``vanilla``, ``l1`` + ``lpips``), ``non_saturating``
  with R1 and ``aglw_gain=None``, and ``codebook_update=normalize`` with
  ``ema_decay``;
- ``eval_step`` and the validation metrics against JAX's metric classes
  on the same memo.

One exception, by rule: an element whose first-step gradient in JAX is f32
rounding noise (within 1e-6 of its module's largest; the port's must then
be noise too) has no defined direction, and Adam's ``m / (sqrt(v) + eps)``
turns the noise into a full step of either sign. At these widths that is
every bias that a GroupNorm with one channel per group (32 channels)
cancels, and the key part of the attention blocks' ``qkv`` bias (softmax
ignores a key bias). Such elements are held to Adam's bound instead: the
parameters and the EMA within 2 steps x 2 x 1.1 lr, the moments within
twice a noise gradient's (or the leaf's 1e-4). Their second gradient is
held apart: noise in the port where it is noise in JAX, else equal to
JAX's within 1e-4 (a first gradient small by chance, or a code unused at
the first step).

Also: ``SyntheticDataset`` items equal JAX's bit for bit; the
``synthetic_taming_vqgan`` anchor of ``BASELINE.json`` reproduces through
the port's taming remap; the LlamaGen VQGAN algorithm builds from its
config files. Each JAX step is compiled once per configuration.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.vqgan  # noqa: F401  (registers the JAX algorithms)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
import vector_quantization_tpu.training.metrics as jax_metrics
from vector_quantization_tpu.data.datasets import SyntheticDataset as JaxSyntheticDataset
from vector_quantization_tpu.models.discriminators.patchgan import (
    PatchGANDiscriminator as JaxPatchGAN,
)
from vector_quantization_tpu.models.losses import gan as jax_gan
from vector_quantization_tpu.models.losses import recon as jax_recon
from vector_quantization_tpu.models.losses.lpips import LPIPS as JaxLPIPS
from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
from vector_quantization_tpu.registries import ModelRegistry as JaxModelRegistry
from vector_quantization_tpu.training.state import TrainState as JaxTrainState
from vector_quantization_tpu.utils import converters as jax_converters
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.data.datasets import SyntheticDataset, collate
from vector_quantization_tpu_torch.models.discriminators.patchgan import PatchGANDiscriminator
from vector_quantization_tpu_torch.models.losses import gan, recon
from vector_quantization_tpu_torch.models.losses.lpips import LPIPS
from vector_quantization_tpu_torch.registries import AlgorithmRegistry, MetricRegistry, ModelRegistry
from vector_quantization_tpu_torch.utils.bridge import (
    batch_stats_to_flax,
    flax_param_shapes,
    params_to_flax,
    state_dict_from_flax,
)
from vector_quantization_tpu_torch.utils.config import Config
from vector_quantization_tpu_torch.utils.converters import convert_taming_vqgan

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
GOLDEN = str(REPO / "configs/regression/golden_synthetic.py")
LLAMAGEN_VQGAN = str(REPO / "configs/llamagen/vqgan_imagenet_ddp.py")
REL = 1e-4
NOISE_REL = 1e-6  # a gradient this far below its module's largest is f32 rounding noise
BATCH, SIZE = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool spends most of its time
    waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


@pytest.fixture
def _process_torch_threads(_one_torch_thread):
    """The process's own intra-op pool for one test. The two-step VQGAN
    checks hold every metric and Adam moment within 1e-4 of JAX's; the
    adaptive weight (a ratio of two gradient norms at the decoder's last
    conv) and the decoder's moments sit near that bound, and one thread's
    summation order moves them past it (``aglw`` 1.1e-4 relative in the
    ``gan_vanilla`` case), so those checks keep the order they were set
    against."""
    torch.set_num_threads(_one_torch_thread)
    yield
    torch.set_num_threads(1)


def _images(seed, b=BATCH, s=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


def _close(got, want, what, rel=REL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * float(np.abs(want).max(initial=0.0)), (what, err, float(np.abs(want).max(initial=0.0)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _close_trees(got, want, what, noise=None, noise_tol=0.0):
    """Every leaf within 1e-4 of its max|ref|; where ``noise`` (by leaf)
    marks the elements whose first-step reference gradient was rounding
    noise, those elements within ``noise_tol`` or that (and out of the
    leaf's max)."""
    got, want = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, dict(want)))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name in want:
        g, w = np.asarray(got[name], np.float32), want[name]
        mask = np.zeros(w.shape, bool) if noise is None else noise[name]
        tol = max(noise_tol, REL * float(np.abs(w).max()))
        assert float(np.abs(g - w)[mask].max(initial=0.0)) <= tol, (what, name, "noise elements")
        _close(g[~mask], w[~mask], f"{what} {name}")


def _numpy_params(shapes, seed):
    """Flax-layout weights from numpy: kernels N(0, 2/fan_in), biases
    N(0, 0.05²), norm scales 1 + N(0, 0.05²), the codebook N(0, 1)."""
    rng = np.random.default_rng(seed)

    def make(tree, leaf=None):
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        if leaf == "kernel":
            std = np.sqrt(2.0 / np.prod(tree[:-1]))
            return (rng.standard_normal(tree) * std).astype(np.float32)
        if leaf == "scale":
            return (1.0 + rng.normal(0.0, 0.05, tree)).astype(np.float32)
        if leaf == "codebook":
            return rng.standard_normal(tree).astype(np.float32)
        return rng.normal(0.0, 0.05, tree).astype(np.float32)

    return make(shapes)


def _batch_stats(disc, seed):
    rng = np.random.default_rng(seed)
    return {name: {"mean": rng.normal(0.0, 0.1, m.mean.shape).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, m.var.shape).astype(np.float32)}
            for name, m in disc.named_children() if name.startswith("BatchNorm")}


# -- losses, LPIPS, PatchGAN ---------------------------------------------


def test_recon_losses_match_jax():
    rng = np.random.default_rng(0)
    p, t = rng.uniform(0, 1, (2, 2, 16, 16, 3)).astype(np.float32)
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    for name in ("l1_loss", "mse_loss", "cosine_loss", "psnr", "ssim"):
        got = getattr(recon, name)(tp, tt)
        want = getattr(jax_recon, name)(jnp.asarray(p), jnp.asarray(t))
        _close(got, want, name)
    _close(recon.l1_loss(tp, tt, weight=0.5), jax_recon.l1_loss(p, t, weight=0.5), "l1 weight")


def _patchgan_pair(seed=0, width=16, depth=2):
    port = PatchGANDiscriminator(width=width, depth=depth)
    params = _numpy_params(flax_param_shapes(port), seed)
    stats = _batch_stats(port, seed + 1)
    port.load_state_dict(state_dict_from_flax(port, params, stats))
    return port, JaxPatchGAN(width=width, depth=depth), params, stats


def test_gan_losses_and_r1_match_jax():
    rng = np.random.default_rng(1)
    fake, real = rng.standard_normal((2, 4, 6, 6, 1)).astype(np.float32)
    tf, tr = torch.from_numpy(fake), torch.from_numpy(real)
    _close(gan.hinge_d_loss(tf, tr), jax_gan.hinge_d_loss(fake, real), "hinge")
    _close(gan.vanilla_g_loss(tf), jax_gan.vanilla_g_loss(fake), "vanilla")
    _close(gan.non_saturating_g_loss(tf), jax_gan.non_saturating_g_loss(fake), "non_saturating")
    port, jmod, params, stats = _patchgan_pair()
    image = _images(2)
    want = jax_gan.r1_gradient_penalty(
        lambda x: jmod.apply({"params": params, "batch_stats": stats}, x, train=False),
        jnp.asarray(image), 10.0)
    got = gan.r1_gradient_penalty(lambda x: port(x, train=False), torch.from_numpy(image), 10.0)
    _close(got, want, "r1")
    (grads,) = torch.autograd.grad(got, [port.get_parameter("Conv_0.weight")])
    assert torch.isfinite(grads).all() and grads.abs().max() > 0


def test_patchgan_train_and_eval_match_jax():
    port, jmod, params, stats = _patchgan_pair()
    image = _images(3)
    want_eval = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(image), train=False)
    want_train, updates = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(image),
                                     train=True, mutable=["batch_stats"])
    _close(port(torch.from_numpy(image), train=False).detach(), want_eval, "eval logits")
    _close(port(torch.from_numpy(image), train=True).detach(), want_train, "train logits")
    _close_trees(batch_stats_to_flax(port), updates["batch_stats"], "batch_stats")
    assert _flat(params_to_flax(port)).keys() == _flat(params).keys()


def test_lpips_matches_jax():
    port = LPIPS()
    params = _numpy_params(flax_param_shapes(port), 4)
    port.load_state_dict(state_dict_from_flax(port, params))
    assert not any(p.requires_grad for p in port.parameters())
    pred, target = _images(5, b=2), _images(6, b=2)
    want = JaxLPIPS().apply({"params": params}, jnp.asarray(pred), jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = port(tp, torch.from_numpy(target))
    _close(got.detach(), want, "lpips")
    (g,) = torch.autograd.grad(got, tp)
    (gj,) = jax.grad(lambda p: JaxLPIPS().apply({"params": params}, p, jnp.asarray(target)),
                     argnums=(0,))(jnp.asarray(pred))
    _close(g, gj, "lpips gradient wrt pred")


# -- train steps ---------------------------------------------------------

# (config overrides, step the two steps start at); gates_off and gan_vanilla
# share one configuration, so one JAX compile
CASES = {
    "gates_off": (dict(recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)),
                       discriminator_start=20_000), 0),
    "gan_vanilla": (dict(recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)),
                         discriminator_start=20_000), 20_000),
    "non_saturating_r1": (dict(generator_loss="non_saturating", r1_weight=10.0, aglw_gain=None), 0),
    "normalize_ema": (dict(codebook_update=dict(type="normalize"), ema_decay=0.99), 0),
}
_JAX_STEPS: dict = {}


def _algorithm_cfg(load, path, override, algorithm_type=None):
    cfg = load(path)["trainer"]["algorithm"]
    cfg = dict(cfg)
    cfg.update(override)
    if cfg.get("codebook_update"):
        cfg["model"] = dict(cfg["model"])
        cfg["model"]["quantizer"] = dict(cfg["model"]["quantizer"], normalize_inputs=True)
    if algorithm_type is not None:
        cfg["type"] = algorithm_type
        for key in ("discriminator", "d_optimizer"):
            cfg.pop(key, None)
    return cfg


def _adam_moments(opt_state):
    (adam,) = [s for s in opt_state if hasattr(s, "mu")]
    return adam.mu, adam.nu


def _vqgan_pair(override, seed=0):
    """(JAX algorithm, its state, the port's algorithm and state), with the
    same weights: the generator, the discriminator (and its running
    statistics) and LPIPS."""
    jalgo = JaxAlgorithmRegistry.build(_algorithm_cfg(jax_load_config, SMOKE, override))
    algo = AlgorithmRegistry.build(_algorithm_cfg(Config.load, SMOKE, override), device="cpu")
    g = _numpy_params(flax_param_shapes(algo.model), seed)
    d = _numpy_params(flax_param_shapes(algo.discriminator), seed + 1)
    stats = _batch_stats(algo.discriminator, seed + 2)
    algo.model.load_state_dict(state_dict_from_flax(algo.model, g))
    algo.discriminator.load_state_dict(state_dict_from_flax(algo.discriminator, d, stats))
    extra = {"d_batch_stats": stats}
    if algo.lpips_module is not None:
        lp = _numpy_params(flax_param_shapes(algo.lpips_module), seed + 3)
        algo.lpips_module.load_state_dict(state_dict_from_flax(algo.lpips_module, lp))
        extra["lpips_params"] = lp
    if algo.ema_decay is not None:
        extra["ema_params"] = g
    jstate = JaxTrainState.create(
        params={"generator": g, "discriminator": d}, opt_state=jalgo.tx(g).init(g),
        d_opt_state=jalgo.d_tx(d).init(d), rng=jax.random.PRNGKey(0), extra=extra)
    return jalgo, jax.tree_util.tree_map(jnp.asarray, jstate), algo, algo.init_state(0)


def _mu_tree(module, opt_state, key="mu"):
    names = [n for n, _ in module.named_parameters()]
    return params_to_flax(module, dict(zip(names, opt_state[key])))


def _noise(mu_tree, rel=NOISE_REL):
    """By leaf: the elements whose first-step Adam ``mu`` (= (1 − b1)·g)
    lies within ``rel`` of the module's largest: a gradient that is f32
    rounding noise (its true value 0), which Adam turns into a full ±lr
    step of either sign. Also returns that largest ``mu``."""
    flat = _flat(jax.tree_util.tree_map(np.asarray, dict(mu_tree)))
    top = max(float(np.abs(v).max()) for v in flat.values())
    return {k: np.abs(v) <= rel * top for k, v in flat.items()}, top


def _flat_copy(tree):
    return _flat(jax.tree_util.tree_map(np.array, dict(tree)))


def _check_second_gradients(jmu, mu, mask, b1, what):
    """The second step's gradient on the elements ``mask`` marks (noise at
    the first step), as Adam's increment ``mu2 − b1·mu1`` (= (1 − b1)·g2);
    ``jmu`` and ``mu`` are JAX's and the port's (mu1, mu2). Where JAX's is
    noise (within 1e-6 of the module's largest), the port's is noise too.
    Elsewhere the first gradient was small by chance or zero (a code unused
    at the first step), and the port's increment is JAX's within 1e-4 of
    the leaf's largest: the exemption covers no real second gradient."""
    jinc, inc = ({k: v - b1 * m1[k] for k, v in _flat_copy(m2).items()} for m1, m2 in (jmu, mu))
    top = max(float(np.abs(v).max()) for v in jinc.values())
    for k, m in mask.items():
        j, g = jinc[k][m], inc[k][m]
        quiet = np.abs(j) <= NOISE_REL * top
        assert (np.abs(g[quiet]) <= 10 * NOISE_REL * top).all(), (what, k, "port second gradient not noise")
        err = float(np.abs(g - j)[~quiet].max(initial=0.0))
        assert err <= REL * float(np.abs(jinc[k]).max()), (what, k, "second gradient", err)


def _synthetic_batches(n):
    data = SyntheticDataset(size=n * BATCH, image_size=SIZE)
    return [collate([data[j] for j in range(i * BATCH, (i + 1) * BATCH)])["image"] for i in range(n)]


@pytest.mark.usefixtures("_process_torch_threads")
@pytest.mark.parametrize("case", list(CASES))
def test_vqgan_two_train_steps_match_jax(case):
    override, start = CASES[case]
    jalgo, jstate, algo, state = _vqgan_pair(override)
    key = repr(sorted(override.items()))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(jalgo.train_step)
    jstep = _JAX_STEPS[key]
    jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
    state.step = start
    d_before = {k: v.clone() for k, v in algo.discriminator.state_dict().items()}
    pairs = ((algo.model, "opt_state", "g", algo.optimizer_cfg),
             (algo.discriminator, "d_opt_state", "d", algo.d_optimizer_cfg))
    for i, image in enumerate(_synthetic_batches(2)):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(image)})
        state, m = algo.train_step(state, {"image": torch.from_numpy(image)})
        assert set(m) == set(jm), set(m) ^ set(jm)
        for name in jm:
            want = float(jm[name])
            assert abs(float(m[name]) - want) <= REL * max(abs(want), 1e-6), (i, name, float(m[name]), want)
        if i == 0:  # the gradients that are rounding noise, in JAX and (then) in the port
            noise, mu1 = {}, {}
            for module, opt, what, _ in pairs:
                jmu, mu = _adam_moments(getattr(jstate, opt))[0], _mu_tree(module, getattr(state, opt))
                noise[what], top = _noise(jmu)
                mine, _ = _noise(mu, 10 * NOISE_REL)
                assert all(mine[k][noise[what][k]].all() for k in mine), (what, "port gradient not noise")
                noise[what + "_g"] = 10 * NOISE_REL * top / 0.5  # a noise gradient's bound (b1 = 0.5)
                mu1[what] = _flat_copy(jmu), _flat_copy(mu)
        else:
            for module, opt, what, opt_cfg in pairs:
                jmu, mu = _adam_moments(getattr(jstate, opt))[0], _mu_tree(module, getattr(state, opt))
                _check_second_gradients((mu1[what][0], jmu), (mu1[what][1], mu), noise[what],
                                        opt_cfg["betas"][0], what)
    assert state.step == start + 2
    gan_on = start >= algo.d_start
    if gan_on and algo.aglw_gain is not None:  # adaptive: not the bare gain
        assert float(m["aglw"]) != algo.aglw_gain
    d_after = algo.discriminator.state_dict()
    assert all(torch.equal(d_before[k], d_after[k]) for k in d_before) != gan_on
    _close_trees(batch_stats_to_flax(algo.discriminator, state.extra["d_batch_stats"]),
                 jstate.extra["d_batch_stats"], "batch_stats")
    for module, opt, what, opt_cfg in pairs:
        mask, g_noise = noise[what], noise[what + "_g"]
        # each of two Adam steps moves an element by at most ~lr (b1 0.5, b2 0.9: 1.0x)
        step_tol = 2 * 2 * 1.1 * opt_cfg["lr"]
        params = jstate.params["generator" if what == "g" else "discriminator"]
        _close_trees(params_to_flax(module), params, f"{what} params", mask, step_tol)
        jmu, jnu = _adam_moments(getattr(jstate, opt))
        _close_trees(_mu_tree(module, getattr(state, opt)), jmu, f"{what} adam mu", mask, 2 * g_noise)
        _close_trees(_mu_tree(module, getattr(state, opt), "nu"), jnu, f"{what} adam nu", mask,
                     2 * g_noise**2)
    if algo.ema_decay is not None:
        _close_trees(params_to_flax(algo.model, state.extra["ema_params"]), jstate.extra["ema_params"],
                     "ema", noise["g"], 2 * 2 * 1.1 * algo.optimizer_cfg["lr"])
    if algo.codebook_update is not None:
        norms = torch.linalg.vector_norm(algo.model.quantizer.codebook, dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


def test_reconstruction_train_steps_match_jax():
    override = dict(recon_losses=dict(l1=dict(), mse=dict()), codebook_update=dict(type="normalize"),
                    ema_decay=0.9)
    jalgo = JaxAlgorithmRegistry.build(
        _algorithm_cfg(jax_load_config, SMOKE, override, "ReconstructionAlgorithm"))
    algo = AlgorithmRegistry.build(
        _algorithm_cfg(Config.load, SMOKE, override, "ReconstructionAlgorithm"), device="cpu")
    g = _numpy_params(flax_param_shapes(algo.model), 5)
    algo.model.load_state_dict(state_dict_from_flax(algo.model, g))
    state = algo.init_state(0)
    jstate = jax.tree_util.tree_map(jnp.asarray, JaxTrainState.create(
        params=g, opt_state=jalgo.tx(g).init(g), rng=jax.random.PRNGKey(0), extra={"ema_params": g}))
    jstep = jax.jit(jalgo.train_step)
    for i, image in enumerate(_synthetic_batches(2)):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(image)})
        state, m = algo.train_step(state, {"image": torch.from_numpy(image)})
        assert set(m) == set(jm)
        for name in jm:
            assert abs(float(m[name]) - float(jm[name])) <= REL * abs(float(jm[name])), (i, name)
        if i == 0:
            noise, top = _noise(_adam_moments(jstate.opt_state)[0])
    step_tol = 2 * 2 * 1.1 * algo.optimizer_cfg["lr"]
    _close_trees(params_to_flax(algo.model), jstate.params, "params", noise, step_tol)
    _close_trees(params_to_flax(algo.model, state.extra["ema_params"]), jstate.extra["ema_params"], "ema",
                 noise, step_tol)
    jmu, _ = _adam_moments(jstate.opt_state)
    _close_trees(_mu_tree(algo.model, state.opt_state), jmu, "mu", noise, 2 * 10 * NOISE_REL * top / 0.5)


def _metric_cfgs(path):
    return Config.load(path)["validator"]["metrics"]


def test_eval_step_and_metrics_match_jax():
    override = dict(recon_losses=dict(l1=dict(), lpips=dict(weight=1.0)))
    jalgo, jstate, algo, state = _vqgan_pair(override, seed=7)
    items = [SyntheticDataset(size=8, image_size=SIZE)[i] for i in range(8)]
    batch = collate(items)
    jmemo = jax.jit(jalgo.eval_step)(jstate, {"image": jnp.asarray(batch["image"])})
    memo = algo.eval_step(state, {"image": torch.from_numpy(batch["image"])})
    assert set(memo) == set(jmemo)
    for name in jmemo:
        if name == "codes":
            np.testing.assert_array_equal(memo[name].numpy(), np.asarray(jmemo[name]))
        else:
            _close(memo[name], jmemo[name], name)
    metrics = {name: MetricRegistry.build(cfg) for name, cfg in _metric_cfgs(SMOKE).items()}
    jmetrics = {name: getattr(jax_metrics, cfg["type"])(**{k: v for k, v in cfg.items() if k != "type"})
                for name, cfg in _metric_cfgs(SMOKE).items()}
    assert set(metrics) == {"codebook_usage", "codebook_ppl", "l1", "mse", "psnr", "ssim"}
    for lo in (0, 4):  # two batches of the same memo's halves
        part = {"codes": memo["codes"][lo:lo + 4], "pred": memo["pred"][lo:lo + 4],
                "batch": {"original_image": batch["original_image"][lo:lo + 4]}}
        jpart = {"codes": part["codes"].numpy(), "pred": part["pred"].numpy(), "batch": part["batch"]}
        for name in metrics:
            metrics[name].update(part)
            jmetrics[name].update(jpart)
    for name in metrics:
        got, want = metrics[name].summary(name)[name], jmetrics[name].summary(name)[name]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (name, got, want)
    # FIDMetric is ported (tests/test_torch_fid.py holds it against JAX's)
    assert MetricRegistry.build({"type": "FIDMetric", "features": "pixel"}, dataset=None).pred == "pred"


# -- data, taming anchor, configs ------------------------------------------


def test_synthetic_dataset_is_bit_identical():
    port, ref = SyntheticDataset(size=16, image_size=SIZE), JaxSyntheticDataset(size=16, image_size=SIZE)
    assert len(port) == len(ref) == 16
    for i in range(16):
        a, b = port[i], ref[i]
        assert a.id_ == b.id_ and a.category == b.category
        assert a.original_image.dtype == np.uint8 and np.array_equal(a.original_image, b.original_image)
        assert a.image.dtype == np.float32 and np.array_equal(a.image, b.image)


def _taming_state_dict():
    from test_parity_torch import _TmVQGAN

    torch.manual_seed(0)  # as tools/record_published.py makes the anchor's checkpoint
    return {k: v.detach().clone() for k, v in _TmVQGAN().state_dict().items()}


TAMING_OPTIONS = dict(enc_width_mults=(1, 2), enc_depth=2, dec_depth=3)


def test_taming_remap_matches_jax_converter():
    sd = _taming_state_dict()
    model = ModelRegistry.build(Config.load(GOLDEN)["validator"]["algorithm"]["model"], device="cpu")
    got = convert_taming_vqgan(sd, **TAMING_OPTIONS)
    flax = jax_converters.convert_taming_vqgan({k: v.numpy() for k, v in sd.items()}, width=32,
                                               **TAMING_OPTIONS)
    want = state_dict_from_flax(model, flax)
    assert set(got) == set(want) == set(model.state_dict())
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_synthetic_taming_vqgan_anchor():
    recorded = json.loads((REPO / "BASELINE.json").read_text())["published"]["synthetic_taming_vqgan"]
    cfg = Config.load(GOLDEN)["validator"]
    algo = AlgorithmRegistry.build(cfg["algorithm"], device="cpu")
    algo.model.load_state_dict(convert_taming_vqgan(_taming_state_dict(), **TAMING_OPTIONS))
    state = algo.init_state(0)
    dataset = SyntheticDataset(size=cfg["dataset"]["size"], image_size=cfg["dataset"]["image_size"])
    assert (len(dataset), cfg["dataloader"]["batch_size"]) == (8, 8)
    metrics = {name: MetricRegistry.build(m) for name, m in cfg["metrics"].items()}
    batch = collate([dataset[i] for i in range(len(dataset))])
    memo = algo.eval_step(state, {"image": torch.from_numpy(batch["image"])})
    memo["batch"] = batch
    for m in metrics.values():
        m.update(memo)
    got = {name: m.summary(name)[name] for name, m in metrics.items()}
    want = recorded["metrics"]
    assert got["codebook_usage"] == 0.125
    for name in ("codebook_ppl", "l1", "mse", "psnr", "ssim"):
        assert abs(got[name] - want[name]) <= 1e-3, (name, got[name], want[name])


def test_llamagen_vqgan_algorithm_builds_from_config():
    cfg = Config.load(LLAMAGEN_VQGAN)["trainer"]["algorithm"]
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    assert type(algo).__name__ == "VQGANAlgorithm"
    assert sum(p.numel() for p in algo.model.parameters()) == 69_593_227
    assert algo.model.quantizer.normalize_inputs and algo.codebook_update == {"type": "normalize"}
    assert tuple(algo.model.quantizer.codebook.shape) == (16384, 8)
    disc = algo.discriminator
    assert type(disc).__name__ == "PatchGANDiscriminator"
    assert tuple(disc.get_parameter("Conv_0.weight").shape) == (64, 3, 4, 4)
    assert tuple(disc.get_parameter("Conv_3.weight").shape) == (512, 256, 4, 4)
    assert (algo.d_start, algo.g_start, algo.aglw_gain, algo.r1_weight) == (20_000, 0, 0.8, None)
    assert set(algo.recon_losses) == {"l1", "lpips"} and algo.lpips_module is not None
    for tx in (algo.tx(), algo.d_tx()):
        assert (tx.kind, tx.b1, tx.b2, tx.schedule(0)) == ("adam", 0.5, 0.9, 1e-4)
    last = algo.model.decoder.last_parameter()
    assert last is algo.model.decoder.backbone.proj_out.weight and tuple(last.shape) == (3, 128, 3, 3)
    jcfg = jax_load_config(LLAMAGEN_VQGAN)["trainer"]["algorithm"]
    jmodel = JaxModelRegistry.build(jcfg["model"])
    assert type(jmodel.decoder).last_parameter_path() == ("backbone", "proj_out", "kernel")


# kmeans and cvq with each of its anchors are ported (tests/test_torch_vqkd.py,
# tests/test_torch_cvq_anchors.py): they build; an anchor rule the
# reference lacks still raises
@pytest.mark.parametrize("update", [dict(type="cvq", anchor="multinomial"), dict(type="cvq", anchor="cached")])
def test_unported_codebook_updates_raise(update):
    cfg = _algorithm_cfg(Config.load, SMOKE, dict(codebook_update=update))
    state = AlgorithmRegistry.build(cfg, device="cpu").init_state(0)
    assert ("anchor_cache" in state.extra) == (update["anchor"] == "cached")
    cfg = _algorithm_cfg(Config.load, SMOKE, dict(codebook_update=dict(update, anchor="farthest")))
    with pytest.raises(ValueError, match="unknown CVQ anchor"):
        AlgorithmRegistry.build(cfg, device="cpu")
