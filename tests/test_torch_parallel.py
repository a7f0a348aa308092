"""The port's strategies over ``torch.distributed`` on the CPU, against the
JAX package on its 8-device CPU mesh (``tests/conftest.py``).

The JAX package runs every strategy as one global computation: the batch
is sharded, the loss is the global batch's mean, BatchNorm, codebook and
k-means statistics are global. Here 2 (or 4, dp x tp) ``gloo`` ranks each
take their rows of the same global batch (``tests/torch_parallel_workers.py``
runs them; spawned, one thread each, bounded by a deadline), and must give
what JAX gives for the whole batch, with the same numpy weights and
inputs:

- data parallelism: two VQGAN steps (PatchGAN's BatchNorm, the adaptive GAN
  weight), AR steps, VQ-KD (the lazy k-means init fed JAX's draws, the EMA
  k-means) and Cluster (CVQ's synced nearest anchors); AR's CFG drop against
  the port's one process over the whole batch (the global draw, sliced);
- FSDP (``min_size`` 256, as ``tests/test_training.py``), with the shards'
  local shapes between steps, and its two-rank checkpoint restored in one
  process;
- tensor parallelism: the TP config at tiny widths on dp 2 x tp 2, and
  ``ARServer(strategy=TPStrategy)`` against the unsharded server and JAX's
  TP server (dense and paged); the non-divisible and missing-axis rules;
- ``ops/codebook.py``'s ``group`` reductions against ``jax.pmap``'s
  ``axis_name``; metric summaries against one process over the whole set;
  ``assert_replicated`` naming the perturbed rank; ``resolve_axes`` for
  every ``configs/strategies`` file; a strategy that would run degraded
  (one device's on the world, a multi-rank mesh without its groups) refused.

Tolerances are the single-process parity tests': metrics and statistics
within 1e-4 of the reference (``test_torch_vqgan_train.py``,
``test_torch_vqkd.py``); the train steps here use SGD, and each leaf's
update (after minus before) is held within 1e-4 of its module's largest
update, since an update that is f32 rounding noise in both packages (the
GroupNorm-cancelled biases) has no relative precision; AR losses within
1e-5 and parameters within 5e-5 in norm (``test_torch_ar_train.py``).
"""

import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from vector_quantization_tpu_torch.parallel.mesh import make_mesh, resolve_axes
from vector_quantization_tpu_torch.parallel.sharding import TPStrategy
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes
from vector_quantization_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
ANCHOR = str(REPO / "configs/regression/ar_anchor.py")
VQKD = str(REPO / "configs/vqkd/clip_8192_imagenet_ddp.py")
CLUSTER = str(REPO / "configs/cluster/clip_8192_imagenet_ddp.py")
REL = 1e-4
SGD = dict(type="sgd", lr=1e-2)
GLOBAL = 8  # the global batch: one row per JAX device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in dict(tree).items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _close(got, want, what, rel=REL, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    ref = float(np.abs(want).max(initial=0.0)) if scale is None else scale
    assert err <= rel * ref, (what, err, ref)


def _close_updates(got, want, before, what):
    """Each leaf's update within 1e-4 of the module's largest update."""
    got, want, before = _flat(got), _flat(want), _flat(before)
    assert got.keys() == want.keys()
    top = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    assert top > 0, what
    for k in want:
        _close(got[k] - before[k], want[k] - before[k], f"{what} {k}", scale=top)


def _replicas_equal(results, key):
    first = _flat(results[0][key])
    for r in results[1:]:
        other = _flat(r[key])
        assert all(np.array_equal(first[k], other[k]) for k in first), key


def _ok(results, name):
    for rank, r in enumerate(results):
        assert "error" not in r[name], f"rank {rank}: {r[name]['error']}"
    return [r[name] for r in results]


def _jax_mesh_step(jalgo, jstate, batches):
    """JAX's train steps with the state replicated and each batch sharded
    over the 8-device mesh (its DataParallelStrategy)."""
    from vector_quantization_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vector_quantization_tpu.parallel.sharding import DataParallelStrategy as JaxDP

    strategy = JaxDP(jax_make_mesh())
    assert strategy.mesh.shape["dp"] == 8
    jstate = strategy.shard_params(jstate)
    step = jax.jit(jalgo.train_step)
    metrics = []
    for batch in batches:
        jstate, m = step(jstate, strategy.shard_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


# -- the data-parallel spawn (2 ranks, every case) ---------------------------------


def _vqgan_payload():
    from test_torch_vqgan_train import _batch_stats, _numpy_params

    override = dict(optimizer=SGD, d_optimizer=SGD)
    cfg = dict(Config.load(SMOKE)["trainer"]["algorithm"], **override)
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    g = _numpy_params(flax_param_shapes(algo.model), 0)
    d = _numpy_params(flax_param_shapes(algo.discriminator), 1)
    stats = _batch_stats(algo.discriminator, 2)
    rng = np.random.default_rng(3)
    images = [rng.uniform(-1, 1, (GLOBAL, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    return {"case": "vqgan", "cfg": cfg, "override": override, "g": g, "d": d, "stats": stats,
            "images": images, "start": 0}


def _ar_payload(**override):
    from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
    from vector_quantization_tpu.utils.config import load_config as jax_load_config

    jcfg = dict(jax_load_config(ANCHOR)["trainer"]["algorithm"], fused_ce=False, **override)
    jalgo = JaxAlgorithmRegistry.build(jcfg)
    state = jalgo.init_state(jax.random.PRNGKey(0), {})
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    params["lm_head"] = (np.random.default_rng(11).standard_normal(params["lm_head"].shape)
                         * 0.05).astype(np.float32)
    rng = np.random.default_rng(0)
    batches = [{"codes": rng.integers(0, 64, (GLOBAL, 8, 8)).astype(np.int32),
                "category": rng.integers(0, 10, GLOBAL).astype(np.int32)} for _ in range(3)]
    cfg = dict(Config.load(ANCHOR)["trainer"]["algorithm"], fused_ce=False, **override)
    return {"case": "ar", "cfg": cfg, "params": params, "seed": 3,
            "ir_params": jax.tree_util.tree_map(np.asarray, state.extra["ir_params"]), "batches": batches}


def _tokenizer_payload(path):
    from test_torch_vqkd import _algorithm_cfg, _jax_draws, _numpy_params, _uint8, K

    from vector_quantization_tpu.utils.config import load_config as jax_load_config

    def sgd(cfg):  # the config's exclude kept
        opt = {k: v for k, v in cfg["optimizer"].items() if k == "exclude"}
        return dict(cfg, optimizer={**SGD, **opt})

    port_cfg = sgd(_algorithm_cfg(Config.load, path, port=True))
    jax_cfg = sgd(_algorithm_cfg(jax_load_config, path, port=False))
    algo = AlgorithmRegistry.build(port_cfg, device="cpu")
    params = _numpy_params(flax_param_shapes(algo.model), 20)
    extra, draws = {}, None
    if hasattr(algo, "teacher"):
        extra["teacher_params"] = _numpy_params(flax_param_shapes(algo.teacher), 21)
        extra["initialized"] = np.zeros((), np.bool_)
        _, sub = jax.random.split(jax.random.PRNGKey(20))
        draws = _jax_draws(jax.random.split(sub, 3)[0], GLOBAL * 16, K, 2**20)
    else:
        extra["probability"] = np.zeros(K, np.float32)
    batches = []
    for seed in (30, 31):
        u8 = _uint8(seed, b=GLOBAL)
        batches.append({"image": u8.astype(np.float32) / 127.5 - 1.0, "original_image": u8})
    return {"case": "tokenizer", "cfg": port_cfg, "jax_cfg": jax_cfg, "params": params, "extra": extra,
            "draws": draws, "batches": batches, "path": path}


def _fsdp_payload():
    from test_training import VQ_MODEL_CFG

    cfg = dict(type="ReconstructionAlgorithm", model=copy.deepcopy(VQ_MODEL_CFG),
               optimizer=dict(type="sgd", lr=1e-2, momentum=0.9))
    algo = AlgorithmRegistry.build(cfg, device="cpu")
    from test_torch_vqgan_train import _numpy_params

    params = _numpy_params(flax_param_shapes(algo.model), 40)
    rng = np.random.default_rng(41)
    batches = [{"image": rng.uniform(-1, 1, (GLOBAL, 32, 32, 3)).astype(np.float32)} for _ in range(2)]
    return {"case": "fsdp", "cfg": cfg, "params": params, "batches": batches, "min_size": 256,
            "axes": {"dp": -1, "fsdp": 2}}


def _codebook_payload():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    e = rng.standard_normal((16, 8)).astype(np.float32)
    d = ((x[:, None] - e[None]) ** 2).sum(-1).astype(np.float32)
    codes = d.argmin(1).astype(np.int32)
    codes[:5] = 15  # a code in use on rank 0 only
    prob = rng.uniform(0, 0.1, 16).astype(np.float32)
    return {"case": "codebook", "x": x, "codebook": e, "d": d, "codes": codes, "probability": prob}


def _metrics_payload():
    rng = np.random.default_rng(60)
    memos = []
    for i in range(4):
        memos.append({"codes": rng.integers(0, 32, (4, 4, 4)).astype(np.int64),
                      "pred": rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32),
                      "loss": float(rng.uniform()),
                      "batch": {"original_image": rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)}})
    metrics = {"usage": dict(type="CodebookUsageMetric", codebook_size=48),
               "ppl": dict(type="CodebookPPLMetric", codebook_size=48),
               "psnr": dict(type="ImageLossMetric", kind="psnr"),
               "loss": dict(type="LossMetric", key="loss"),
               "fid": dict(type="FIDMetric", features="pixel")}
    return {"case": "metrics", "memos": memos, "metrics": metrics}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Every two-rank case in one spawn: (payloads, each rank's results)."""
    payloads = {
        "vqgan": _vqgan_payload(),
        "ar": _ar_payload(cfg=None),
        "ar_cfg": _ar_payload(cfg=0.5),
        "vqkd": _tokenizer_payload(VQKD),
        "cluster": _tokenizer_payload(CLUSTER),
        "fsdp": _fsdp_payload(),
        "codebook": _codebook_payload(),
        "metrics": _metrics_payload(),
        "replicated": {"case": "replicated", "codebook": _codebook_payload()["codebook"], "perturb": 1},
        "refusals": {"case": "refusals"},
    }
    return payloads, W.spawn(payloads, 2, tmp_path_factory.mktemp("dp"))


def test_dp_vqgan_steps_match_jax_mesh(dp_run):
    from test_torch_vqgan_train import SMOKE as _SMOKE, _algorithm_cfg

    from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
    from vector_quantization_tpu.training.state import TrainState as JaxTrainState
    from vector_quantization_tpu.utils.config import load_config as jax_load_config

    payloads, results = dp_run
    p = payloads["vqgan"]
    got = _ok(results, "vqgan")
    jalgo = JaxAlgorithmRegistry.build(_algorithm_cfg(jax_load_config, _SMOKE, p["override"]))
    jstate = JaxTrainState.create(
        params={"generator": p["g"], "discriminator": p["d"]}, opt_state=jalgo.tx(p["g"]).init(p["g"]),
        d_opt_state=jalgo.d_tx(p["d"]).init(p["d"]), rng=jax.random.PRNGKey(0),
        extra={"d_batch_stats": p["stats"]})
    jstate, jm = _jax_mesh_step(jalgo, jax.tree_util.tree_map(jnp.asarray, jstate),
                                [{"image": x} for x in p["images"]])
    for rank in range(2):
        for i in range(2):
            assert set(got[rank]["metrics"][i]) == set(jm[i])
            for k, want in jm[i].items():
                assert abs(got[rank]["metrics"][i][k] - want) <= REL * max(abs(want), 1e-6), (rank, i, k)
    assert got[0]["metrics"][0]["aglw"] != 0.8  # adaptive, from the global losses' gradients
    _replicas_equal(got, "g")
    _replicas_equal(got, "d")
    _replicas_equal(got, "stats")
    _close_updates(got[0]["g"], jstate.params["generator"], p["g"], "generator")
    _close_updates(got[0]["d"], jstate.params["discriminator"], p["d"], "discriminator")
    for k, v in _flat(jstate.extra["d_batch_stats"]).items():
        _close(_flat(got[0]["stats"])[k], v, f"batch_stats {k}")


def test_dp_ar_steps_match_jax_mesh_and_cfg_drop_is_global(dp_run):
    from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
    from vector_quantization_tpu.training.state import TrainState as JaxTrainState
    from vector_quantization_tpu.utils.config import load_config as jax_load_config
    from vector_quantization_tpu_torch.utils.bridge import llama_params_to_flax, load_ar_from_flax

    payloads, results = dp_run
    p = payloads["ar"]
    got = _ok(results, "ar")
    jalgo = JaxAlgorithmRegistry.build(dict(jax_load_config(ANCHOR)["trainer"]["algorithm"], cfg=None,
                                            fused_ce=False))
    jstate = JaxTrainState.create(params=p["params"], opt_state=jalgo.tx(p["params"]).init(p["params"]),
                                  rng=jax.random.PRNGKey(0), extra={"ir_params": p["ir_params"]})
    jstate, jm = _jax_mesh_step(jalgo, jax.tree_util.tree_map(jnp.asarray, jstate), p["batches"])
    for rank in range(2):
        for i in range(3):
            assert abs(got[rank]["metrics"][i]["loss"] - jm[i]["loss"]) <= 1e-5 * jm[i]["loss"]
    _replicas_equal(got, "params")
    want = _flat(jstate.params)
    for k, w in want.items():
        assert np.linalg.norm(_flat(got[0]["params"])[k] - w) <= 5e-5 * np.linalg.norm(w), k
    # CFG drop at 0.5: the global batch's draw from the state's generator,
    # sliced; one process over the whole batch draws the same
    q = payloads["ar_cfg"]
    got = _ok(results, "ar_cfg")
    algo = AlgorithmRegistry.build(q["cfg"], device="cpu")
    load_ar_from_flax(algo, q["params"], q["ir_params"])
    state = algo.init_state(q["seed"])
    for i, batch in enumerate(q["batches"]):
        state, m = algo.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(got[0]["metrics"][i]["loss"] - float(m["loss"])) <= 1e-5 * float(m["loss"])
    for k, w in _flat(llama_params_to_flax(algo.model)).items():
        assert np.linalg.norm(_flat(got[1]["params"])[k] - w) <= 5e-5 * np.linalg.norm(w), k


@pytest.mark.parametrize("name", ["vqkd", "cluster"])
def test_dp_tokenizer_steps_match_jax_mesh(dp_run, name):
    from vector_quantization_tpu.registries import AlgorithmRegistry as JaxAlgorithmRegistry
    from vector_quantization_tpu.training.state import TrainState as JaxTrainState
    import vector_quantization_tpu.ops.codebook as jax_cb

    payloads, results = dp_run
    p = payloads[name]
    got = _ok(results, name)
    jalgo = JaxAlgorithmRegistry.build(p["jax_cfg"])
    jstate = JaxTrainState.create(params=p["params"], opt_state=jalgo.tx(p["params"]).init(p["params"]),
                                  rng=jax.random.PRNGKey(20), extra=p["extra"])
    assert jax_cb is not None
    jstate, jm = _jax_mesh_step(jalgo, jax.tree_util.tree_map(jnp.asarray, jstate), p["batches"])
    for rank in range(2):
        for i in range(2):
            for k, want in jm[i].items():
                assert abs(got[rank]["metrics"][i][k] - want) <= REL * max(abs(want), 1e-6), (rank, i, k)
    _replicas_equal(got, "params")
    _replicas_equal(got, "extra")
    gp, jp = _flat(got[0]["params"]), _flat(jstate.params)
    _close(gp["quantizer/codebook"], jp["quantizer/codebook"], "codebook")
    trained = {k for k in jp if not (name == "vqkd" and k == "quantizer/codebook")
               and not (name == "cluster" and k.startswith("encoder/"))}
    _close_updates({k: gp[k] for k in trained}, {k: jp[k] for k in trained},
                   {k: v for k, v in _flat(p["params"]).items() if k in trained}, name)
    if name == "vqkd":
        assert got[0]["extra"]["initialized"]
    else:
        _close(got[0]["extra"]["probability"], jstate.extra["probability"], "probability")


def test_fsdp_steps_match_jax_mesh_with_shards_between_steps(dp_run):
    from vector_quantization_tpu.algorithms.base import ReconstructionAlgorithm as JaxRecon
    from vector_quantization_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vector_quantization_tpu.parallel.sharding import FSDPStrategy as JaxFSDP
    from vector_quantization_tpu.training.state import TrainState as JaxTrainState

    payloads, results = dp_run
    p = payloads["fsdp"]
    got = _ok(results, "fsdp")
    jalgo = JaxRecon(model=p["cfg"]["model"], optimizer=p["cfg"]["optimizer"])
    strategy = JaxFSDP(jax_make_mesh({"dp": 2, "fsdp": 4}), min_size=p["min_size"])
    jstate = JaxTrainState.create(params=p["params"], opt_state=jalgo.tx(p["params"]).init(p["params"]),
                                  rng=jax.random.PRNGKey(0))
    jstate = jax.device_put(jax.tree_util.tree_map(jnp.asarray, jstate), strategy.state_sharding(jstate))
    step = jax.jit(jalgo.train_step)
    for batch in p["batches"]:
        jstate, _ = step(jstate, strategy.shard_batch(batch))
    assert any("fsdp" in str(x.sharding.spec) for x in jax.tree_util.tree_leaves(jstate.params))
    _replicas_equal(got, "params")
    _close_updates(got[0]["params"], jstate.params, p["params"], "fsdp")
    # between steps: the parameters of >= 256 elements are halves along
    # their largest even dimension, and so are their momenta
    algo = AlgorithmRegistry.build(p["cfg"], device="cpu")
    halved, local_trace = 0, []
    for name, full in algo.model.named_parameters():
        shape = tuple(full.shape)
        want = shape
        if full.numel() >= 256:
            even = [i for i in range(len(shape)) if shape[i] % 2 == 0]
            if even:
                d = max(even, key=lambda i: shape[i])
                want = shape[:d] + (shape[d] // 2,) + shape[d + 1:]
        assert got[0]["local"][name] == want, name
        local_trace.append(want)
        halved += want != shape
    assert halved >= 4 and got[0]["local"]["trace"] == local_trace


def test_fsdp_two_rank_checkpoint_restores_in_one_process(dp_run):
    from vector_quantization_tpu_torch.training import checkpoints as ckpt
    from vector_quantization_tpu_torch.utils.bridge import params_to_flax

    payloads, results = dp_run
    got = _ok(results, "fsdp")
    algo = AlgorithmRegistry.build(payloads["fsdp"]["cfg"], device="cpu")
    state = algo.init_state(0)
    ckpt.restore_checkpoint(got[0]["ckpt"], algo, state)
    assert state.step == 2
    for k, v in _flat(params_to_flax(algo.model)).items():
        assert np.array_equal(v, _flat(got[0]["params"])[k]), k
    for a, b in zip(state.opt_state["trace"], got[0]["trace"]):
        assert torch.equal(a, b)


def test_codebook_group_reductions_match_jax_pmap(dp_run):
    import vector_quantization_tpu.ops.codebook as jax_cb
    from vector_quantization_tpu_torch.ops import codebook as cb

    payloads, results = dp_run
    p = payloads["codebook"]
    got = _ok(results, "codebook")
    k = p["codebook"].shape[0]

    def halves(a):
        return jnp.asarray(a.reshape(2, a.shape[0] // 2, *a.shape[1:]))

    x, codes, d = halves(p["x"]), halves(p["codes"]), halves(p["d"])
    e, prob = jnp.asarray(p["codebook"]), jnp.asarray(p["probability"])
    pm = lambda f: jax.pmap(f, axis_name="dp", devices=jax.devices()[:2])  # noqa: E731
    want = {
        "hist": pm(lambda c: jax_cb.code_histogram(c, k, "dp"))(codes),
        "freq": pm(lambda c: jax_cb.code_frequency(c, k, "dp"))(codes),
        "kmeans": pm(lambda a, c: jax_cb.kmeans_update(e, a, c, 0.9, axis_name="dp"))(x, codes),
    }
    counts, sums = pm(lambda a, c: jax_cb.cluster_stats(a, c, k, "dp"))(x, codes)
    want["counts"], want["sums"] = counts, sums
    for sync in (True, False):
        cbk, pr, _ = pm(lambda a, dd, c: jax_cb.cvq_update(e, prob, a, dd, c, ema_decay=0.99, sync=sync,
                                                           axis_name="dp"))(x, d, codes)
        want[f"cvq_{'sync' if sync else 'mean'}"] = (cbk, pr)
    for rank in range(2):
        r = got[rank]
        assert np.array_equal(r["hist"].numpy(), np.asarray(want["hist"][rank]))
        assert np.array_equal(r["counts"].numpy(), np.asarray(want["counts"][rank]))
        for key in ("freq", "sums", "kmeans"):
            _close(r[key], want[key][rank], key, rel=1e-5)
        for key in ("cvq_sync", "cvq_mean"):
            _close(r[key][0], want[key][0][rank], key, rel=1e-5)
            _close(r[key][1], want[key][1][rank], key, rel=1e-5)
    # the lazy init over the gathered rows: one process's over all of them
    whole = cb.kmeans_init(torch.from_numpy(p["x"]), k, torch.Generator().manual_seed(5), iters=3)
    assert torch.equal(got[0]["init"], got[1]["init"])
    _close(got[0]["init"], whole, "kmeans_init", rel=1e-6)


def test_metric_summaries_across_ranks_match_one_process(dp_run):
    from vector_quantization_tpu_torch.registries import MetricRegistry

    payloads, results = dp_run
    p = payloads["metrics"]
    got = _ok(results, "metrics")
    want = {}
    for name, cfg in p["metrics"].items():
        metric = MetricRegistry.build(cfg)
        for memo in p["memos"]:
            metric.update({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in memo.items()})
        want.update(metric.summary(name))
    assert got[0].keys() == got[1].keys() == want.keys()
    for k, v in want.items():
        assert got[0][k] == got[1][k], k
        assert abs(got[0][k] - v) <= 1e-6 * max(abs(v), 1.0), (k, got[0][k], v)


def test_assert_replicated_names_the_diverged_rank(dp_run):
    got = _ok(dp_run[1], "replicated")
    for r in got:
        assert r["raised"] is not None and "rank(s) [1]" in r["raised"] and "codebook" in r["raised"]


def test_no_strategy_runs_degraded_on_the_world(dp_run):
    """Two ranks: ``SingleDeviceStrategy`` on the world's mesh and a
    two-rank mesh without its process groups raise ``ValueError`` (each
    replica would train on its own rows unreduced); data parallelism
    splits the batch over both ranks."""
    got = _ok(dp_run[1], "refusals")
    for rank, r in enumerate(got):
        assert r["single"] is not None and "SingleDeviceStrategy" in r["single"]
        assert r["ungrouped"] is not None and "process groups" in r["ungrouped"]
        assert r["dp"] == (2, rank, True, {"dp": 2})


# -- tensor parallelism ---------------------------------------------------------------


def _tp_configs():
    from test_tp import _tiny_tp_config

    jcfg = _tiny_tp_config()
    cfg = Config.load(str(REPO / "configs/ar/c2i_llama_medium_tp_imagenet.py"))
    cfg.override({k: copy.deepcopy(v) for k, v in {
        "trainer.algorithm.transformer": dict(type="LlamaTransformer", hidden_size=32, num_layers=2,
                                              num_heads=2, ffn_dim=64),
        "trainer.algorithm.ir": jcfg["trainer"]["algorithm"]["ir"],
        "trainer.algorithm.image_size": 32,
        "trainer.algorithm.num_categories": 10,
        "trainer.dataset": dict(type="SyntheticDataset", size=16, image_size=32),
        "trainer.dataloader": dict(batch_size_in_total=8, num_workers=0),
        "trainer.max_iters": 2,
        "trainer.callbacks": [dict(type="CheckpointCallback", interval=2)],
    }.items()})
    return jcfg, cfg


def test_tp_training_from_config_matches_jax_mesh(tmp_path):
    from vector_quantization_tpu.training.runner import build_runner as jax_build_runner

    jcfg, cfg = _tp_configs()
    jcfg["trainer"]["work_dir"] = str(tmp_path / "jax")
    tr = jax_build_runner(jcfg, "trainer")
    assert dict(tr.strategy.mesh.shape) == {"dp": 4, "tp": 2}
    tr.init_state()
    # a non-zero head (the reference starts it at zero), so the first steps
    # move every block, as in test_torch_ar_train.py
    head = tr.state.params["lm_head"]
    new_head = (np.random.default_rng(11).standard_normal(head.shape) * 0.05).astype(np.float32)
    tr.state = tr.state.replace(params={**tr.state.params, "lm_head": jax.device_put(new_head, head.sharding)})
    params = jax.tree_util.tree_map(np.asarray, dict(tr.state.params))
    ir_params = jax.tree_util.tree_map(np.asarray, tr.state.extra["ir_params"])
    jstate = tr.run()
    payload = {"tp": {"case": "tp_train", "cfg": cfg, "params": params, "ir_params": ir_params}}
    got = _ok(W.spawn(payload, 4, tmp_path), "tp")
    assert got[0]["mesh"] == {"dp": 2, "tp": 2}
    assert all(g["step"] == 2 for g in got) and got[0]["heads"] == [1, 1]
    # q/k/v/gate/up columns and o/down rows halved; the vocabulary (10
    # classes + 32 codes) even: the embedding's rows and the head's columns
    # halved too (the odd case: test_tp_rules_fall_back_and_require_the_axis)
    shapes = got[0]["shapes"]
    assert shapes["layer0.q_proj.kernel"] == (32, 16) and shapes["layer0.o_proj.kernel"] == (16, 32)
    assert shapes["layer0.up_proj.kernel"] == (32, 32) and shapes["layer0.down_proj.kernel"] == (32, 32)
    assert params["embedding"].shape == (42, 32)
    assert shapes["embedding"] == (21, 32) and shapes["lm_head"] == (32, 21)
    assert "embedding" in got[0]["layouts"] and "layer1.v_proj.kernel" in got[0]["layouts"]
    want = _flat(jstate.params)
    for g in got:
        for k, w in want.items():
            assert np.linalg.norm(_flat(g["params"])[k] - w) <= 5e-5 * np.linalg.norm(w), k
    # the 4-rank checkpoint holds the full state: it restores in one process
    # (one device, no strategy), weights and Adam moments whole
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.bridge import llama_params_to_flax

    cfg.override({"trainer.mesh": {"dp": 1}, "trainer.strategy": dict(type="SingleDeviceStrategy"),
                  "trainer.callbacks": []})
    one = build_runner(cfg, "trainer", device="cpu", work_dir=str(tmp_path / "one"))
    assert one.resume(str(tmp_path / "tp" / "checkpoints" / "iter_2"))
    assert one.state.step == 2
    for k, v in _flat(llama_params_to_flax(one.algorithm.model)).items():
        assert np.array_equal(v, _flat(got[0]["params"])[k]), k
    mu = one.state.opt_state["mu"]
    assert [tuple(m.shape) for m in mu] == [tuple(p.shape) for p in one.algorithm.model.parameters()]


def test_tp_rules_fall_back_and_require_the_axis():
    """What the rule cannot split stays replicated, as JAX's leaf rule
    falls back; the port splits attention by whole heads (JAX's by
    columns, which GSPMD may cut inside a head). A mesh without ``tp``
    raises in both."""
    from jax.sharding import PartitionSpec as P

    from vector_quantization_tpu.parallel import TPStrategy as JaxTP, make_mesh as jax_make_mesh
    from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer, shard_llama_tp

    jstrategy = JaxTP(jax_make_mesh({"dp": 2, "tp": 4}))

    def jax_spec(*path, shape):
        keys = tuple(jax.tree_util.DictKey(k) for k in path)
        return jstrategy.leaf_sharding(keys, type("Leaf", (), {"shape": shape})()).spec

    for bad in ({"dp": 8}, {"dp": 2, "fsdp": 4}):
        with pytest.raises(ValueError, match="tp"):
            TPStrategy(make_mesh({k: 1 for k in bad}, device_type="cpu"), device="cpu")
        with pytest.raises(ValueError):
            JaxTP(jax_make_mesh(bad))
    # a vocabulary of 43 and 2 heads over 4 ranks: the embedding, the head
    # and attention stay replicated; the FFN (64) splits, as in JAX
    model = LlamaTransformer(vocabulary_size=43, hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64)
    entries = shard_llama_tp(model, None, 1, 4)
    assert sorted(f"{type(m).__name__}.{k}" for m, k, _ in entries) == ["Dense.kernel"] * 3
    assert model.tp_vocab is None and tuple(model.embedding.shape) == (43, 32)
    assert jax_spec("embedding", shape=(43, 32)) == P() and jax_spec("lm_head", shape=(32, 43)) == P()
    assert model.layer0.num_heads == 2 and tuple(model.layer0.q_proj.kernel.shape) == (32, 32)
    assert model.layer0.ffn_dim == 16 and tuple(model.layer0.gate_proj.kernel.shape) == (32, 16)
    assert tuple(model.layer0.down_proj.kernel.shape) == (16, 32)
    assert jax_spec("layer0", "gate_proj", "kernel", shape=(32, 64)) == P(None, "tp")
    assert jax_spec("layer0", "down_proj", "kernel", shape=(64, 32)) == P("tp", None)
    # rank 1's gate columns are the full kernel's 16..31
    full = LlamaTransformer(vocabulary_size=43, hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64)
    assert torch.equal(model.layer0.gate_proj.kernel, full.layer0.gate_proj.kernel[:, 16:32])


def test_make_mesh_for_every_strategy_config():
    from vector_quantization_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vector_quantization_tpu.utils.config import load_config as jax_load_config

    files = sorted((REPO / "configs/strategies").glob("*.py"))
    assert len(files) == 6
    for f in files:
        cfg, jcfg = Config.load(str(f)), jax_load_config(str(f))
        for kind in ("trainer", "validator"):
            axes = cfg[kind]["mesh"]
            n = 8 if -1 in axes.values() or sum(axes.values()) > 1 else 1
            want = dict(jax_make_mesh(jcfg[kind]["mesh"], devices=jax.devices()[:n]).shape)
            assert resolve_axes(axes, n) == want, f.name


def test_tp_server_matches_unsharded_and_jax_tp_server(tmp_path):
    """INT8 fused weights (the served layout): the TP server's tokens equal
    the unsharded port server's and JAX's unsharded server's (JAX's TP
    server shards no INT8 scale); float weights: equal to JAX's TP server's
    too. Near-greedy sampling (``test_torch_serving.py``'s recipe)."""
    from jax.sharding import Mesh

    from test_torch_serving import RECIPE, TINY, _drain, _params
    from vector_quantization_tpu.models.transformers.llama import LlamaTransformer as JaxLlama
    from vector_quantization_tpu.parallel.sharding import TPStrategy as JaxTP
    from vector_quantization_tpu.tasks.sequence_modeling import TokenCodebook as JaxCodebook
    from vector_quantization_tpu.tasks.serving import ARServer as JaxServer
    from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer
    from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

    int8 = _params()
    fp = JaxLlama(**TINY).init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    fp = jax.tree_util.tree_map(np.asarray, dict(fp))
    fp["lm_head"] = (np.random.default_rng(9).standard_normal(fp["lm_head"].shape) * 0.1).astype(np.float32)
    weights = {"int8": (int8, dict(quantize=True, fused_qkv=True)), "float": (fp, {})}
    categories = (2, 7, 5, 1, 3)
    engines = {"paged": dict(), "dense": dict(paged=False)}
    payload = {"srv": {"case": "tp_server", "weights": weights, "tiny": TINY, "recipe": RECIPE,
                       "engines": engines, "categories": categories}}
    got = _ok(W.spawn(payload, 2, tmp_path), "srv")
    for kind, (params, model_kw) in weights.items():
        for name, engine in engines.items():
            port = ARServer(LlamaTransformer(**TINY, **model_kw), llama_params_from_flax(params),
                            TokenCodebook(11, 16), cache_dtype=torch.int8, device="cpu", **{**RECIPE, **engine})
            want = _drain(port, categories)
            jt = JaxLlama(**TINY, **({"quantize": True, "quantize_mode": "xla", "fused_qkv": True}
                                     if kind == "int8" else {}))
            strategy = None if kind == "int8" else JaxTP(Mesh(np.asarray(jax.devices()[:2]), ("tp",)))
            js = JaxServer(jt, jax.tree_util.tree_map(jnp.asarray, params), JaxCodebook(11, 16),
                           cache_dtype=jnp.int8, strategy=strategy, **{**RECIPE, **engine})
            jwant = _drain(js, categories)
            for rank in range(2):
                r = got[rank][f"{kind}/{name}"]
                assert r["tokens"].keys() == want.keys() == jwant.keys() == set(range(5))
                for rid in want:
                    np.testing.assert_array_equal(r["tokens"][rid], want[rid])
                    np.testing.assert_array_equal(r["tokens"][rid], jwant[rid])
                assert r["cache_heads"] == 1  # each rank's own head
                if name == "paged":
                    assert r["free"][0] == r["free"][1]
