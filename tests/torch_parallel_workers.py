"""The rank side of ``tests/test_torch_parallel.py``: what each spawned
process runs under a ``gloo`` group. It imports torch and the port only,
never JAX (a spawned child imports this module to find its function); the
test computes the JAX references in its own process.

:func:`spawn` starts ``world`` processes (spawned, not forked), each with
one intra-op thread and a ``FileStore`` under the test's temporary
directory, runs the named cases on each rank and returns every rank's
results. It bounds itself: the children are joined against a deadline and
killed past it, and the group's own timeout ends a collective that a
failed rank left waiting.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def spawn(cases: dict, world: int, tmp_path, timeout: float = 150.0) -> list[dict]:
    """Run ``cases`` (name -> payload) on ``world`` ranks; returns each
    rank's {name: result}. A case that raised returns its traceback as
    ``{"error": ...}``."""
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(cases, f)
    ctx = mp.start_processes(_child, args=(world, tmp), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, payload in cases.items():
            try:
                results[name] = CASES[payload["case"]](rank, world, payload, tmp)
            except Exception:  # noqa: BLE001 - reported to the test
                results[name] = {"error": traceback.format_exc()}
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# -- helpers ---------------------------------------------------------------


def _strategy(kind: str = "DataParallelStrategy", axes=None, **kw):
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.registries import StrategyRegistry

    return StrategyRegistry.build({"type": kind, **kw}, mesh=make_mesh(axes, device_type="cpu"), device="cpu")


def _rows(batch: dict, rank: int, world: int) -> dict:
    """This data rank's rows of a global numpy batch, as tensors."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // world
        out[k] = torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
    return out


def _train(strategy, algo, state, batches, rank, world):
    """The runner's life cycle by hand: attach, shard, steps, unshard."""
    strategy.attach(algo, state)
    strategy.shard_state(algo, state)
    metrics = []
    for batch in batches:
        state, m = strategy.train_step(algo, state, _rows(batch, rank, world))
        metrics.append({k: float(v) for k, v in m.items()})
    strategy.unshard_state(algo, state)
    return state, metrics


# -- cases -----------------------------------------------------------------


def case_vqgan(rank, world, p, tmp):
    """Two VQGAN steps (PatchGAN's BatchNorm, the adaptive weight) on this
    rank's half of each global batch."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import batch_stats_to_flax, params_to_flax, state_dict_from_flax

    algo = AlgorithmRegistry.build(p["cfg"], device="cpu")
    algo.model.load_state_dict(state_dict_from_flax(algo.model, p["g"]))
    algo.discriminator.load_state_dict(state_dict_from_flax(algo.discriminator, p["d"], p["stats"]))
    if algo.lpips_module is not None:
        algo.lpips_module.load_state_dict(state_dict_from_flax(algo.lpips_module, p["lpips"]))
    strategy = _strategy()
    strategy.bind(algo)
    state = algo.init_state(0)
    state.step = p["start"]
    state, metrics = _train(strategy, algo, state, [{"image": x} for x in p["images"]], rank, world)
    return {"metrics": metrics, "g": params_to_flax(algo.model), "d": params_to_flax(algo.discriminator),
            "stats": batch_stats_to_flax(algo.discriminator)}


def case_ar(rank, world, p, tmp):
    """AR steps on this rank's rows (``cfg`` drop drawn for the global batch)."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import llama_params_to_flax, load_ar_from_flax

    algo = AlgorithmRegistry.build(p["cfg"], device="cpu")
    load_ar_from_flax(algo, p["params"], p["ir_params"])
    strategy = _strategy()
    strategy.bind(algo)
    state = algo.init_state(p.get("seed", 0))
    state, metrics = _train(strategy, algo, state, p["batches"], rank, world)
    return {"metrics": metrics, "params": llama_params_to_flax(algo.model)}


def case_tokenizer(rank, world, p, tmp):
    """VQ-KD (the lazy k-means init over the gathered features, fed the JAX
    draws, then the EMA k-means) or Cluster (CVQ's synced anchors)."""
    from vector_quantization_tpu_torch.ops import codebook as cb

    kmeans_init = cb.kmeans_init
    if p.get("draws") is not None:
        it = iter(p["draws"])
        cb.kmeans_init = functools.partial(kmeans_init, draw=lambda n, m: torch.from_numpy(
            next(it).astype(np.int64)))
    try:
        return _tokenizer_steps(rank, world, p)
    finally:
        cb.kmeans_init = kmeans_init


def _tokenizer_steps(rank, world, p):
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import extra_from_flax, extra_to_flax, params_to_flax, \
        state_dict_from_flax

    algo = AlgorithmRegistry.build(p["cfg"], device="cpu")
    algo.model.load_state_dict(state_dict_from_flax(algo.model, p["params"]))
    strategy = _strategy()
    strategy.bind(algo)
    state = algo.init_state(0)
    extra_from_flax(algo, state, p["extra"])
    state, metrics = _train(strategy, algo, state, p["batches"], rank, world)
    extra = extra_to_flax(algo, state)
    extra.pop("teacher_params", None)
    return {"metrics": metrics, "params": params_to_flax(algo.model), "extra": extra}


def case_fsdp(rank, world, p, tmp):
    """FSDP (``min_size`` 256) steps: the shards' local shapes between steps,
    the full parameters after, and a checkpoint of the full state written
    by rank 0."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.training import checkpoints as ckpt
    from vector_quantization_tpu_torch.utils.bridge import params_to_flax, state_dict_from_flax

    algo = AlgorithmRegistry.build(p["cfg"], device="cpu")
    algo.model.load_state_dict(state_dict_from_flax(algo.model, p["params"]))
    strategy = _strategy("FSDPStrategy", p["axes"], min_size=p["min_size"])
    strategy.bind(algo)
    state = algo.init_state(0)
    strategy.attach(algo, state)
    strategy.shard_state(algo, state)
    local = {}
    for batch in p["batches"]:
        state, _ = strategy.train_step(algo, state, _rows(batch, rank, world))
        local = {n: tuple(t.shape) for n, t in algo.model.named_parameters()}
        local["trace"] = [tuple(t.shape) for t in state.opt_state["trace"]]
    with strategy.full_state(algo, state):
        if rank == 0:
            ckpt.save_checkpoint(os.path.join(tmp, "work"), algo, state, state.step)
    dist.barrier()
    strategy.unshard_state(algo, state)
    return {"local": local, "params": params_to_flax(algo.model),
            "trace": [t.clone() for t in state.opt_state["trace"]],
            "ckpt": ckpt.checkpoint_path(os.path.join(tmp, "work"), state.step)}


def case_codebook(rank, world, p, tmp):
    """``ops/codebook.py``'s group reductions on this rank's rows."""
    from vector_quantization_tpu_torch.ops import codebook as cb

    group = dist.group.WORLD
    x, codes, d = (_rows({"a": p[k]}, rank, world)["a"] for k in ("x", "codes", "d"))
    e = torch.from_numpy(p["codebook"])
    counts, sums = cb.cluster_stats(x, codes, e.shape[0], group)
    prob = torch.from_numpy(p["probability"])
    return {
        "hist": cb.code_histogram(codes, e.shape[0], group),
        "freq": cb.code_frequency(codes, e.shape[0], group),
        "counts": counts, "sums": sums,
        "kmeans": cb.kmeans_update(e, x, codes, 0.9, group=group),
        "cvq_sync": cb.cvq_update(e, prob, x, d, codes, ema_decay=0.99, sync=True, group=group),
        "cvq_mean": cb.cvq_update(e, prob, x, d, codes, ema_decay=0.99, sync=False, group=group),
        "init": cb.kmeans_init(x, e.shape[0], torch.Generator().manual_seed(5), iters=3, group=group),
    }


def case_metrics(rank, world, p, tmp):
    """The validation metrics over this rank's batches, summed at summary."""
    from vector_quantization_tpu_torch.registries import MetricRegistry

    out = {}
    for name, cfg in p["metrics"].items():
        metric = MetricRegistry.build(cfg, group=dist.group.WORLD)
        for memo in p["memos"][rank::world]:
            metric.update({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in memo.items()})
        out.update(metric.summary(name))
    return out


def case_replicated(rank, world, p, tmp):
    """``assert_replicated`` on a replicated codebook, then on one rank
    perturbed by one ulp."""
    from vector_quantization_tpu_torch.utils.debug import assert_replicated

    e = torch.from_numpy(p["codebook"])
    assert_replicated(e, "codebook", force=True)
    if rank == p["perturb"]:
        e = e.clone()
        e.view(-1)[3] = torch.nextafter(e.view(-1)[3], torch.tensor(np.inf))
    try:
        assert_replicated(e, "codebook", force=True)
    except AssertionError as err:
        return {"raised": str(err)}
    return {"raised": None}


def case_tp_train(rank, world, p, tmp):
    """The TP config through ``build_runner``: the JAX weights cut to this
    rank's shards (``utils.bridge.shard_params``), two steps and the
    checkpoint callback's save (rank 0 writes the full state), then the
    full transformer (``full_state``)."""
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.bridge import (
        llama_params_from_flax,
        llama_params_to_flax,
        shard_params,
        state_dict_from_flax,
    )
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config(p["cfg"])
    runner = build_runner(cfg, "trainer", device="cpu", work_dir=os.path.join(tmp, "tp"))
    algo, strategy = runner.algorithm, runner.strategy
    layouts = strategy.named_layouts(algo.model)
    algo.model.load_state_dict(shard_params(llama_params_from_flax(p["params"]), layouts))
    algo.ir_model.load_state_dict(state_dict_from_flax(algo.ir_model, p["ir_params"]))
    heads = [b.num_heads for b in algo.model.blocks()]
    shapes = {n: tuple(t.shape) for n, t in algo.model.state_dict().items()}
    state = runner.run()
    with strategy.full_state(algo, state):
        params = llama_params_to_flax(algo.model)
    return {"mesh": dict(strategy.mesh.shape), "heads": heads, "shapes": shapes, "params": params,
            "step": state.step, "layouts": sorted(layouts)}


def case_tp_server(rank, world, p, tmp):
    """``ARServer(strategy=TPStrategy)``: every rank serves the same
    requests; its tokens, and its cache's heads."""
    from vector_quantization_tpu_torch.models.transformers.llama import LlamaTransformer
    from vector_quantization_tpu_torch.parallel.sharding import TPStrategy
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer
    from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

    out = {}
    for kind, (params, model_kw) in p["weights"].items():
        for name, engine in p["engines"].items():
            strategy = TPStrategy(make_mesh({"tp": world}, device_type="cpu"), device="cpu")
            server = ARServer(LlamaTransformer(**p["tiny"], **model_kw), llama_params_from_flax(params),
                              TokenCodebook(11, 16), cache_dtype=torch.int8, device="cpu", strategy=strategy,
                              **{**p["recipe"], **engine})
            for c in p["categories"]:
                server.submit(category=c)
            done = dict(server.run_until_drained())
            k = server.cache.k if server.paged else server.cache.k[0]
            out[f"{kind}/{name}"] = {
                "tokens": done, "cache_heads": int(k.shape[-2]),
                "free": (len(server._free_pages), server._total_pages) if server.paged else None}
    return out


def case_refusals(rank, world, p, tmp):
    """What must not run on this world of ``world`` ranks: one device's
    strategy on the world's mesh, a multi-rank mesh without groups (each
    the ValueError's message, or None when it built), and the data-parallel
    strategy that does run (its data size and rank)."""
    from vector_quantization_tpu_torch.parallel.mesh import Mesh, make_mesh

    out = {}
    for name, build in (("single", lambda: _strategy("SingleDeviceStrategy")),
                        ("ungrouped", lambda: Mesh({"dp": world}, device_type="cpu", groups=False))):
        try:
            build()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    dp = _strategy()
    out["dp"] = (dp.data_size, dp.data_rank, dp.data_group is not None, make_mesh(device_type="cpu").shape)
    return out


CASES = {
    "refusals": case_refusals,
    "vqgan": case_vqgan,
    "ar": case_ar,
    "tokenizer": case_tokenizer,
    "fsdp": case_fsdp,
    "codebook": case_codebook,
    "metrics": case_metrics,
    "replicated": case_replicated,
    "tp_train": case_tp_train,
    "tp_server": case_tp_server,
}
