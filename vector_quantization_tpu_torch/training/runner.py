"""Runners (port of ``vector_quantization_tpu/training/runner.py``): the
host loops around an algorithm's steps.

``Trainer.run`` cycles the data loader up to ``max_iters``, one
``algorithm.train_step`` per iteration, and never synchronises the device
itself: the step's metrics stay tensors, and only the callbacks that log
them read them to the host, at their interval. Batches reach the device
two ahead of the step that takes them (``_device_prefetch``): on CUDA each
batch is pinned and copied with ``non_blocking`` on a copy stream, the
compute stream waits on the copy's event, and the device tensors are
``record_stream``-ed to the compute stream so the allocator does not reuse
them while a step still reads them. ``Validator.run`` runs ``eval_step``
over its loader into the configured metrics, built with the loader's
dataset as the JAX runner builds them (``FIDMetric`` reads its
``fid_path``), and with ``visual`` dumps images.

Data order is the JAX runner's: its ``init_state`` draws one batch from a
fresh epoch (to trace the model), so training starts at the loader's next
epoch; the port's ``init_state`` needs no batch but advances the epoch the
same way. A resumed run starts at the batch after the checkpoint's step
(``DataLoader.seek``), so two steps, a checkpoint and one more step take
the batches three straight steps take. (The JAX runner restarts that
epoch's batches on resume instead.)

``build_runner(config, kind, device=None)`` assembles a runner from a config
tree: ``device`` None means CUDA, which must be available; tests pass
``"cpu"``. The algorithm's weights are drawn on the host from the CPU
generator seeded with the runner's ``seed`` (3407 by default), and then
moved to the device; the global generators are left as they were.

Under ``torch.distributed`` (``parallel.mesh.init_distributed``, which the
CLI calls) the config's ``mesh`` spans the world, every rank draws the same
weights, and the strategy (``parallel/sharding.py``) binds the algorithm
before its state is made: the loader reads this rank's rows of the data
row (``dp`` x ``fsdp``; ranks of one ``tp`` row read the same rows), a
step runs inside the strategy's ``step_scope`` and its metrics are the
global batch's means, and the state lives sharded between steps (FSDP)
and whole outside ``run``. A checkpoint holds the full state (the
strategy's ``full_state`` gathers it), written by rank 0 while the others
wait at a barrier, so it restores at any world size.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import re
from typing import Any, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.base import pixel_decode, require_pil
from ..data.loader import DataLoader
from ..parallel.mesh import make_mesh, process_index
from ..parallel.sharding import Strategy
from ..registries import (
    AlgorithmRegistry,
    CallbackRegistry,
    DatasetRegistry,
    MetricRegistry,
    RunnerRegistry,
    StrategyRegistry,
)
from ..tasks.image_tokenization import model_device
from ..utils.flags import Store
from . import checkpoints as ckpt
from .callbacks import BaseCallback
from .state import TrainState

__all__ = ["Trainer", "Validator", "build_runner"]

logger = logging.getLogger("vector_quantization_tpu_torch")


def _device_batch(batch: Mapping[str, Any]) -> dict[str, Any]:
    """The batch without its host-only fields (the string ids)."""
    return {k: v for k, v in batch.items() if k != "id_"}


class _RunnerBase:
    def __init__(
        self,
        *,
        name: str,
        algorithm: Any,
        dataloader: DataLoader,
        strategy: Strategy,
        work_dir: str | None = None,
        callbacks: Sequence[BaseCallback] = (),
        seed: int = 3407,
    ) -> None:
        self.name = name
        self.algorithm = algorithm
        self.dataloader = dataloader
        self.strategy = strategy
        self.work_dir = work_dir or os.path.join("work_dirs", name)
        os.makedirs(self.work_dir, exist_ok=True)
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.bind(self)
        self.seed = seed
        self.state: TrainState | None = None
        self._first_epoch = dataloader.epoch

    def init_state(self) -> TrainState:
        self.dataloader.epoch += 1  # the JAX runner's draw of one batch (module docstring)
        self._first_epoch = self.dataloader.epoch
        self.state = self.algorithm.init_state(self.seed)
        self.strategy.attach(self.algorithm, self.state)
        return self.state

    def save_checkpoint(self, step: int) -> None:
        """The full state, gathered on every rank, written by rank 0."""
        with self.strategy.full_state(self.algorithm, self.state):
            if process_index() == 0:
                path = ckpt.save_checkpoint(self.work_dir, self.algorithm, self.state, step)
                logger.info("saved checkpoint %s", path)
        if dist.is_initialized():
            dist.barrier()

    def load_model_from(self, paths: str | list[str]) -> None:
        if self.state is None:
            self.init_state()
        with self.strategy.full_state(self.algorithm, self.state):
            ckpt.load_model_from(paths, self.algorithm.param_tree(self.state))

    def resume(self, path: str | None = None, auto: bool = False) -> bool:
        if self.state is None:
            self.init_state()
        if path is None and auto:
            path = ckpt.latest_checkpoint(self.work_dir)
        if path is None:
            return False
        with self.strategy.full_state(self.algorithm, self.state):
            ckpt.restore_checkpoint(path, self.algorithm, self.state)
        logger.info("resumed from %s (step %d)", path, self.state.step)
        return True


@RunnerRegistry.register()
class Trainer(_RunnerBase):
    def __init__(self, *, max_iters: int, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.max_iters = 5 if Store.DRY_RUN else max_iters
        self.start_step = 0

    def _batches(self) -> Iterator[Mapping[str, Any]]:
        while True:
            yield from self.dataloader

    def _device_prefetch(self, batches: Iterable[Mapping[str, Any]], depth: int = 2):
        device = self.strategy.device
        if device.type != "cuda":
            for batch in batches:
                yield self.strategy.shard_batch(_device_batch(batch))
            return
        copy_stream = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)
        pending: collections.deque = collections.deque()
        it = iter(batches)

        def enqueue(n: int) -> None:
            for batch in itertools.islice(it, n):
                with torch.cuda.stream(copy_stream):
                    out = self.strategy.shard_batch(_device_batch(batch))
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                pending.append((out, done))

        enqueue(depth)
        while pending:
            out, done = pending.popleft()
            compute.wait_event(done)
            for t in out.values():
                t.record_stream(compute)
            yield out
            enqueue(1)

    def run(self) -> TrainState:
        if self.state is None:
            self.init_state()
        for cb in self.callbacks:
            cb.before_run()
        self.start_step = start = self.state.step
        per_epoch = len(self.dataloader)
        if per_epoch:
            self.dataloader.seek(self._first_epoch + start // per_epoch, start % per_epoch)
        batches = itertools.islice(self._batches(), max(self.max_iters - start, 0))
        self.strategy.shard_state(self.algorithm, self.state)
        try:
            for i, batch in enumerate(self._device_prefetch(batches), start=start + 1):
                self.state, metrics = self.strategy.train_step(self.algorithm, self.state, batch)
                for cb in self.callbacks:
                    cb.after_run_iter(i, metrics)
            for cb in self.callbacks:
                cb.after_run()
        finally:
            self.strategy.unshard_state(self.algorithm, self.state)
        return self.state


@RunnerRegistry.register()
class Validator(_RunnerBase):
    def __init__(self, *, metrics: Mapping[str, Any] | None = None,
                 visual: Mapping[str, Any] | None = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.metric_cfgs = dict(metrics or {})
        # keys regex-filtered; 'batched': one strip per iteration, 'unbatched': one PNG per image
        self.visual = dict(visual) if visual else None
        self.max_iters = 0

    def _dump_visuals(self, memo: Mapping[str, Any], batch, it: int) -> None:
        image = require_pil()
        cfg = self.visual
        pattern = cfg.get("pattern")
        out_dir = os.path.join(self.work_dir, "visuals")
        os.makedirs(out_dir, exist_ok=True)
        for key in cfg.get("keys", ["pred"]):
            if (pattern and not re.search(pattern, key)) or key not in memo:
                continue
            imgs = pixel_decode(memo[key]).cpu().numpy()
            if cfg.get("mode", "unbatched") == "batched":
                image.fromarray(np.concatenate(list(imgs), axis=1)).save(
                    os.path.join(out_dir, f"{key}_{it}.png"))
                continue
            for j, img in enumerate(imgs):
                name = batch["id_"][j].replace("/", "_") if "id_" in batch else f"{it}_{j}"
                image.fromarray(img).save(os.path.join(out_dir, f"{key}_{name}.png"))

    def run(self, state: TrainState | None = None) -> dict[str, float]:
        if state is not None:
            self.state = state
        elif self.state is None:
            self.init_state()
        metric_objs = {name: MetricRegistry.build(cfg, dataset=self.dataloader.dataset,
                                                  group=self.strategy.data_group)
                       for name, cfg in self.metric_cfgs.items()}
        n = len(self.dataloader)
        if Store.DRY_RUN:
            n = min(n, 2)
        self.max_iters = n
        for cb in self.callbacks:
            cb.before_run()
        for i, batch in enumerate(itertools.islice(self.dataloader, n), 1):
            memo = dict(self.algorithm.eval_step(self.state, self.strategy.shard_batch(_device_batch(batch))))
            memo["batch"] = batch
            for m in metric_objs.values():
                m.update(memo)
            if self.visual is not None:
                self._dump_visuals(memo, batch, i)
            for cb in self.callbacks:
                cb.after_run_iter(i, {})
        results: dict[str, float] = {}
        for name, m in metric_objs.items():
            results.update(m.summary(name))
        for cb in self.callbacks:
            cb.after_run()
        logger.info("validation[%s]: %s", self.name, results)
        return results


def build_runner(config: Mapping[str, Any], kind: str = "trainer", device: torch.device | str | None = None,
                 work_dir: str | None = None) -> Any:
    """The ``kind`` ("trainer" or "validator") runner of a config tree."""
    cfg = dict(config[kind])
    device = model_device(device)
    mesh = make_mesh(cfg.pop("mesh", None), device_type=device.type)
    strategy = StrategyRegistry.build(cfg.pop("strategy", {"type": "DataParallelStrategy"}), mesh=mesh,
                                      device=device)
    dataset = DatasetRegistry.build(cfg.pop("dataset"))
    loader_cfg = {"num_processes": strategy.data_size, "process_index": strategy.data_rank,
                  **cfg.pop("dataloader", {})}
    dataloader = DataLoader(dataset, **loader_cfg)
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(cfg.get("seed", 3407))
        algorithm = AlgorithmRegistry.build(cfg.pop("algorithm"), device=device)
    strategy.bind(algorithm)
    callbacks = [CallbackRegistry.build(c) for c in cfg.pop("callbacks", [])]
    runner_type = cfg.pop("type", "Trainer" if kind == "trainer" else "Validator")
    if work_dir is not None:
        cfg["work_dir"] = work_dir
    return RunnerRegistry.build(
        {"type": runner_type, **cfg}, algorithm=algorithm, dataloader=dataloader, strategy=strategy,
        callbacks=callbacks, name=config.get("name", kind))
