"""Runner callbacks (port of ``vector_quantization_tpu/training/callbacks.py``).

``LogCallback`` (``Iter [i/N] ETA ... k=v`` every ``interval`` steps, with
an EMA-smoothed step time) and ``TensorBoardCallback`` are the only places
that read a step's metrics to the host, and only at their interval: the
trainer never synchronises the device otherwise. ``CheckpointCallback``
saves every ``interval`` steps and at the last. ``ProfileCallback`` records
steps [start, start + steps) with ``torch.profiler`` into
``work_dir/profile``. ``GitCallback`` writes ``git diff HEAD`` to
``work_dir/git.diff``. ``SyncCheckCallback`` asserts after every step, under
``DEBUG``/``DRY_RUN``, that the codebook is bit-identical on every rank of
the data group (``utils.debug.assert_replicated``). Under
``torch.distributed`` only rank 0 logs, writes TensorBoard and the git
snapshot.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
from typing import Any, Mapping

import torch

from ..parallel.mesh import process_index
from ..registries import CallbackRegistry

__all__ = ["BaseCallback", "CheckpointCallback", "GitCallback", "LogCallback", "ProfileCallback",
           "SyncCheckCallback", "TensorBoardCallback"]

logger = logging.getLogger("vector_quantization_tpu_torch")


def _scalars(metrics: Mapping[str, Any]) -> dict[str, float]:
    """The 0-d entries as floats (this synchronises the device)."""
    return {k: float(v) for k, v in metrics.items() if torch.as_tensor(v).dim() == 0}


class BaseCallback:
    def bind(self, runner: Any) -> None:
        self.runner = runner

    def before_run(self) -> None: ...

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None: ...

    def after_run(self) -> None: ...


@CallbackRegistry.register()
class LogCallback(BaseCallback):
    def __init__(self, interval: int = 50, ema: float = 0.9) -> None:
        self.interval = interval
        self.ema = ema
        self._t = 0.0
        self._iter_time: float | None = None

    def before_run(self) -> None:
        self._t = time.perf_counter()

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None:
        now = time.perf_counter()
        dt, self._t = now - self._t, now
        self._iter_time = dt if self._iter_time is None else self.ema * self._iter_time + (1 - self.ema) * dt
        if (step % self.interval and step != self.runner.max_iters) or process_index():
            return
        remaining = (self.runner.max_iters - step) * self._iter_time
        eta = time.strftime("%H:%M:%S", time.gmtime(max(remaining, 0)))
        kv = " ".join(f"{k}={v:.4g}" for k, v in _scalars(metrics).items())
        logger.info("Iter [%d/%d] ETA %s %s", step, self.runner.max_iters, eta, kv)


@CallbackRegistry.register()
class CheckpointCallback(BaseCallback):
    def __init__(self, interval: int = 10_000, save_last: bool = True) -> None:
        self.interval = interval
        self.save_last = save_last

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None:
        if step % self.interval == 0 or (self.save_last and step == self.runner.max_iters):
            self.runner.save_checkpoint(step)


@CallbackRegistry.register()
class TensorBoardCallback(BaseCallback):
    def __init__(self, interval: int = 50, tag: str = "train") -> None:
        self.interval = interval
        self.tag = tag
        self._writer = None

    def before_run(self) -> None:
        if process_index():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("tensorboard unavailable; skipping")
            return
        self._writer = SummaryWriter(os.path.join(self.runner.work_dir, "tensorboard"))

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None:
        if self._writer is None or step % self.interval:
            return
        for k, v in _scalars(metrics).items():
            self._writer.add_scalar(f"{self.tag}/{k}", v, step)

    def after_run(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


@CallbackRegistry.register()
class ProfileCallback(BaseCallback):
    def __init__(self, start: int = 10, steps: int = 5) -> None:
        self.start = start
        self.steps = steps
        self._prof = None

    def _stop(self) -> None:
        self._prof.__exit__(None, None, None)
        out = os.path.join(self.runner.work_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(out, "trace.json"))
        self._prof = None
        logger.info("profiler trace written to %s", out)

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None:
        if step == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.start + self.steps:
            self._stop()

    def after_run(self) -> None:
        if self._prof is not None:
            self._stop()


@CallbackRegistry.register()
class SyncCheckCallback(BaseCallback):
    """After each step, under ``DEBUG``/``DRY_RUN``: the leaf at ``path`` of
    the state's parameter tree (default: the algorithm's
    ``codebook_path``) must be bit-identical across the data group."""

    def __init__(self, path: tuple[str, ...] | None = None) -> None:
        self.path = tuple(path) if path else None

    def after_run_iter(self, step: int, metrics: Mapping[str, Any]) -> None:
        from ..utils.debug import assert_replicated
        from ..utils.flags import Store

        runner = self.runner
        path = self.path or getattr(runner.algorithm, "codebook_path", None)
        if path is None or not (Store.DEBUG or Store.DRY_RUN):
            return
        with runner.strategy.full_state(runner.algorithm, runner.state):  # shards compared whole
            node = runner.algorithm.param_tree(runner.state)
            try:
                for k in path:
                    node = node[k]
            except (KeyError, TypeError):
                return
            assert_replicated(node, "/".join(path), runner.strategy.data_group)


@CallbackRegistry.register()
class GitCallback(BaseCallback):
    def before_run(self) -> None:
        if process_index():
            return
        try:
            diff = subprocess.run(["git", "diff", "HEAD"], capture_output=True, text=True, timeout=30,
                                  check=False).stdout
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("git snapshot failed: %s", e)
            return
        with open(os.path.join(self.runner.work_dir, "git.diff"), "w") as f:
            f.write(diff)
