"""Debug utilities (port of ``vector_quantization_tpu/utils/debug.py``): the
cross-rank sync assert, a profiler trace and the port's spans.

:func:`assert_replicated` checks that a tensor every rank of a group
should hold identically (the codebook) is bit-identical on all of them: it
all-gathers a digest of the tensor's bytes (SHA-256, eight int64 words) and
raises ``AssertionError`` naming the ranks that differ from the group's
first. Active under ``DEBUG`` or ``DRY_RUN``, as in the JAX package.

``with trace(dir):`` records ``torch.profiler`` (CPU, and CUDA where there
is a GPU) into ``dir/trace.json``; ``trace(None)`` does nothing.

``with span("vq.<name>"):`` marks a phase of the port (a train step, its
backward, the optimizer, K1's entry, ...) as a ``record_function`` range
while a profiler records (``trace``, ``ProfileCallback``, the benchmark's
traced runs), so the phase lands in the same trace as the kernels it
launches, on the profiler's clock. While none records it is one shared
no-op context: the only cost is reading the profiler's flag. Every name
starts with ``vq.``, apart from the benchmark's own range names and the f32
GEMM's product ranges (``gpt2.gemm``, and those ``ops/f32_gemm.py``'s
``product`` is given by name), which are opened in backward too and are
not phases.

:class:`BackwardRange` names the backward of a region of the forward: a
range opened on autograd's thread when the gradient reaches the region's
output and closed when it leaves the region's input. Its names never
start with ``vq.``: a ``vq.`` span opened on autograd's thread would be
handed on to later launches there (``benchmark/spans.py``).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .flags import Store

__all__ = ["BackwardRange", "assert_replicated", "digest", "span", "trace"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else the shared no-op context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class _Opens(torch.autograd.Function):
    """Identity; its backward opens the region's range."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.region.open()
        return g, None


class _Closes(torch.autograd.Function):
    """Identity; its backward closes the region's range."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.region.close()
        return g, None


class BackwardRange:
    """The profiler range ``name`` around the backward of one region of the
    forward: ``x = r.input(x)`` where the region starts, ``y = r.output(y)``
    where it ends. Autograd's engine runs the nodes with the higher
    sequence numbers first, so the region's nodes run between the output's
    marker and the input's. Where no profiler records, or no gradient is
    taken, both return their argument and nothing is added to the graph.
    The input must be used inside the region alone."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._on = torch.autograd.profiler._is_profiler_enabled and torch.is_grad_enabled()
        self._range = None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return _Closes.apply(x, self) if self._on and x.requires_grad else x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _Opens.apply(y, self) if self._on and y.requires_grad else y

    def open(self) -> None:
        if self._range is None:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def digest(x: torch.Tensor) -> torch.Tensor:
    """SHA-256 of the tensor's bytes (its shape and dtype included) as eight
    int64 words."""
    t = x.detach().contiguous().cpu()
    h = hashlib.sha256(f"{tuple(t.shape)}{t.dtype}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return torch.from_numpy(np.frombuffer(h.digest(), dtype=np.int64).copy())


def assert_replicated(x: torch.Tensor, name: str = "tensor", group: Any = None, force: bool = False) -> None:
    """Raise ``AssertionError`` when ``x`` is not bit-identical on every rank
    of ``group`` (default: all); only under ``DEBUG``/``DRY_RUN`` unless
    ``force``. Without a process group there is one replica."""
    if not (force or Store.DEBUG or Store.DRY_RUN) or not dist.is_initialized():
        return
    mine = digest(x)
    if dist.get_backend(group) == "nccl":
        mine = mine.cuda()
    n = dist.get_world_size(group)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine, group=group)
    bad = [dist.get_global_rank(group, r) if group is not None else r
           for r in range(1, n) if not torch.equal(every[r], every[0])]
    if bad:
        first = dist.get_global_rank(group, 0) if group is not None else 0
        raise AssertionError(f"{name} diverged across ranks: rank(s) {bad} differ from rank {first}")


class trace:
    """``with trace('dir'):`` a ``torch.profiler`` trace into
    ``dir/trace.json`` (``trace(None)``: nothing)."""

    def __init__(self, log_dir: str | None) -> None:
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        if self.log_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc: Any):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
            self._prof = None
        return False
