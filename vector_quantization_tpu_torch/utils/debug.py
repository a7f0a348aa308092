"""Debug utilities (port of ``vector_quantization_tpu/utils/debug.py``): the
cross-rank sync assert and a profiler trace.

:func:`assert_replicated` checks that a tensor every rank of a group
should hold identically (the codebook) is bit-identical on all of them: it
all-gathers a digest of the tensor's bytes (SHA-256, eight int64 words) and
raises ``AssertionError`` naming the ranks that differ from the group's
first. Active under ``DEBUG`` or ``DRY_RUN``, as in the JAX package.

``with trace(dir):`` records ``torch.profiler`` (CPU, and CUDA where there
is a GPU) into ``dir/trace.json``; ``trace(None)`` does nothing.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .flags import Store

__all__ = ["assert_replicated", "digest", "trace"]


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
