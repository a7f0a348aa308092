"""Placement strategies (port of ``vector_quantization_tpu/parallel/sharding.py``)
on one device.

A strategy places a host batch on its device (``shard_batch``): numpy
arrays become tensors; for a CUDA device they are pinned and copied with
``non_blocking`` on the stream the caller makes current (the trainer's copy
stream, see ``training/runner.py``). ``SingleDeviceStrategy`` and
``DataParallelStrategy`` (batch over ``dp``, parameters replicated) are the
same thing on one device. ``FSDPStrategy`` and ``TPStrategy`` are
registered, so every shipped config's strategy resolves, and raise: they
wait for ROADMAP's "Parallelism" item.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..registries import StrategyRegistry
from .mesh import Mesh, make_mesh

__all__ = ["Strategy", "SingleDeviceStrategy", "DataParallelStrategy", "FSDPStrategy", "TPStrategy"]

_PARALLELISM = "ROADMAP.md queue A: Parallelism"


class Strategy:
    def __init__(self, mesh: Mesh | None = None, device: torch.device | str = "cuda") -> None:
        self.mesh = mesh or make_mesh()
        self.device = torch.device(device)

    def host_tensor(self, value: Any) -> torch.Tensor:
        """A host array as a tensor, pinned where the device is CUDA."""
        t = torch.as_tensor(np.asarray(value))
        return t.pin_memory() if self.device.type == "cuda" else t

    def shard_batch(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Host arrays -> tensors on the device. On CUDA the host side is
        pinned first, so the ``non_blocking`` copy is asynchronous (a copy
        from pageable memory is not)."""
        return {k: self.host_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}


@StrategyRegistry.register()
class SingleDeviceStrategy(Strategy):
    """One device, nothing sharded."""


@StrategyRegistry.register()
class DataParallelStrategy(Strategy):
    """Batch over ``dp``, parameters replicated: on one device, the device."""


@StrategyRegistry.register()
class FSDPStrategy(Strategy):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"FSDPStrategy: {_PARALLELISM}")


@StrategyRegistry.register()
class TPStrategy(Strategy):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"TPStrategy: {_PARALLELISM}")
