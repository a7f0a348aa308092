"""Process and device layout (port of ``vector_quantization_tpu/parallel/mesh.py``),
for one process on one device.

``process_index``/``process_count`` read ``torch.distributed`` when a
process group is up, else 0 and 1: the data loader's global-batch split
asks them. ``make_mesh`` resolves a config's ``mesh`` axes (``{"dp": -1}``:
one -1 axis takes the devices left) over the one device the port drives; a
mesh over more than one device is ROADMAP's "Parallelism" item and raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "process_count", "process_index"]

_PARALLELISM = "ROADMAP.md queue A: Parallelism"


def init_distributed(num_processes: int | None = None) -> None:
    """One process: nothing to do. ``JAX_NUM_PROCESSES`` (the JAX package's
    multi-host launch) above 1 raises: multi-process runs are not ported."""
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes > 1:
        raise NotImplementedError(f"{num_processes} processes: {_PARALLELISM}")


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis name -> size; the sizes multiply to the device count."""

    shape: dict[str, int]


def make_mesh(axes: Mapping[str, int] | None = None, num_devices: int = 1) -> Mesh:
    """``axes`` over ``num_devices`` devices (default ``{"dp": all}``)."""
    if axes is None:
        axes = {"dp": num_devices}
    fixed = math.prod(s for s in axes.values() if s != -1)
    sizes = {k: (num_devices // fixed if s == -1 else s) for k, s in axes.items()}
    if math.prod(sizes.values()) != num_devices or num_devices % fixed:
        raise NotImplementedError(
            f"mesh {dict(axes)} over {num_devices} device(s): the port drives one device; {_PARALLELISM}")
    return Mesh(sizes)
