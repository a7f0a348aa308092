"""Process groups and the device mesh (port of
``vector_quantization_tpu/parallel/mesh.py``) over ``torch.distributed``.

One process drives one device. :func:`init_distributed` starts the default
process group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): ``nccl`` for CUDA,
``gloo`` for the CPU. :func:`make_mesh` resolves a config's ``mesh`` axes
(``{"dp": -1}``, ``{"dp": -1, "fsdp": n}``, ``{"dp": -1, "tp": n}``: one -1
axis takes the ranks left) over the world into a :class:`Mesh`, a
``torch.distributed.device_mesh.DeviceMesh`` with named axes and the
process group of every set of axes a strategy reduces over. Ranks are laid
out row-major over the axes, as ``np.arange(world).reshape(sizes)``, so the
last axis (``tp``) varies fastest. Without a process group (one process)
the mesh has one rank and no groups, and every collective is the identity;
a mesh of more than one rank is backed by the world's groups or refused, so
no strategy runs on a split batch without reducing it. :func:`resolve_axes`
resolves the sizes alone, over any number of devices.

:func:`host_allreduce_sum` sums a host numpy array over the processes (the
metrics' ``summary``).
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "host_allreduce_sum", "init_distributed", "make_mesh", "process_count", "process_index",
           "resolve_axes"]


def init_distributed(device: torch.device | str | None = None) -> bool:
    """Start the default process group from torchrun's environment, once;
    True when a group is up. Without ``WORLD_SIZE`` in the environment (a
    plain ``python -m ...``) this is one process and nothing starts.
    ``device`` None or CUDA: ``nccl``, and the process's device is
    ``cuda:LOCAL_RANK``; ``"cpu"``: ``gloo``."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """Named axes over the world's ranks. ``shape`` maps axis -> size;
    ``device_mesh`` is the ``DeviceMesh`` (None without a process group);
    :meth:`group` is the process group of this rank's row along some axes,
    :meth:`rank` and :meth:`size` this rank's index and the row's length.
    ``groups=False`` (one device, no collective) takes one rank only; a
    mesh of more ranks raises ``ValueError`` unless the world's process
    group is up and as large."""

    def __init__(self, shape: Mapping[str, int], device_type: str = "cuda", groups: bool = True) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = None
        self._groups: dict[tuple[str, ...], object] = {}
        world = math.prod(self.shape.values())
        self._coords = np.unravel_index(process_index(), tuple(self.shape.values()))
        if not (groups and dist.is_initialized()):
            if world > 1:
                raise ValueError(f"mesh {self.shape} spans {world} ranks without their process groups")
            return
        if world != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} over a world of {dist.get_world_size()} ranks")
        from torch.distributed.device_mesh import DeviceMesh

        ranks = np.arange(world).reshape(tuple(self.shape.values()))
        self.device_mesh = DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=self.axis_names)
        # one group per set of axes a strategy reduces over; every rank
        # creates every group, in the same order (new_group's rule)
        for axes in (("dp",), ("fsdp",), ("tp",), ("dp", "fsdp")):
            axes = tuple(a for a in axes if a in self.shape)
            if not axes or axes in self._groups:
                continue
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
                continue
            keep = [self.axis_names.index(a) for a in axes]
            rows = np.moveaxis(ranks, keep, list(range(len(keep)))).reshape(
                math.prod(self.shape[a] for a in axes), -1)
            for col in range(rows.shape[1]):
                g = dist.new_group(rows[:, col].tolist())
                if dist.get_rank() in rows[:, col]:
                    self._groups[axes] = g

    def _axes(self, axes: Sequence[str]) -> tuple[str, ...]:
        return tuple(a for a in axes if a in self.shape)

    def group(self, axes: Sequence[str]):
        """The process group along ``axes`` (those of them in the mesh);
        None without a process group or without such an axis."""
        return self._groups.get(self._axes(axes))

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def rank(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes``, row-major."""
        axes = self._axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + int(self._coords[self.axis_names.index(a)])
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def resolve_axes(axes: Mapping[str, int] | None, n: int) -> dict[str, int]:
    """The axis sizes of ``axes`` over ``n`` devices (``{"dp": n}`` by
    default). A single -1 axis absorbs the devices the others leave; sizes
    that do not multiply out raise ``ValueError``, as the JAX package's
    ``make_mesh`` does."""
    if axes is None:
        axes = {"dp": n}
    names = list(axes)
    sizes = [int(axes[k]) for k in names]
    fixed = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if sizes.count(-1) > 1 or n % fixed:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        sizes = [n // fixed if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return dict(zip(names, sizes))


def make_mesh(axes: Mapping[str, int] | None = None, device_type: str = "cuda") -> Mesh:
    """The :class:`Mesh` of ``axes`` (:func:`resolve_axes`) over the world's
    ranks."""
    return Mesh(resolve_axes(axes, process_count()), device_type)


def host_allreduce_sum(x, group=None) -> np.ndarray:
    """A host numpy array summed over ``group``'s processes (default: all;
    the array itself without a process group). The sum runs on a tensor of
    the group's backend device, a CUDA tensor under ``nccl`` (NCCL reduces
    no host memory) and a CPU one under ``gloo``, in the array's dtype
    (float64 FID sums stay float64)."""
    x = np.asarray(x)
    if not dist.is_initialized():
        return x
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()
