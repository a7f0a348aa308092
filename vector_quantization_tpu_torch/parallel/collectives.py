"""Collectives over ``torch.distributed`` groups, and the layout of a
sharded tensor.

The JAX package runs every strategy as one global computation under
pjit/GSPMD: XLA inserts the psums, all-gathers and reduce-scatters that
the shardings imply. The port runs one process per device, so each one is
written out here:

- plain collectives on tensors (``all_reduce_sum``, ``all_reduce_mean``,
  ``all_gather_cat``, ``broadcast_``): a ``group`` of None means no process
  group (one process) and returns the input;
- the Megatron pair for tensor parallelism, autograd-aware:
  :func:`copy_to_group` (forward identity, backward all-reduce of the
  gradient) before a column-parallel product, :func:`reduce_from_group`
  (forward all-reduce, backward identity) after a row-parallel one, and
  :func:`gather_from_group` (forward all-gather, backward this rank's
  slice) where every rank then computes the same loss from the gathered
  tensor;
- :class:`Layout`: how a full tensor is split over a group's ranks along
  one dimension, in ``parts`` blocks each split over the ranks (1 for an
  FSDP shard or a plain column split; 3 for the fused ``q|k|v`` columns, 2
  for ``gate|up``), so that rank r's shard of a fused projection holds its
  own heads' q, k and v.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Layout",
    "all_gather_cat",
    "all_reduce_mean",
    "all_reduce_sum",
    "broadcast_",
    "copy_to_group",
    "gather_from_group",
    "group_rank",
    "group_size",
    "reduce_from_group",
    "reduce_scatter_mean",
]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in place (and returned)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor averaged over the group in place: one flat all-reduce per
    dtype (``Strategy`` reduces a step's gradients with it)."""
    if group is None or not tensors:
        return
    n = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in ts]), ts)])


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (no
    gradient)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` replaced by group rank ``src``'s, in place."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def reduce_scatter_mean(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's mean of ``t``, this rank's contiguous chunk along ``dim``."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.div_(n).movedim(0, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, group_rank(ctx.group) * ctx.n, ctx.n), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Forward identity; backward: the gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Forward: summed over ``group``; backward identity."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Forward: the group's tensors concatenated along ``dim``; backward:
    this rank's slice of the gradient (every rank computes the same loss
    from the gathered tensor)."""
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A tensor split along ``dim`` over ``size`` ranks of ``group``: the
    dimension is ``parts`` equal blocks, each cut into ``size`` chunks, and
    rank r holds chunk r of every block, in block order."""

    dim: int
    rank: int
    size: int
    group: object = None
    parts: int = 1

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` (a view where ``parts`` is 1)."""
        n = full.shape[self.dim] // (self.parts * self.size)
        if self.parts == 1:
            return full.narrow(self.dim, self.rank * n, n)
        x = full.unflatten(self.dim, (self.parts, self.size, n)).select(self.dim + 1, self.rank)
        return x.flatten(self.dim, self.dim + 1)

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's shard put back together (an all-gather)."""
        if self.group is None:
            shards = [local]
        else:
            shards = [torch.empty_like(local) for _ in range(self.size)]
            dist.all_gather(shards, local.contiguous(), group=self.group)
        blocks = [s.unflatten(self.dim, (self.parts, -1)) for s in shards]
        return torch.stack(blocks, dim=self.dim + 1).flatten(self.dim, self.dim + 2)
