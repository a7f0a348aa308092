"""Strategies (port of ``vector_quantization_tpu/parallel/sharding.py``) over
``torch.distributed``: one process per device, each holding its own rows of
the global batch.

Under pjit/GSPMD the JAX package shards the batch, keeps the loss the global
batch's mean and lets XLA insert the collectives. Here a strategy makes
every global quantity explicit:

- the batch: the data loader gives each rank its rows (``batch_spec``'s
  axes, ``dp`` and ``fsdp``; ranks of one ``tp`` row read the same rows);
- gradients: every train step takes them with ``torch.autograd.grad`` and
  hands them to :meth:`Strategy.apply_gradients` (the algorithms'
  ``apply_gradients``), which averages them over the data axes (the
  gradient of the global mean, for equal shares), reduce-scatters the
  sharded ones, and runs the optimizer on this rank's shards;
- BatchNorm statistics, codebook statistics, the lazy k-means init, CVQ's
  anchors and the adaptive GAN weight's gradients use :attr:`data_group`
  (``bind`` hands it to the modules and the algorithm).

``DataParallelStrategy``: parameters replicated, gradients averaged over
``dp`` (and ``fsdp``). ``FSDPStrategy``: parameters of at least
``min_size`` elements, and their optimizer moments, are shards along their
largest divisible dimension over ``fsdp`` (``dp`` without one) between
steps (:func:`fsdp_param_spec`); each step gathers the parameters, reduce-
scatters their gradients and moves the shards. ``TPStrategy``: the Llama's
projections Megatron-style over ``tp``, as the JAX package's
``llama_tp_param_spec`` lays them out (``models/transformers/llama.py``
``shard_llama_tp``; its unit is the head, so attention whose heads ``tp``
does not divide stays replicated, as do an FFN and a vocabulary it does
not divide).

A checkpoint is always the full state: :meth:`Strategy.full_state` gathers
the shards for the save (and for a restore, which it slices again).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..registries import StrategyRegistry
from .collectives import Layout, all_reduce_mean, reduce_scatter_mean
from .mesh import Mesh, make_mesh

__all__ = ["Strategy", "SingleDeviceStrategy", "DataParallelStrategy", "FSDPStrategy", "TPStrategy",
           "batch_spec", "fsdp_param_spec"]

DATA_AXES = ("dp", "fsdp")


def batch_spec(mesh: Mesh, batch_axes: tuple[str, ...] = DATA_AXES) -> tuple[str, ...]:
    """The mesh axes the batch is split over: every data-like axis present."""
    return tuple(a for a in batch_axes if a in mesh.shape)


def fsdp_param_spec(shape: Sequence[int], n: int, min_size: int = 2**14) -> int | None:
    """The dimension a parameter of ``shape`` is sharded along over ``n``
    ranks: the largest that ``n`` divides (the first of equal ones), or None
    (replicated) below ``min_size`` elements or where none divides."""
    if not shape or int(np.prod(shape)) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % n == 0:
            return d
    return None


def _sharded_tensor(owner: Any, key: Any) -> torch.Tensor:
    return owner[key] if isinstance(owner, list) else getattr(owner, key)


def _set_sharded_tensor(owner: Any, key: Any, value: torch.Tensor) -> None:
    if isinstance(owner, list):
        owner[key] = value
    elif isinstance(getattr(owner, key), nn.Parameter):
        getattr(owner, key).data = value
    else:
        owner._buffers[key] = value


class Strategy:
    """Places batches and reduces gradients; subclasses shard parameters.

    ``mesh`` defaults to ``{"dp": world}``. ``bind(algorithm)`` (``build_
    runner`` calls it before the state is made) hands the strategy to the
    algorithm and the data group to its BatchNorm layers."""

    def __init__(self, mesh: Mesh | None = None, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self.mesh = mesh or make_mesh(device_type=self.device.type)
        # tensors held as shards: (owner, key, layout); owner a module (key
        # the parameter's or buffer's name) or an optimizer moment list
        self._entries: list[tuple[Any, Any, Layout]] = []
        self._layouts: dict[int, Layout] = {}  # id(parameter) -> its layout
        self._local = False  # the entries hold their shards

    # -- the mesh ------------------------------------------------------------

    @property
    def data_group(self):
        """The process group of this rank's data row (``dp`` x ``fsdp``):
        the ranks whose rows make the global batch."""
        return self.mesh.group(batch_spec(self.mesh))

    @property
    def data_size(self) -> int:
        return self.mesh.size(batch_spec(self.mesh))

    @property
    def data_rank(self) -> int:
        return self.mesh.rank(batch_spec(self.mesh))

    @property
    def shard_group(self):
        """The group the sharded tensors are split over (None: none are)."""
        return None

    # -- set-up --------------------------------------------------------------

    def bind(self, algorithm: Any) -> None:
        from ..models.layers import BatchNorm

        algorithm.strategy = self
        for module in vars(algorithm).values():
            if isinstance(module, nn.Module):
                for m in module.modules():
                    if isinstance(m, BatchNorm):
                        m.group = self.data_group

    def attach(self, algorithm: Any, state: Any) -> None:
        """After ``init_state``: the layouts of the state's sharded tensors
        (the optimizer moments beside their parameters)."""

    def shard_state(self, algorithm: Any, state: Any) -> None:
        """The state as it lives between steps (``Trainer.run`` calls it
        first; FSDP: its shards)."""

    def unshard_state(self, algorithm: Any, state: Any) -> None:
        """The state whole again on every rank (``Trainer.run``'s end)."""

    @contextlib.contextmanager
    def step_scope(self, algorithm: Any, state: Any) -> Iterator[None]:
        """Around one train step (FSDP: the parameters gathered)."""
        yield

    def train_step(self, algorithm: Any, state: Any, batch: Mapping[str, Any]) -> tuple[Any, dict]:
        """One ``algorithm.train_step`` inside :meth:`step_scope`, its
        metrics the global batch's."""
        with self.step_scope(algorithm, state):
            state, metrics = algorithm.train_step(state, batch)
        return state, self.reduce_metrics(metrics)

    @contextlib.contextmanager
    def full_state(self, algorithm: Any, state: Any) -> Iterator[None]:
        """The full parameters and moments in place of their shards while
        inside (a checkpoint's save or restore), sliced again on exit."""
        local = self._local
        if local:
            self._gather(self._entries)
        try:
            yield
        finally:
            if local:
                self._slice(self._entries)

    def _gather(self, entries) -> None:
        for owner, key, layout in entries:
            _set_sharded_tensor(owner, key, layout.full(_sharded_tensor(owner, key).detach()))

    def _slice(self, entries) -> None:
        for owner, key, layout in entries:
            _set_sharded_tensor(owner, key, layout.local(_sharded_tensor(owner, key).detach()).clone())

    def named_layouts(self, module: nn.Module) -> dict[str, Layout]:
        """The layouts of ``module``'s sharded parameters and buffers by
        their state-dict names (``utils.bridge.shard_params`` takes them)."""
        names = {id(m): prefix for prefix, m in module.named_modules()}
        out = {}
        for owner, key, layout in self._entries:
            if not isinstance(owner, list) and id(owner) in names:
                prefix = names[id(owner)]
                out[f"{prefix}.{key}" if prefix else key] = layout
        return out

    # -- a step --------------------------------------------------------------

    def reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor averaged over the data group, in place."""
        all_reduce_mean(list(tensors), self.data_group)

    def apply_gradients(self, tx: Any, params: list[torch.Tensor], grads: list[torch.Tensor],
                        opt_state: dict) -> None:
        """``tx.step`` on the gradients averaged over the data axes (this
        rank's chunk of a sharded parameter's, with its moments'
        shards)."""
        self.reduce_mean(grads)
        sharded = [id(p) in self._layouts for p in tx.trained(params)]
        tx.step(params, grads, opt_state, sharded=sharded if any(sharded) else None,
                group=self.shard_group)

    def reduce_metrics(self, metrics: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A step's scalar metrics as the global batch's: averaged over the
        data group (the JAX package's are global-batch means)."""
        out = dict(metrics)
        keys = [k for k, v in out.items() if isinstance(v, torch.Tensor) and v.dim() == 0
                and v.is_floating_point()]
        if keys and self.data_group is not None:
            stacked = torch.stack([out[k].float() for k in keys])
            self.reduce_mean([stacked])
            out.update({k: v.to(out[k].dtype) for k, v in zip(keys, stacked.unbind())})
        return out

    # -- batches -------------------------------------------------------------

    def host_tensor(self, value: Any) -> torch.Tensor:
        """A host array as a tensor, pinned where the device is CUDA."""
        t = torch.as_tensor(np.asarray(value))
        return t.pin_memory() if self.device.type == "cuda" else t

    def shard_batch(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """This rank's host rows -> tensors on its device. On CUDA the host
        side is pinned first, so the ``non_blocking`` copy is asynchronous
        (a copy from pageable memory is not)."""
        return {k: self.host_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}


@StrategyRegistry.register()
class SingleDeviceStrategy(Strategy):
    """One device, nothing sharded, no collective: a mesh of more than one
    rank raises ``ValueError``."""

    def __init__(self, mesh: Mesh | None = None, device: torch.device | str = "cuda") -> None:
        if mesh is not None and math.prod(mesh.shape.values()) > 1:
            raise ValueError(f"SingleDeviceStrategy on a mesh of {math.prod(mesh.shape.values())} ranks")
        super().__init__(Mesh({"dp": 1} if mesh is None else mesh.shape, groups=False), device)


@StrategyRegistry.register()
class DataParallelStrategy(Strategy):
    """Batch over ``dp`` (and ``fsdp``), parameters replicated, gradients
    averaged."""


@StrategyRegistry.register()
class FSDPStrategy(Strategy):
    """Parameters of at least ``min_size`` elements and their moments as
    shards over ``fsdp`` (``dp`` where the mesh has no ``fsdp`` axis)
    between steps; batch over every data axis."""

    def __init__(self, mesh: Mesh | None = None, device: torch.device | str = "cuda",
                 min_size: int = 2**14) -> None:
        super().__init__(mesh, device)
        self.min_size = min_size
        self.axis = "fsdp" if "fsdp" in self.mesh.shape else "dp"
        self._param_entries: list[tuple[Any, Any, Layout]] = []

    @property
    def shard_group(self):
        return self.mesh.group((self.axis,))

    def attach(self, algorithm: Any, state: Any) -> None:
        """The layouts of the optimizers' modules' parameters
        (:func:`fsdp_param_spec`; frozen ones too, as the JAX package
        shards every leaf) and of the trained ones' moments."""
        n, rank = self.mesh.shape[self.axis], self.mesh.rank((self.axis,))
        self._entries, self._param_entries, self._layouts = [], [], {}
        for tx, module, opt_state in algorithm.optimizer_states(state).values():
            moment = {name: i for i, name in enumerate(tx.trained([name for name, _ in module.named_parameters()]))}
            for name, p in module.named_parameters():
                dim = fsdp_param_spec(tuple(p.shape), n, self.min_size)
                if dim is None or id(p) in self._layouts:
                    continue
                layout = Layout(dim, rank, n, self.shard_group)
                self._layouts[id(p)] = layout
                owner, _, attr = name.rpartition(".")
                entry = (module.get_submodule(owner), attr, layout)
                self._param_entries.append(entry)
                self._entries.append(entry)
                for key in ("mu", "nu", "trace"):
                    if name in moment and opt_state.get(key) is not None:
                        self._entries.append((opt_state[key], moment[name], layout))

    def shard_state(self, algorithm: Any, state: Any) -> None:
        if not self._local:
            self._slice(self._entries)
            self._local = True

    def unshard_state(self, algorithm: Any, state: Any) -> None:
        if self._local:
            self._gather(self._entries)
            self._local = False

    @contextlib.contextmanager
    def step_scope(self, algorithm: Any, state: Any) -> Iterator[None]:
        if not self._local:
            raise RuntimeError("FSDPStrategy: shard_state before a step (Trainer.run does)")
        self._gather(self._param_entries)
        try:
            yield
        finally:
            self._slice(self._param_entries)

    def apply_gradients(self, tx: Any, params: list[torch.Tensor], grads: list[torch.Tensor],
                        opt_state: dict) -> None:
        """Replicated parameters: gradients averaged over the data group.
        Sharded ones (whole inside :meth:`step_scope`): gradients reduce-
        scattered over the shard axis (and averaged over ``dp`` beside
        ``fsdp``); the optimizer moves this rank's chunk of the parameter
        (a view) with the moments' shards, and the chunks are gathered back
        into the whole parameter."""
        trained = tx.trained(params)
        layouts = [self._layouts.get(id(p)) for p in trained]
        rest = self.mesh.group(("dp",)) if self.axis == "fsdp" else None
        self.reduce_mean([g for g, lay in zip(grads, layouts) if lay is None])
        views = {}
        for i, (p, lay) in enumerate(zip(trained, layouts)):
            if lay is not None:
                grads[i] = reduce_scatter_mean(grads[i], lay.group, lay.dim)
                views[id(p)] = lay.local(p.data)
        all_reduce_mean([g for g, lay in zip(grads, layouts) if lay is not None], rest)
        tx.step([views.get(id(p), p) for p in params], grads, opt_state,
                sharded=[lay is not None for lay in layouts], group=self.shard_group)
        with torch.no_grad():
            for p, lay in zip(trained, layouts):
                if lay is not None:
                    p.data = lay.full(views[id(p)])


@StrategyRegistry.register()
class TPStrategy(Strategy):
    """Tensor parallelism for the Llama decoder over ``tp``: q/k/v and
    gate/up column-parallel, o and down row-parallel, the embedding and lm
    head split over the vocabulary where it divides
    (``models/transformers/llama.py``); batch over ``dp``. Gradients are
    averaged over ``dp`` only: a shard's gradient is this rank's already
    (the tensor-parallel products' collectives made it), and a replicated
    parameter's is the same on every ``tp`` rank. The clip's global norm
    sums the shards' squares over ``tp``."""

    def __init__(self, mesh: Mesh | None = None, device: torch.device | str = "cuda",
                 rules: str = "llama") -> None:
        super().__init__(mesh, device)
        if "tp" not in self.mesh.shape:
            raise ValueError(f"TPStrategy needs a 'tp' mesh axis, got {self.mesh.axis_names}")
        if rules != "llama":
            raise ValueError(f"unknown TP rule set {rules!r}")
        self._param_entries: list[tuple[Any, Any, Layout]] = []

    @property
    def tp_group(self):
        return self.mesh.group(("tp",))

    @property
    def shard_group(self):
        return self.tp_group

    def shard_module(self, model: nn.Module) -> None:
        """The Llama's weights replaced by this rank's shards, in place."""
        from ..models.transformers.llama import LlamaTransformer, shard_llama_tp

        if not isinstance(model, LlamaTransformer):
            raise ValueError(f"TPStrategy's 'llama' rules need a LlamaTransformer, got {type(model).__name__}")
        self._param_entries = shard_llama_tp(model, self.tp_group, self.mesh.rank(("tp",)),
                                             self.mesh.shape["tp"])
        self._entries = list(self._param_entries)
        self._layouts = {id(getattr(m, k)): lay for m, k, lay in self._param_entries}
        self._local = True

    def bind(self, algorithm: Any) -> None:
        super().bind(algorithm)
        self.shard_module(algorithm.model)

    def attach(self, algorithm: Any, state: Any) -> None:
        """The moments of the sharded parameters (made from the shards)."""
        self._entries = list(self._param_entries)
        for tx, module, opt_state in algorithm.optimizer_states(state).values():
            for i, p in enumerate(tx.trained(list(module.parameters()))):
                if id(p) in self._layouts:
                    for key in ("mu", "nu", "trace"):
                        if opt_state.get(key) is not None:
                            self._entries.append((opt_state[key], i, self._layouts[id(p)]))
