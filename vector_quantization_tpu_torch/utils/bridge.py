"""Flax params -> the port's state dicts, and back.

The JAX package maps torch checkpoints to flax (``utils/converters.py``);
this goes the other way, so the port loads the same weights as the JAX
model it is held against: the tokenizers (VQGAN, FSQ, the ViTs of VQ-KD,
the ViT and ConvNeXt teachers), the discriminators (PatchGAN's
``params`` and ``batch_stats``, StyleGAN2's equalised-lr kernels kept in
flax's layouts) and LPIPS through :func:`state_dict_from_flax`, Llama and
GPT-2 through :func:`llama_params_from_flax`, the Inception network and
the linear probe's head through :func:`state_dict_from_flax`, and a VQ-KD,
Cluster, CVQ-VAE or probe state's ``extra`` through :func:`extra_from_flax`. :func:`params_to_flax`,
:func:`batch_stats_to_flax` and :func:`extra_to_flax` read the port's
tensors back in flax's layout, for holding updated weights, optimizer
moments, EMA shadows and codebook statistics against the JAX package's.
:func:`flax_param_paths` names each parameter by its flax path, which the
optimizer's ``exclude`` filter matches; :func:`flax_tree` nests a module's
own tensors by those paths, the layout of the port's checkpoints.
:func:`shard_params` cuts full weights (a state dict, e.g. from
:func:`llama_params_from_flax`) into one rank's shards by a strategy's
``named_layouts``, the weights a TP or FSDP rank holds.

``nn.BatchNorm2d`` (the Inception network's, with pytorch-fid's names)
maps its ``weight``/``bias`` to flax's ``scale``/``bias`` and its running
``mean``/``var`` to ``batch_stats``; its ``num_batches_tracked`` has no
flax leaf and is left to ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from ..models.autoencoders.vqgan import _VQGANBackbone
from ..models.connectors import ConvConnector
from ..models.layers import AttnBlock, Downsample, ResBlock, Upsample

__all__ = [
    "shard_params",
    "batch_stats_to_flax",
    "extra_from_flax",
    "extra_to_flax",
    "flax_param_paths",
    "flax_param_shapes",
    "flax_tree",
    "params_to_flax",
    "llama_params_from_flax",
    "llama_params_to_flax",
    "load_ar_from_flax",
    "state_dict_from_flax",
]

# the port's child name -> flax's, where flax named the child itself
# (``GroupNorm32_0``, ``Conv_0``); every other child keeps its flax name
_FLAX_CHILD = {
    ResBlock: {"norm1": "GroupNorm32_0", "norm2": "GroupNorm32_1"},
    AttnBlock: {"norm": "GroupNorm32_0"},
    Downsample: {"conv": "Conv_0"},
    Upsample: {"conv": "Conv_0"},
    ConvConnector: {"conv": "Conv_0"},
    _VQGANBackbone: {"norm_out": "GroupNorm32_0"},
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def llama_params_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Nested flax ``LlamaTransformer`` params (numpy arrays; float, INT8
    from ``quantize_params_int8`` and/or fused from ``fuse_llama_params``)
    or ``GPT2Transformer`` params -> a state dict for the port's module of
    the same layout.

    The port keeps flax's names and ``(in, out)`` layouts, so the mapping
    joins the tree's keys with dots and copies each array (f32 stays f32,
    int8 stays int8).
    """
    return {
        name: torch.from_numpy(np.array(value, copy=True))
        for name, value in _flatten(params).items()
    }


def llama_params_to_flax(module: nn.Module) -> dict[str, Any]:
    """The reverse of :func:`llama_params_from_flax`: the port's
    ``LlamaTransformer`` -> nested flax-layout numpy params (f32 stays
    f32), for holding updated weights against the JAX package's."""
    tree: dict[str, Any] = {}
    for name, value in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return tree


def load_ar_from_flax(
    algorithm: Any, params: Mapping[str, Any], ir_params: Mapping[str, Any] | None = None
) -> None:
    """Carry a JAX ``ARAlgorithm``'s weights into the port's: the
    transformer's flax ``params`` and, if given, the tokenizer's
    (``state.extra["ir_params"]``), copied into ``algorithm.model`` and
    ``algorithm.ir_model`` in place."""
    algorithm.model.load_state_dict(llama_params_from_flax(params))
    if ir_params is not None:
        ir = algorithm.ir_model
        ir.load_state_dict(state_dict_from_flax(ir, ir_params))


def _flax_leaves(module: nn.Module) -> Iterator[tuple[str, tuple[str, ...], str]]:
    """(port tensor name, flax leaf path, layout) for every parameter and
    persistent buffer of ``module``: layout ``conv`` (flax HWIO, port
    OIHW), ``dense`` (flax (in, out), port (out, in)), ``same``, or
    ``stats`` (a buffer: a leaf of flax's ``batch_stats``, e.g. BatchNorm's
    ``mean`` and ``var``). Modules that keep flax's own layouts (the
    attention's ``qkv_kernel``, the teacher's ``query``/``key``/``value``/
    ``out`` kernels and biases) are ``same``."""

    def visit(mod: nn.Module, path: tuple[str, ...], prefix: str):
        if isinstance(mod, nn.GroupNorm):
            yield prefix + "weight", path + ("GroupNorm_0", "scale"), "same"
            yield prefix + "bias", path + ("GroupNorm_0", "bias"), "same"
            return
        if isinstance(mod, nn.LayerNorm):
            yield prefix + "weight", path + ("scale",), "same"
            yield prefix + "bias", path + ("bias",), "same"
            return
        if isinstance(mod, nn.BatchNorm2d):  # Inception's; num_batches_tracked has no flax leaf
            yield prefix + "weight", path + ("scale",), "same"
            yield prefix + "bias", path + ("bias",), "same"
            yield prefix + "running_mean", path + ("mean",), "stats"
            yield prefix + "running_var", path + ("var",), "stats"
            return
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            yield prefix + "weight", path + ("kernel",), "conv" if isinstance(mod, nn.Conv2d) else "dense"
            if mod.bias is not None:
                yield prefix + "bias", path + ("bias",), "same"
            return
        for name, _ in mod.named_parameters(recurse=False):
            yield prefix + name, path + (name,), "same"
        for name, _ in mod.named_buffers(recurse=False):
            if name not in mod._non_persistent_buffers_set:
                yield prefix + name, path + (name,), "stats"
        renames = _FLAX_CHILD.get(type(mod), {})
        for name, child in mod.named_children():
            yield from visit(child, path + (renames.get(name, name),), f"{prefix}{name}.")

    return visit(module, (), "")


_TO_PORT = {"conv": (3, 2, 0, 1), "dense": (1, 0)}  # axes of np.transpose
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


def state_dict_from_flax(
    module: nn.Module, params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """The flax params (the ``params`` collection, numpy or JAX arrays; and
    the ``batch_stats`` collection where the module has running statistics)
    of a tokenizer model or any of its parts, a discriminator or LPIPS -> a
    state dict for ``module``, the port's module of the same configuration.

    Walks the port's module tree beside flax's names (auto-generated ones
    included: ``GroupNorm32_0/GroupNorm_0`` in each block, the ``Conv_0`` of
    ``Downsample``/``Upsample``): a conv kernel goes HWIO -> OIHW, a Dense
    kernel (in, out) -> Linear (out, in), GroupNorm ``scale``/``bias`` ->
    ``weight``/``bias``, and a module's own parameters (the codebook) are
    copied as they are. Raises on a flax leaf it did not consume, on a
    parameter of ``module`` it did not fill, and on a shape mismatch.
    """
    want = module.state_dict()
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for name, path, layout in _flax_leaves(module):
        node: Any = batch_stats if layout == "stats" else params
        for part in path:
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(f"flax {'batch_stats' if layout == 'stats' else 'params'} have no {'/'.join(path)}")
            node = node[part]
        used.add(("batch_stats." if layout == "stats" else "") + ".".join(path))
        value = np.array(node, dtype=np.float32)
        if layout in _TO_PORT:
            value = value.transpose(_TO_PORT[layout])
        if tuple(want[name].shape) != value.shape:
            raise ValueError(f"{name}: flax gives {value.shape}, the port has {tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    unused = (set(_flatten(params)) | {f"batch_stats.{k}" for k in _flatten(batch_stats or {})}) - used
    if unused:
        raise ValueError(f"flax leaves not consumed: {sorted(unused)}")
    unfilled = {k for k in want.keys() - out.keys() if not k.endswith("num_batches_tracked")}
    if unfilled:
        raise ValueError(f"port parameters not filled: {sorted(unfilled)}")
    return out


def _to_flax_tree(module: nn.Module, tensors: Mapping[str, Any], stats: bool, leaf) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for name, path, layout in _flax_leaves(module):
        if (layout == "stats") != stats:
            continue
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf(tensors[name], layout)
    return tree


def flax_param_shapes(module: nn.Module) -> dict[str, Any]:
    """The nested flax params tree (leaf: shape tuple) that
    :func:`state_dict_from_flax` takes for ``module``: for making weights
    in the flax layout without JAX."""
    return _to_flax_tree(
        module, dict(module.named_parameters()), False,
        lambda p, layout: tuple(p.shape[a] for a in _TO_FLAX[layout]) if layout in _TO_FLAX
        else tuple(p.shape),
    )


def _numpy_leaf(t: torch.Tensor, layout: str) -> np.ndarray:
    value = t.detach().cpu().numpy().copy()
    return value.transpose(_TO_FLAX[layout]) if layout in _TO_FLAX else value


def params_to_flax(module: nn.Module, tensors: Mapping[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """The reverse of :func:`state_dict_from_flax` for the parameters:
    ``tensors`` (by the module's parameter names, in its layouts; default
    the module's own parameters, else e.g. an EMA shadow or an optimizer's
    moments) -> the nested flax ``params`` tree of numpy arrays."""
    return _to_flax_tree(module, dict(module.named_parameters()) if tensors is None else tensors,
                         False, _numpy_leaf)


def batch_stats_to_flax(module: nn.Module,
                        tensors: Mapping[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """The running statistics (by the module's buffer names; default the
    module's own buffers) -> flax's ``batch_stats`` tree."""
    return _to_flax_tree(module, dict(module.named_buffers()) if tensors is None else tensors,
                         True, _numpy_leaf)


def flax_tree(module: nn.Module, tensors: Mapping[str, torch.Tensor] | None = None,
              stats: bool = False) -> dict[str, Any]:
    """``module``'s parameters (with ``stats``: its persistent buffers), or
    ``tensors`` under the same names, nested by their flax paths: the JAX
    package's ``params`` (``batch_stats``) tree with the port's own tensors,
    in the port's layouts, as leaves (no copies)."""
    if tensors is None:
        tensors = dict(module.named_buffers() if stats else module.named_parameters())
    return _to_flax_tree(module, tensors, stats, lambda t, layout: t)


def flax_param_paths(module: nn.Module) -> dict[str, str]:
    """Each parameter's name -> its flax path, keys joined by ``"/"``
    (``quantizer.codebook`` -> ``quantizer/codebook``)."""
    return {name: "/".join(path) for name, path, layout in _flax_leaves(module) if layout != "stats"}


def extra_from_flax(algorithm: Any, state: Any, extra: Mapping[str, Any]) -> None:
    """A JAX VQ-KD / Cluster / CVQ-VAE / linear-probe state's ``extra`` into
    the port's, in place: ``teacher_params`` into the algorithm's teacher,
    ``ir_params`` into its tokenizer, the probe's ``bn_stats`` into the
    head's running statistics, CVQ's ``probability`` and ``anchor_cache``,
    and ``initialized`` as a host bool."""
    if "teacher_params" in extra:
        algorithm.teacher.load_state_dict(state_dict_from_flax(algorithm.teacher, extra["teacher_params"]))
    if "ir_params" in extra:
        algorithm.ir_model.load_state_dict(state_dict_from_flax(algorithm.ir_model, extra["ir_params"]))
    if "bn_stats" in extra:
        live = flax_tree(state.model, stats=True)
        for path, value in _flatten(extra["bn_stats"]).items():
            node = live
            for part in path.split("."):
                node = node[part]
            node.copy_(torch.from_numpy(np.array(value, np.float32)))
    for key in ("probability", "anchor_cache"):
        if key in extra:
            state.extra[key].copy_(torch.from_numpy(np.array(extra[key], np.float32)))
    if "initialized" in extra:
        state.extra["initialized"] = bool(np.asarray(extra["initialized"]))


def extra_to_flax(algorithm: Any, state: Any) -> dict[str, Any]:
    """The reverse of :func:`extra_from_flax`: the keys of the port's
    ``extra`` that it carries, as numpy in the JAX state's layout."""
    out: dict[str, Any] = {}
    if "teacher_params" in state.extra:
        out["teacher_params"] = params_to_flax(algorithm.teacher, state.extra["teacher_params"])
    if "ir_params" in state.extra:
        out["ir_params"] = params_to_flax(algorithm.ir_model, state.extra["ir_params"])
    if "bn_stats" in state.extra:
        out["bn_stats"] = batch_stats_to_flax(state.model, state.extra["bn_stats"])
    for key in ("probability", "anchor_cache"):
        if key in state.extra:
            out[key] = state.extra[key].detach().cpu().numpy().copy()
    if "initialized" in state.extra:
        out["initialized"] = np.asarray(state.extra["initialized"], np.bool_)
    return out


def shard_params(params: Mapping[str, Any], layouts: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Full weights by name (numpy arrays or tensors) -> one rank's: each
    name in ``layouts`` (a ``parallel.collectives.Layout``, as a strategy's
    ``named_layouts`` gives them) cut to that rank's shard, the rest whole.
    No collective: ``Layout.local`` only slices."""
    out = {}
    for name, value in params.items():
        t = torch.as_tensor(np.asarray(value)) if not isinstance(value, torch.Tensor) else value
        out[name] = layouts[name].local(t).clone() if name in layouts else t
    return out
