"""Checkpoints (port of ``vector_quantization_tpu/training/checkpoints.py``)
as torch files, with the JAX package's layout and its three load modes:

- ``work_dir/checkpoints/iter_N/`` holds ``state.pt``, a dict with the JAX
  ``TrainState``'s fields: ``params``, ``opt_state``, ``d_opt_state``,
  ``step``, ``rng`` and ``extra``. ``params`` is the JAX parameter tree (the
  algorithm's ``param_tree``: nested by flax path, VQGAN's split into
  ``generator`` and ``discriminator``) with the port's tensors, in the port's
  layouts, as leaves; the optimizer moments are trees of the trained
  parameters' paths; ``extra``'s module-owned entries (``ema_params``,
  ``lpips_params``, ``d_batch_stats``, ``teacher_params``, ``ir_params``) are
  trees of their module's paths; ``rng`` is the generator's
  ``get_state()``.
- ``--load-model-from A [B ...]`` (:func:`load_model_from`): weights only,
  each file's ``params`` merged over the template in order, strict=False:
  keys the template lacks are ignored with the JAX package's message.
- ``--load-from iter_N`` (:func:`restore_checkpoint`): everything, written
  with ``copy_`` into the live tensors (the modules own several of them,
  so rebinding would leave them stale), strictly: every key must match.
- ``--auto-resume``: :func:`latest_checkpoint` of the work dir.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import torch

from ..utils.bridge import flax_param_paths, flax_tree

__all__ = ["checkpoint_file", "checkpoint_path", "latest_checkpoint", "list_checkpoints", "load_model_from",
           "merge_params", "restore_checkpoint", "save_checkpoint", "state_tree"]

_FILE = "state.pt"


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "checkpoints")


def checkpoint_file(path: str) -> str:
    """The file a checkpoint directory holds once its save is complete."""
    return os.path.join(os.path.abspath(path), _FILE)


def checkpoint_path(work_dir: str, step: int) -> str:
    return os.path.join(_ckpt_dir(work_dir), f"iter_{step}")


def list_checkpoints(work_dir: str) -> list[str]:
    d = _ckpt_dir(work_dir)
    if not os.path.isdir(d):
        return []
    entries = []
    for name in os.listdir(d):
        m = re.fullmatch(r"iter_(\d+)", name)
        if m and os.path.exists(checkpoint_file(os.path.join(d, name))):
            entries.append((int(m.group(1)), os.path.join(d, name)))
    return [p for _, p in sorted(entries)]


def latest_checkpoint(work_dir: str) -> str | None:
    ckpts = list_checkpoints(work_dir)
    return ckpts[-1] if ckpts else None


def _nest(flat: Mapping[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _opt_tree(tx, module, opt_state: Mapping[str, Any]) -> dict[str, Any]:
    """The optimizer's state with each moment list as a tree of the trained
    parameters' flax paths (the ``exclude`` mask's order)."""
    paths = flax_param_paths(module)
    names = tx.trained([name for name, _ in module.named_parameters()])
    out: dict[str, Any] = {"count": opt_state["count"]}
    for key in ("mu", "nu", "trace"):
        if opt_state.get(key) is not None:
            out[key] = _nest({paths[n]: t for n, t in zip(names, opt_state[key], strict=True)})
    return out


def state_tree(algorithm: Any, state: Any) -> dict[str, Any]:
    """The state in the JAX ``TrainState``'s layout, the live tensors as
    leaves (host ints and bools as they are)."""
    modules = algorithm.extra_modules()
    extra = {}
    for key, value in state.extra.items():
        if key in modules:
            module, stats = modules[key]
            value = flax_tree(module, value, stats)
        extra[key] = value
    tree = {"params": algorithm.param_tree(state), "opt_state": None, "d_opt_state": None,
            "step": state.step, "rng": state.rng.get_state(), "extra": extra}
    for field, (tx, module, opt_state) in algorithm.optimizer_states(state).items():
        tree[field] = _opt_tree(tx, module, opt_state)
    return tree


def _to_host(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(work_dir: str, algorithm: Any, state: Any, step: int) -> str:
    """Write ``iter_<step>/state.pt`` (through a temporary file, so a cut
    save leaves no checkpoint that ``latest_checkpoint`` would pick)."""
    path = checkpoint_path(work_dir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_to_host(state_tree(algorithm, state)), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def _load(path: str) -> dict[str, Any]:
    return torch.load(checkpoint_file(path), map_location="cpu", weights_only=True)


@torch.no_grad()
def _copy_into(live: Any, saved: Any, where: str) -> None:
    """``saved``'s tensors into ``live``'s, in place; the trees must match."""
    if isinstance(live, Mapping):
        if not isinstance(saved, Mapping) or set(live) != set(saved):
            got = sorted(saved) if isinstance(saved, Mapping) else type(saved).__name__
            raise KeyError(f"{where}: the checkpoint holds {got}, the state {sorted(live)}")
        for k in live:
            _copy_into(live[k], saved[k], f"{where}/{k}")
    elif isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape:
            raise ValueError(f"{where}: the checkpoint's {getattr(saved, 'shape', saved)} for the "
                             f"state's {tuple(live.shape)}")
        live.copy_(saved)
    else:
        raise TypeError(f"{where}: {type(live).__name__} is not a tensor tree")


def restore_checkpoint(path: str, algorithm: Any, state: Any) -> Any:
    """Full resume into ``state``, in place (and returned)."""
    saved = _load(path)
    live = state_tree(algorithm, state)
    _copy_into(live["params"], saved["params"], "params")
    for field, (_, _, opt_state) in algorithm.optimizer_states(state).items():
        moments = {k: v for k, v in live[field].items() if k != "count"}
        _copy_into(moments, {k: v for k, v in saved[field].items() if k != "count"}, field)
        opt_state["count"] = int(saved[field]["count"])
    if set(live["extra"]) != set(saved["extra"]):
        raise KeyError(f"extra: the checkpoint holds {sorted(saved['extra'])}, the state "
                       f"{sorted(live['extra'])}")
    for key, value in live["extra"].items():
        if isinstance(value, (Mapping, torch.Tensor)):
            _copy_into(value, saved["extra"][key], f"extra/{key}")
        else:
            state.extra[key] = saved["extra"][key]
    state.step = int(saved["step"])
    state.rng.set_state(saved["rng"])
    return state


@torch.no_grad()
def _merge(dst: Any, src: Any, where: str = "") -> None:
    """strict=False merge of ``src`` over ``dst``, in place: matching leaves
    are copied, keys ``dst`` lacks are ignored (the JAX package's message)."""
    if not isinstance(dst, Mapping) or not isinstance(src, Mapping):
        raise ValueError(f"{where or '/'}: a tree and a leaf meet")
    for k, v in src.items():
        if k not in dst:
            print(f"[load_model_from] ignoring unknown key {k!r}")
        elif isinstance(dst[k], Mapping):
            _merge(dst[k], v, f"{where}/{k}")
        else:
            if not isinstance(v, torch.Tensor) or v.shape != dst[k].shape:
                raise ValueError(f"{where}/{k}: the checkpoint's {getattr(v, 'shape', v)} for "
                                 f"{tuple(dst[k].shape)}")
            dst[k].copy_(v)


def merge_params(params: dict[str, Any], src: Mapping[str, Any]) -> dict[str, Any]:
    """Public strict=False graft: ``src``'s leaves copied over ``params``, a
    tree of live tensors, in place (and returned). Keys ``params`` lacks are
    ignored with the JAX package's message; a leaf of another shape raises.
    Under FSDP or TP call it inside the strategy's ``full_state``, as the
    runner's ``load_model_from`` does: the full tensors take the merge and
    each rank keeps its shard of them on exit (the JAX function re-places
    the merged tree on the template's shardings)."""
    _merge(params, src)
    return params


def load_model_from(paths: str | list[str], params: dict[str, Any]) -> dict[str, Any]:
    """Weights only: each checkpoint's ``params`` (or the whole file where it
    has none) merged over ``params``, a tree of live tensors, in order."""
    for path in [paths] if isinstance(paths, str) else paths:
        restored = _load(path)
        merge_params(params, restored.get("params", restored))
    return params
