"""Flax params -> the port's state dicts.

The JAX package maps torch checkpoints to flax (``utils/converters.py``);
this goes the other way, so the port loads the same weights as the JAX
model it is held against.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["llama_params_from_flax"]


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
    -> a state dict for the port's ``LlamaTransformer`` of the same layout.

    The port keeps flax's names and ``(in, out)`` layouts, so the mapping
    joins the tree's keys with dots and copies each array (f32 stays f32,
    int8 stays int8).
    """
    return {
        name: torch.from_numpy(np.array(value, copy=True))
        for name, value in _flatten(params).items()
    }
