"""Named-parameter filters (port of ``vector_quantization_tpu/utils/filters.py``).

A filter is a predicate over a parameter's **flax path**, its keys joined
with ``"/"`` (``quantizer/codebook``, ``encoder/teacher/backbone/ln_pre/scale``):
the names the JAX package's configs were written against. The port's
modules name their tensors otherwise (``quantizer.codebook``,
``encoder.teacher.backbone.ln_pre.weight``); :func:`...utils.bridge.flax_param_paths`
gives each of them its flax path, so ``prefixes``, ``suffixes`` and
``regexes`` mean what they mean in JAX.

Config form (anywhere a filter is accepted)::

    dict(names=["encoder/conv_in/kernel"],   # exact paths
         prefixes=["decoder/"],              # path prefixes
         suffixes=["bias"],                  # path suffixes
         contains=["codebook"],              # substrings
         regexes=[r"layer\\d+_res\\d/conv\\d/kernel"])

A bare string is shorthand for ``contains=[s]``; a list of strings for
``contains=list``.

:func:`partition_params` and :func:`filter_state_dict` take a nested tree
(the JAX layout, as a checkpoint's ``params`` holds it) or a module, whose
dotted parameter names are read as their flax paths; both give a flat
``{flax path: leaf}``.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping

from torch import nn

from .bridge import flax_param_paths

__all__ = ["NamedParametersFilter", "filter_state_dict", "mask_tree", "partition_params", "path_str"]


def path_str(path: Iterable[Any]) -> str:
    """A path's keys joined with ``"/"``: each part's ``key``, else its
    ``idx``, else its ``name``, else the part itself (JAX's key-path
    entries, or plain strings and ints)."""
    parts = []
    for p in path:
        key = getattr(p, "key", None)
        if key is None:
            key = getattr(p, "idx", None)
        if key is None:
            key = getattr(p, "name", p)
        parts.append(str(key))
    return "/".join(parts)


class NamedParametersFilter:
    def __init__(
        self,
        names: Iterable[str] = (),
        prefixes: Iterable[str] = (),
        suffixes: Iterable[str] = (),
        contains: Iterable[str] = (),
        regexes: Iterable[str] = (),
    ) -> None:
        self.names = set(names)
        self.prefixes = tuple(prefixes)
        self.suffixes = tuple(suffixes)
        self.contains = tuple(contains)
        self.regexes = [re.compile(r) for r in regexes]
        if not (self.names or self.prefixes or self.suffixes or self.contains or self.regexes):
            raise ValueError("empty parameter filter matches nothing")

    @classmethod
    def build(cls, spec: "NamedParametersFilter | str | Iterable[str] | Mapping[str, Any]"):
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(contains=[spec])
        if isinstance(spec, Mapping):
            return cls(**spec)
        return cls(contains=list(spec))

    def __call__(self, path: str) -> bool:
        if path in self.names:
            return True
        if any(path.startswith(p) for p in self.prefixes):
            return True
        if any(path.endswith(s) for s in self.suffixes):
            return True
        if any(c in path for c in self.contains):
            return True
        return any(r.search(path) for r in self.regexes)


def mask_tree(paths: Iterable[str], filt, value: bool = True) -> list[bool]:
    """Per flax path, in order: ``value`` where the filter matches, ``not
    value`` elsewhere (the JAX function's mask over a params tree, here
    over the list of its leaves' paths)."""
    f = NamedParametersFilter.build(filt)
    return [value if f(p) else not value for p in paths]


def _flat(params: Any, prefix: tuple = ()) -> Iterable[tuple[str, Any]]:
    if isinstance(params, nn.Module):
        paths = flax_param_paths(params)
        for name, p in params.named_parameters():
            yield paths[name], p
    elif isinstance(params, Mapping):
        for k in sorted(params):  # JAX flattens a dict in sorted key order
            yield from _flat(params[k], (*prefix, k))
    else:
        yield path_str(prefix), params


def partition_params(params: Any, filt) -> tuple[dict, dict]:
    """Flat ``{path: leaf}`` split into (matched, rest): the FreezeMixin
    partition (frozen vs trainable)."""
    f = NamedParametersFilter.build(filt)
    matched, rest = {}, {}
    for s, leaf in _flat(params):
        (matched if f(s) else rest)[s] = leaf
    return matched, rest


def filter_state_dict(params: Any, filt) -> dict:
    """Flat ``{path: leaf}`` of just the matching params (reference
    ``filter_state_dict``)."""
    return partition_params(params, filt)[0]
