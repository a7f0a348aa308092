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
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping

__all__ = ["NamedParametersFilter", "mask_tree"]


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
