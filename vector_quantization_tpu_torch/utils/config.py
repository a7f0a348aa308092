"""Layered Python-file config system.

The port's own copy of ``vector_quantization_tpu/utils/config.py`` (the port
imports nothing of the JAX package), so the files under ``configs/`` load
the same way in either package:

- a config is a Python file executed in a sandbox namespace;
- ``_base_ = [path, ...]`` merges parent configs (relative to the file) in
  order, with the child taking precedence;
- ``_kwargs_`` exposes load-time parameters: ``Config.load(path, key=value)``
  makes ``_kwargs_`` a dict the file can read with defaults
  (``k = _kwargs_.get('k', 8192)``);
- ``_export_``: if the file sets it, that dict is the config; otherwise all
  non-underscore module-level names are exported;
- ``_delete_ = True`` inside a nested dict means "replace, don't merge" when
  that dict is merged over a base value.

``override`` patches dotted and indexed paths (``{"a.b[0].c": 1}``), as
the CLI's ``--override`` gives them; ``dumps``/``dump`` write the config as
sorted JSON (``work_dir/config.json``).

Configs are plain nested ``Config`` dicts with attribute access — no schema,
same as the reference.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Iterable, Mapping

__all__ = ["Config", "load_config"]


class Config(dict):
    """Nested dict with attribute access and merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- construction ------------------------------------------------------

    @classmethod
    def from_obj(cls, obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return cls({k: cls.from_obj(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.from_obj(v) for v in obj)
        return obj

    def copy(self) -> "Config":  # type: ignore[override]
        return copy.deepcopy(self)

    # -- merge / override --------------------------------------------------

    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge ``other`` over ``self`` (returns self, mutated)."""
        for k, v in other.items():
            if k == "_delete_":
                continue
            if (
                isinstance(v, Mapping)
                and not v.get("_delete_", False)
                and isinstance(self.get(k), Mapping)
            ):
                child = Config.from_obj(self[k])
                child.merge(v)
                self[k] = child
            else:
                v = Config.from_obj(v)
                if isinstance(v, Config):
                    v.pop("_delete_", None)
                self[k] = v
        return self

    def override(self, options: Mapping[str, Any]) -> "Config":
        """Patch dotted paths: ``{'a.b.c': 1, 'a.list[0]': 2}``."""
        for path, value in options.items():
            self._set_path(path, value)
        return self

    def _set_path(self, path: str, value: Any) -> None:
        parts = _parse_path(path)
        node: Any = self
        for part in parts[:-1]:
            if isinstance(part, int):
                node = node[part]
            else:
                if part not in node or not isinstance(node[part], (dict, list, tuple)):
                    node[part] = Config()
                node = node[part]
        node[parts[-1]] = Config.from_obj(value)

    # -- io ----------------------------------------------------------------

    @classmethod
    def load(cls, path: str, **kwargs: Any) -> "Config":
        return load_config(path, **kwargs)

    def dumps(self) -> str:
        return json.dumps(self, indent=2, default=repr, sort_keys=True)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())


def _parse_path(path: str) -> list[Any]:
    """``'a.b[0].c'`` -> ``['a', 'b', 0, 'c']``."""
    parts: list[Any] = []
    for piece in path.split("."):
        while "[" in piece:
            head, rest = piece.split("[", 1)
            if head:
                parts.append(head)
            idx, piece = rest.split("]", 1)
            parts.append(int(idx))
        if piece:
            parts.append(piece)
    return parts


def _exec_config_file(path: str, kwargs: Mapping[str, Any]) -> dict[str, Any]:
    with open(path) as f:
        source = f.read()
    namespace: dict[str, Any] = {
        "_kwargs_": dict(kwargs),
        "__file__": os.path.abspath(path),
        "Config": Config,
    }
    code = compile(source, path, "exec")
    exec(code, namespace)  # noqa: S102 - configs are trusted project files
    return namespace


def load_config(path: str, **kwargs: Any) -> Config:
    """Load a layered Python config file (see module docstring)."""
    path = os.path.abspath(path)
    ns = _exec_config_file(path, kwargs)

    merged = Config()
    bases: Iterable[Any] = ns.get("_base_", [])
    if isinstance(bases, (str, Mapping)):
        bases = [bases]
    for base in bases:
        if isinstance(base, Mapping):  # already-loaded config (programmatic)
            base_cfg = Config.from_obj(base)
        else:
            base_path = base
            if not os.path.isabs(base_path):
                base_path = os.path.join(os.path.dirname(path), base_path)
            base_cfg = load_config(base_path)
        merged.merge(base_cfg)

    if "_export_" in ns:
        exported = ns["_export_"]
        if not isinstance(exported, Mapping):
            raise TypeError(f"{path}: _export_ must be a mapping")
        own = Config.from_obj(exported)
    else:
        own = Config.from_obj(
            {
                k: v
                for k, v in ns.items()
                if not k.startswith("_")
                and k not in ("Config",)
                and not callable(v)
                and not isinstance(v, type(os))
            }
        )
    merged.merge(own)
    return merged
