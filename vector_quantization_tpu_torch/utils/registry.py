"""Hierarchical registries: configs name a class by ``type``.

The port's own copy of ``vector_quantization_tpu/utils/registry.py``,
trimmed to registration, lookup, ``build`` and ``build_or_return``. ``build`` takes a plain
mapping: ``type`` names the class, the remaining keys are its keyword
arguments (a config's ``_delete_`` merge marker is dropped). A class may
define a ``build_pre_hook(config, registry)`` classmethod, which ``build``
runs first so the class can build its children and infer their widths.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, TypeVar

from .config import Config

T = TypeVar("T")

__all__ = ["Registry", "RegistryError"]


class RegistryError(KeyError):
    pass


class Registry:
    """A named registry that can hold items and child registries."""

    _roots: dict[str, "Registry"] = {}

    def __init__(self, name: str, parent: "Registry | None" = None) -> None:
        self.name = name
        self.parent = parent
        self._items: dict[str, Any] = {}
        self._children: dict[str, "Registry"] = {}
        if parent is None:
            Registry._roots[name] = self
        else:
            parent._children[name] = self

    def child(self, name: str) -> "Registry":
        if name not in self._children:
            Registry(name, parent=self)
        return self._children[name]

    def qualname(self) -> str:
        parts = []
        node: Registry | None = self
        while node is not None:
            parts.append(node.name)
            node = node.parent
        return ".".join(reversed(parts))

    def register(self, name: str | None = None) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            key = name or getattr(obj, "__name__", None)
            if key is None:
                raise ValueError("cannot infer registry key")
            if key in self._items:
                raise RegistryError(
                    f"{key!r} already registered in {self.qualname()}"
                )
            self._items[key] = obj
            return obj

        return deco

    def get(self, path: str) -> Any:
        """Resolve ``'Name'``, ``'Child.Name'`` or ``'RootName.Child.Name'``."""
        parts = path.split(".")
        node: Registry = self
        if len(parts) > 1 and parts[0] in Registry._roots:
            node = Registry._roots[parts[0]]
            parts = parts[1:]
        for part in parts[:-1]:
            if part not in node._children:
                raise RegistryError(
                    f"no child registry {part!r} under {node.qualname()}"
                )
            node = node._children[part]
        found = node._lookup(parts[-1])
        if found is None:
            raise RegistryError(
                f"{parts[-1]!r} not found under {node.qualname()} "
                f"(known: {sorted(node.keys())})"
            )
        return found

    def _lookup(self, key: str) -> Any:
        if key in self._items:
            return self._items[key]
        for ch in self._children.values():
            found = ch._lookup(key)
            if found is not None:
                return found
        return None

    def keys(self) -> list[str]:
        out = list(self._items)
        for ch in self._children.values():
            out.extend(ch.keys())
        return out

    def build(self, config: Mapping[str, Any] | None, **extra: Any) -> Any:
        """Instantiate ``config['type']`` with the remaining keys (and
        ``extra``, deep-merged over them) as keyword arguments, after the
        class's ``build_pre_hook`` if it has one."""
        if config is None:
            raise ValueError(f"{self.qualname()}.build(None)")
        cfg = Config.from_obj(dict(config))
        cfg.merge(extra)
        cfg.pop("_delete_", None)
        type_path = cfg.pop("type", None)
        if type_path is None:
            raise ValueError(
                f"{self.qualname()}.build: config missing 'type': {cfg}"
            )
        cls = self.get(type_path) if isinstance(type_path, str) else type_path
        pre_hook = getattr(cls, "build_pre_hook", None)
        if pre_hook is not None:
            cfg = pre_hook(cfg, self)
        return cls(**cfg)

    def build_or_return(self, obj: Any, **extra: Any) -> Any:
        """``build`` for a config with a ``type``; anything else as it is."""
        if isinstance(obj, Mapping) and "type" in obj:
            return self.build(obj, **extra)
        return obj
