"""Seeded weights, made on the device in one draw, for the program and the
reference alike.

A configuration's leaves (name, shape) come from its reference module built
on the meta device; a rule per leaf says how it is drawn (``normal``
with a standard deviation and mean, ``ones``, ``zeros``). All normal
leaves are slices of one ``torch.randn`` on the device from a generator
seeded by the run's seed, so the same seed gives the same weights on
either side, and set-up makes them in one call.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Iterable

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run (weights, traffic, sampling)."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 1


def leaves(module: torch.nn.Module, prefix: str = "") -> list[tuple[str, tuple[int, ...]]]:
    return [(prefix + n, tuple(p.shape)) for n, p in module.named_parameters()]


def make(shapes: Iterable[tuple[str, tuple[int, ...]]], rule: Callable, seed: int, device) -> dict:
    """name -> tensor on ``device``, drawn by ``rule(name, shape)``."""
    shapes = list(shapes)
    plan = [(n, s, rule(n, s)) for n, s in shapes]
    total = sum(math.prod(s) for _, s, r in plan if r[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device) if total else None
    out, off = {}, 0
    for name, shape, r in plan:
        size = math.prod(shape)
        if r[0] == "normal":
            t = flat[off:off + size].view(shape).mul_(r[1])
            if len(r) > 2:
                t.add_(r[2])
            off += size
        elif r[0] == "ones":
            t = torch.ones(shape, device=device)
        elif r[0] == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init rule {r!r} for {name}")
        out[name] = t
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict, prefix: str = "") -> None:
    """Copy ``weights[prefix + name]`` into every parameter of ``module``;
    a parameter without a weight, or a weight of another shape, raises."""
    for name, p in module.named_parameters():
        w = weights.get(prefix + name)
        if w is None or tuple(w.shape) != tuple(p.shape):
            raise KeyError(f"no seeded weight of shape {tuple(p.shape)} for {prefix + name}")
        p.copy_(w)
