"""Optimizer and learning-rate schedule builders (port of
``vector_quantization_tpu/training/optim.py``, which builds optax chains).

The same declarative configs::

    optimizer = dict(type="adamw", lr=1e-4, weight_decay=0.05, grad_clip=1.0,
                     schedule=dict(type="cosine", warmup=10_000, total=250_000))

build an :class:`Optimizer` that applies optax's arithmetic to a list of
parameters in place, so a train step of the port and one of the JAX package
move the same weights alike:

- ``grad_clip``: ``clip_by_global_norm`` (no ε: gradients are scaled by
  ``max_norm / ‖g‖`` only when ``‖g‖ >= max_norm``);
- ``adam``/``adamw``: ``scale_by_adam`` with bias correction at the step
  count, ``u = m̂ / (sqrt(v̂) + eps)``; ``adamw`` adds
  ``weight_decay · p`` to ``u`` before the learning rate, so the decay is
  scaled by the schedule's value (0 at the first warm-up step);
- ``sgd``: optax ``trace`` momentum;
- ``lars``: ``optax.lars`` as optax 0.2.6 chains it:
  ``add_decayed_weights(weight_decay, weight_decay_mask)`` ->
  ``masked(scale_by_trust_ratio(trust_coefficient, eps), trust_ratio_mask)``
  -> ``scale_by_learning_rate`` -> ``trace(momentum, nesterov)``. The trust
  ratio is per tensor, ``trust_coefficient · ‖p‖ / (‖u‖ + eps)``, and 1
  where either norm is 0 (a zero-initialised bias's first step is a plain
  ``−lr · g``); the trace accumulates the update after the learning rate
  (``torch.optim.SGD`` applies lr after its trace, which differs once lr
  changes). Defaults: ``weight_decay`` 0, ``trust_coefficient`` 0.001,
  ``eps`` 0, ``momentum`` 0.9, ``nesterov`` False. A mask is True (every
  parameter) or a :class:`...utils.filters.NamedParametersFilter` spec over
  the flax paths, True where it matches;
- the schedule is read at the count of updates already applied (0 first),
  as ``scale_by_learning_rate`` reads it;
- ``exclude``: a :class:`...utils.filters.NamedParametersFilter` spec over
  the parameters' flax paths (``build_optimizer``'s ``paths``). As in the
  JAX package's ``optax.masked`` chain, an excluded parameter gets a zero
  update, no weight decay and no moments, and ``grad_clip``'s global norm
  runs over the kept parameters only.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Sequence

import torch

from ..utils.filters import mask_tree

__all__ = ["Optimizer", "build_optimizer", "build_schedule"]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def sched(count: int) -> float:
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1.0 - alpha) * cos + alpha)

    return sched


def build_schedule(cfg: Mapping[str, Any] | float | None, lr: float) -> Callable[[int], float]:
    """A function of the update count -> learning rate, with optax's
    ``constant``, ``cosine_decay``, ``linear`` and ``join_schedules``
    semantics (warm-up: linear from 0 to ``lr`` over ``warmup`` counts)."""
    if cfg is None:
        return lambda count: lr
    if isinstance(cfg, (int, float)):
        return lambda count: float(cfg)
    kind = cfg.get("type", "constant")
    warmup = int(cfg.get("warmup", 0))
    total = int(cfg.get("total", 0))
    end = float(cfg.get("end", 0.0))
    if kind == "constant":
        sched = lambda count: lr  # noqa: E731
    elif kind == "cosine":
        sched = _cosine(lr, max(total - warmup, 1), end / lr if lr else 0.0)
    elif kind == "linear":
        sched = _linear(lr, end, max(total - warmup, 1))
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    if not warmup:
        return sched
    warm = _linear(0.0, lr, warmup)
    return lambda count: warm(count) if count < warmup else sched(count - warmup)


class Optimizer:
    """An optax-style update applied in place to a list of tensors.

    ``init(params)`` returns the state (moments and the update count);
    ``step(params, grads, state)`` clips, updates the moments and moves the
    parameters, all in place (grads are clipped in place too). Both take
    every parameter; with ``keep`` (one bool per parameter, False where
    ``exclude`` matched) they act on the kept ones only, and ``grads``
    holds one gradient per kept parameter (:meth:`trained`'s order)."""

    def __init__(
        self,
        kind: str,
        schedule: Callable[[int], float],
        grad_clip: float | None = None,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float | None = None,
        weight_decay: float | None = None,
        momentum: float | None = None,
        keep: Sequence[bool] | None = None,
        nesterov: bool = False,
        trust_coefficient: float = 0.001,
        decay_mask: Sequence[bool] | None = None,
        trust_mask: Sequence[bool] | None = None,
    ) -> None:
        if kind not in ("adam", "adamw", "sgd", "lars"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2 = b1, b2
        self.eps = eps if eps is not None else 0.0 if kind == "lars" else 1e-8
        # optax's defaults: adamw decays by 1e-4, lars by 0; adam and sgd have no decay
        if kind not in ("adamw", "lars"):
            weight_decay = 0.0
        elif weight_decay is None:
            weight_decay = 1e-4 if kind == "adamw" else 0.0
        self.weight_decay = weight_decay
        self.momentum = 0.9 if momentum is None and kind == "lars" else momentum
        self.keep = None if keep is None else list(keep)
        self.nesterov, self.trust_coefficient = nesterov, trust_coefficient
        self.decay_mask = None if decay_mask is None else list(decay_mask)
        self.trust_mask = None if trust_mask is None else list(trust_mask)

    def trained(self, items: Sequence[Any]) -> list[Any]:
        """The entries of ``items`` (one per parameter) that are not excluded."""
        if self.keep is None:
            return list(items)
        if len(items) != len(self.keep):
            raise ValueError(f"{len(items)} parameters, the exclude mask has {len(self.keep)}")
        return [item for item, k in zip(items, self.keep) if k]

    def init(self, params: Sequence[torch.Tensor]) -> dict[str, Any]:
        params = self.trained(params)
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.kind in ("sgd", "lars"):
            return {"count": 0, "trace": zeros() if self.momentum else None}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict) -> None:
        params = self.trained(params)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} trained parameters")
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(state["count"])
        state["count"] += 1
        if self.kind == "lars":
            self._lars(params, grads, state, lr)
            return
        if self.kind == "sgd":
            updates = grads
            if self.momentum:
                trace = state["trace"]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                updates = trace
            torch._foreach_add_(params, updates, alpha=-lr)
            return
        count = state["count"]
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1**count)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        updates = torch._foreach_div(mu_hat, nu_hat)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)

    def _lars(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict, lr: float) -> None:
        decay = self.trained(self.decay_mask or [True] * len(self.keep or params))
        trust = self.trained(self.trust_mask or [True] * len(self.keep or params))
        updates = []
        for p, g, d, t in zip(params, grads, decay, trust):
            u = g + self.weight_decay * p if d else g
            if t:
                p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = self.trust_coefficient * p_norm / (u_norm + self.eps)
                u = u * torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)
            updates.append(u * -lr)
        if self.momentum:
            trace = state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, updates)
            updates = torch._foreach_add(updates, trace, alpha=self.momentum) if self.nesterov else trace
        torch._foreach_add_(params, updates)


def build_optimizer(cfg: Mapping[str, Any], paths: Sequence[str] | None = None) -> Optimizer:
    """The optimizer a config names (``type`` adam | adamw | sgd | lars, ``lr``,
    ``schedule``, ``grad_clip``, ``exclude``, ``betas`` or ``b1``/``b2``,
    and the kind's own keywords). ``paths``: the flax path of each
    parameter the optimizer will be given, in order; ``exclude`` and LARS's
    ``weight_decay_mask`` / ``trust_ratio_mask`` need them."""
    cfg = dict(cfg)
    kind = cfg.pop("type", "adam")
    lr = float(cfg.pop("lr", 1e-4))
    schedule = build_schedule(cfg.pop("schedule", None), lr)
    grad_clip = cfg.pop("grad_clip", None)
    exclude = cfg.pop("exclude", None)
    if exclude:
        if paths is None:
            raise ValueError("exclude mask needs the parameters' flax paths")
        cfg["keep"] = mask_tree(paths, exclude, value=False)
    betas = cfg.pop("betas", None)
    if betas is not None:
        cfg["b1"], cfg["b2"] = betas
    for key, arg in (("weight_decay_mask", "decay_mask"), ("trust_ratio_mask", "trust_mask")):
        mask = cfg.pop(key, True)
        if mask is not True:
            if paths is None:
                raise ValueError(f"{key} needs the parameters' flax paths")
            cfg[arg] = mask_tree(paths, mask, value=True)
    return Optimizer(kind, schedule, float(grad_clip) if grad_clip else None, **cfg)
