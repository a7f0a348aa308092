"""Algorithm layer (port of ``vector_quantization_tpu/algorithms/base.py``):
the ``Algorithm`` base with its EMA shadow, ``ReconstructionAlgorithm``
(the autoencoder's recon + quantizer losses, the lazy k-means init of the
codebook and the codebook update after the gradient step) and
``apply_codebook_update``.

An algorithm owns the trained model and the optimizer config and exposes
``init_state``, ``train_step`` and ``eval_step``. Where the JAX package's
steps are pure functions that return a new state, the port's update the
state's parameters, optimizer moments and ``extra`` in place and return
it. A step's gradients go through :meth:`Algorithm.apply_gradients`, the
strategy's seam (``parallel/sharding.py``: averaged over the data axes,
sharded parameters stepped on their shards); the codebook's statistics,
the lazy k-means init and CVQ's anchors run over the global batch with
the strategy's data group, as the JAX package's global arrays do. Algorithms built from a config run on CUDA unless built with
``device="cpu"`` (``AlgorithmRegistry.build(cfg, device="cpu")``).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch
from torch import nn

from ..models.losses.lpips import LPIPS, lpips_state_dict
from ..models.losses.recon import cosine_loss, l1_loss, mse_loss
from ..ops import codebook as cb_ops
from ..ops.distances import normalize, pairwise_distance
from ..parallel.collectives import all_gather_cat, broadcast_
from ..registries import AlgorithmRegistry, ModelRegistry
from ..tasks.image_tokenization import model_device
from ..training.optim import Optimizer, build_optimizer
from ..training.state import TrainState
from ..utils.bridge import flax_param_paths, flax_tree
from ..utils.flags import Store

__all__ = ["Algorithm", "ReconstructionAlgorithm", "apply_codebook_update"]

RECON_LOSSES = {"l1": l1_loss, "mse": mse_loss, "cosine": cosine_loss}


@torch.no_grad()
def apply_codebook_update(
    cfg: Mapping[str, Any],
    codebook: torch.Tensor,
    x: torch.Tensor | None = None,
    codes: torch.Tensor | None = None,
    extra: dict[str, Any] | None = None,
    generator: torch.Generator | None = None,
    group=None,
) -> None:
    """The configured non-gradient codebook update, applied to the
    ``codebook`` parameter (and ``extra``) in place, from the step's
    quantizer features ``x`` (its ``aux["x"]``) and ``codes``, this rank's
    rows of the global batch where ``group`` is the data group:

    - ``{"type": "normalize"}``: the spherical re-projection
      ``e · rsqrt(Σ e² + 1e-12)`` of every row;
    - ``{"type": "kmeans", "decay": 0.99}``: VQ-KD's EMA k-means
      (:func:`...ops.codebook.kmeans_update`);
    - ``{"type": "cvq", "ema_decay": 0.99, "anchor": "nearest"}``: CVQ's
      anchor re-initialisation, with the squared l2 distances of ``x`` to
      the codebook as it stands (after the gradient step); moves
      ``extra["probability"]``. The anchors ``multinomial`` and ``random``
      draw from ``generator`` (the state's); ``cached`` also reads
      ``extra["anchor_cache"]`` and leaves this step's anchors there.
      Over a group the features and distances are all-gathered first (the
      JAX package's arrays are global there whatever ``sync`` says), so
      every rank draws the same anchors.
    """
    kind = cfg["type"]
    if kind == "normalize":
        codebook.copy_(normalize(codebook).to(codebook.dtype))
    elif kind == "kmeans":
        codebook.copy_(cb_ops.kmeans_update(
            codebook, x, codes, decay=cfg.get("decay", 0.99),
            normalize_input=cfg.get("normalize_input", True), renormalize=cfg.get("renormalize", True),
            group=group))
    elif kind == "cvq":
        x = all_gather_cat(x.reshape(-1, x.shape[-1]), group)
        d = pairwise_distance(x, codebook, "l2")
        anchor = cfg.get("anchor", "nearest")
        anchors = cb_ops.cvq_anchors(x, d, anchor, generator, extra.get("anchor_cache"))
        new, p = cb_ops.cvq_update(codebook, extra["probability"], x, d, codes,
                                   ema_decay=cfg.get("ema_decay", 0.99), eps=cfg.get("eps", 1e-3),
                                   anchors=anchors, group=group)
        codebook.copy_(new)
        extra["probability"] = p
        if anchor == "cached":
            extra["anchor_cache"] = anchors.float()
    else:
        raise ValueError(f"unknown codebook update {kind!r}")


class Algorithm:
    """Base: owns model + optimizer (+ an EMA shadow of the model's
    parameters when ``ema_decay`` is set); subclasses define the loss.
    ``strategy`` is the runner's (``Strategy.bind`` sets it; None: one
    device, nothing reduced)."""

    strategy = None

    def __init__(
        self,
        *,
        model: nn.Module,
        optimizer: Mapping[str, Any] | None = None,
        ema_decay: float | None = None,
    ) -> None:
        self.model = model
        self.optimizer_cfg = dict(optimizer or {"type": "adam", "lr": 1e-4})
        self._tx: Optimizer | None = None
        self.ema_decay = ema_decay

    def maybe_init_ema(self, extra: dict[str, Any], model: nn.Module) -> dict[str, Any]:
        """``extra["ema_params"]``: a copy of ``model``'s parameters by name."""
        if self.ema_decay is not None:
            extra["ema_params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        return extra

    @torch.no_grad()
    def maybe_update_ema(self, extra: dict[str, Any], model: nn.Module) -> dict[str, Any]:
        """``e = d·e + (1 − d)·p`` for every parameter, in place."""
        if self.ema_decay is not None:
            d = self.ema_decay
            ema = extra["ema_params"]
            for name, p in model.named_parameters():
                e = ema[name]
                e.copy_(d * e + (1.0 - d) * p)
        return extra

    def tx(self) -> Optimizer:
        """The optimizer, built on first use with the parameters' flax paths
        (``build_optimizer`` reads them where the config filters over them).
        Where the config ``exclude``s parameters, they are also frozen
        (``requires_grad`` off), so a step takes no gradient for them."""
        if self._tx is None:
            flax = flax_param_paths(self.model)
            self._tx = build_optimizer(self.optimizer_cfg, [flax[name] for name, _ in self.model.named_parameters()])
            for p, keep in zip(self.model.parameters(), self._tx.keep or ()):
                if not keep:
                    p.requires_grad_(False)
        return self._tx

    @property
    def data_group(self):
        """The strategy's data group (None: one process)."""
        return None if self.strategy is None else self.strategy.data_group

    def apply_gradients(self, tx: Optimizer, params: list[torch.Tensor], grads: list[torch.Tensor],
                        opt_state: dict) -> None:
        """``tx.step`` through the strategy (gradients of this rank's rows
        -> the global batch's)."""
        if self.strategy is None:
            tx.step(params, grads, opt_state)
        else:
            self.strategy.apply_gradients(tx, params, grads, opt_state)

    def init_state(self, seed: int = 0) -> TrainState:
        """Step 0: the model's current weights, fresh optimizer moments, and
        a generator seeded with ``seed`` on the model's device."""
        params = list(self.model.parameters())
        device = params[0].device
        return TrainState(
            step=0,
            model=self.model,
            opt_state=self.tx().init(params),
            rng=torch.Generator(device=device).manual_seed(seed),
        )

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        raise NotImplementedError

    def eval_step(self, state: TrainState, batch) -> dict:
        raise NotImplementedError

    # -- the JAX state's layout (checkpoints) --------------------------------

    def param_tree(self, state: TrainState) -> dict[str, Any]:
        """The JAX state's ``params``: the trained model's parameters nested
        by their flax paths (the live tensors)."""
        return flax_tree(state.model)

    def optimizer_states(self, state: TrainState) -> dict[str, tuple[Optimizer, nn.Module, dict]]:
        """The JAX state's optimizer fields -> (optimizer, the module it
        moves, its state)."""
        return {"opt_state": (self.tx(), state.model, state.opt_state)}

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        """The ``extra`` entries that hold a module's tensors by name ->
        (the module, whether they are its buffers)."""
        return {"ema_params": (self.model, False)}


@AlgorithmRegistry.register()
class ReconstructionAlgorithm(Algorithm):
    """Autoencoder training: recon losses + quantizer loss (+ the codebook
    update). ``model`` is a config (built on ``device``) or a module."""

    codebook_name = "quantizer.codebook"
    codebook_path = ("quantizer", "codebook")  # in param_tree (SyncCheckCallback)

    def __init__(
        self,
        *,
        model: Mapping[str, Any] | nn.Module,
        recon_losses: Mapping[str, Mapping[str, Any]] | None = None,
        codebook_update: Mapping[str, Any] | None = None,
        lazy_kmeans_init: Mapping[str, Any] | None = None,
        device: torch.device | str | None = None,
        **kwargs: Any,
    ) -> None:
        if codebook_update and codebook_update["type"] == "cvq" and \
                codebook_update.get("anchor", "nearest") not in cb_ops.ANCHORS:
            raise ValueError(f"unknown CVQ anchor {codebook_update['anchor']!r}")
        self.device = model_device(device)
        if not isinstance(model, nn.Module):
            model = ModelRegistry.build(model, device=self.device)
        super().__init__(model=model.to(self.device), **kwargs)
        self.recon_losses = dict(recon_losses or {"l1": {}, "mse": {}})
        self.codebook_update = dict(codebook_update) if codebook_update else None
        self.lazy_kmeans_init = dict(lazy_kmeans_init) if lazy_kmeans_init is not None else None
        self.lpips_module = self._build_lpips() if "lpips" in self.recon_losses else None

    def _build_lpips(self) -> LPIPS:
        """LPIPS with the pretrained VGG16 + lin weights from
        ``$PRETRAINED/lpips`` where that directory exists (torchvision's and
        LPIPS's torch files, :func:`...models.losses.lpips.lpips_state_dict`),
        else at its random init (smoke runs), on the algorithm's device."""
        module = LPIPS()
        pretrained = os.path.join(Store.PRETRAINED, "lpips")
        if os.path.isdir(pretrained):
            module.load_state_dict(lpips_state_dict(pretrained))
        return module.to(self.device)

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        out = super().extra_modules()
        if self.lpips_module is not None:
            out["lpips_params"] = (self.lpips_module, False)
        return out

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _init_lpips(self, extra: dict[str, Any]) -> dict[str, Any]:
        """``extra["lpips_params"]``: the frozen LPIPS weights by name (the
        module's own: pretrained or random, see :meth:`_build_lpips`)."""
        if self.lpips_module is not None:
            extra["lpips_params"] = dict(self.lpips_module.named_parameters())
        return extra

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.extra = self.maybe_init_ema(self._init_lpips(self.init_extra()), state.model)
        return state

    def init_extra(self) -> dict[str, Any]:
        """The codebook update's state: CVQ's usage ``probability`` (K,)
        and, with ``anchor="cached"``, the ``anchor_cache`` (K, D) f32,
        seeded uniform in [0, 1) (the reference's noise for a first step
        short of features) from a generator of seed 0; with the lazy
        k-means init, ``initialized`` (a host bool: the step reads it with
        no device sync)."""
        extra: dict[str, Any] = {}
        if self.codebook_update and self.codebook_update["type"] == "cvq":
            cb = self.model.get_parameter(self.codebook_name)
            extra["probability"] = torch.zeros(cb.shape[0], dtype=torch.float32, device=cb.device)
            if self.codebook_update.get("anchor") == "cached":
                gen = torch.Generator(device=cb.device).manual_seed(0)
                extra["anchor_cache"] = torch.rand(tuple(cb.shape), generator=gen, device=cb.device)
        if self.lazy_kmeans_init is not None:
            extra["initialized"] = False
        return extra

    # -- loss --------------------------------------------------------------

    def _recon_target(self, out, batch, extra) -> torch.Tensor | None:
        """What the decoder reconstructs; None: no reconstruction term."""
        return batch["image"] if "pred" in out else None

    def _recon(self, name: str, cfg: Mapping[str, Any], pred, target) -> torch.Tensor:
        if name == "lpips":
            return cfg.get("weight", 1.0) * self.lpips_module(pred, target)
        return RECON_LOSSES[name](pred, target, **cfg)

    def _losses(self, out, batch, extra=None) -> dict[str, torch.Tensor]:
        losses = dict(out["quantizer"].losses)
        if out["quantizer"].loss.dim() == 0 and not losses:
            losses["loss_quantizer"] = out["quantizer"].loss
        target = self._recon_target(out, batch, extra or {})
        if target is not None:
            for name, cfg in self.recon_losses.items():
                losses[f"loss_{name}"] = self._recon(name, cfg, out["pred"], target)
        return losses

    def _codebook_update(self, state: TrainState, qout=None) -> None:
        if self.codebook_update is not None:
            x, codes = (None, None) if qout is None else (qout.aux["x"], qout.codes)
            apply_codebook_update(self.codebook_update, state.model.get_parameter(self.codebook_name),
                                  x, codes, state.extra, state.rng, self.data_group)

    @torch.no_grad()
    def _maybe_lazy_init(self, state: TrainState, image: torch.Tensor) -> None:
        """On the first step: the codebook from k-means over the global
        batch's features (:func:`...ops.codebook.kmeans_init` over the data
        group's gathered rows, drawing from ``state.rng``, the same on every
        rank); data rank 0's result is broadcast, so the replicas agree bit
        for bit whatever order the device's atomics summed in."""
        if state.extra["initialized"]:
            return
        cfg = self.lazy_kmeans_init
        codebook = state.model.get_parameter(self.codebook_name)
        feat = state.model.encode(image)
        codebook.copy_(cb_ops.kmeans_init(
            feat, codebook.shape[0], state.rng, iters=cfg.get("iters", 10),
            normalize_input=cfg.get("normalize_input", True), group=self.data_group).to(codebook.dtype))
        broadcast_(codebook.data, self.data_group)
        state.extra["initialized"] = True

    def _step_gradients(self, state: TrainState, total: torch.Tensor) -> None:
        """The optimizer's step on ``total``'s gradient with respect to the
        trained parameters."""
        params, tx = state.params(), self.tx()
        grads = torch.autograd.grad(total, tx.trained(params), allow_unused=True, materialize_grads=True)
        self.apply_gradients(tx, params, list(grads), state.opt_state)

    # -- steps -------------------------------------------------------------

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        image = batch["image"].to(self.device)
        if self.lazy_kmeans_init is not None:
            self._maybe_lazy_init(state, image)
        out = state.model(image, train=True)
        losses = self._losses(out, {**batch, "image": image}, state.extra)
        total = sum(losses.values(), self._zero())
        if not out["quantizer"].losses:
            total = total + out["quantizer"].loss
        self._step_gradients(state, total)
        self._codebook_update(state, out["quantizer"])
        self.maybe_update_ema(state.extra, state.model)
        state.step += 1
        return state, {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        image = batch["image"].to(self.device)
        out = state.model(image, train=False)
        memo = {"codes": out["quantizer"].codes, **self._losses(out, {**batch, "image": image}, state.extra)}
        if "pred" in out:
            memo["pred"] = out["pred"]
        return memo
