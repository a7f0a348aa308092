"""Validation metrics: accumulate per batch, reduce at ``summary`` (port of
``vector_quantization_tpu/training/metrics.py``).

- ``CodebookUsageMetric``: the share of the codebook that the run's codes
  hit; ``CodebookPPLMetric``: the entropy (nats) of the run's code
  histogram.
- ``ImageLossMetric``: ``l1``, ``mse``, ``psnr`` or ``ssim`` of
  ``pixel_decode(pred) / 255`` against the batch's uint8
  ``original_image / 255``, one value per batch, averaged over the run.
- ``LossMetric``: the mean over batches of a scalar memo entry (``key``,
  e.g. VQ-KD's ``loss_cosine``); ``AccuracyMetric`` likewise, its key
  ``accuracy`` by default (the AR ``eval_step``'s teacher-forced sampling
  accuracy).
- ``FIDMetric``: the Fréchet distance between the statistics of
  ``pixel_decode(memo[pred])``'s features and the ground truth's: a cached
  ``.npz`` (``fid_path``, default ``dataset.fid_path``; ``cli.fid`` writes
  one) or, without one, the run's own ``original_image`` batches. The
  features are Inception's pool features on the images' device
  (``features="inception"``; weights from ``weights`` or
  ``$PRETRAINED/inception``, a pytorch-fid state dict; without them the
  network is a fixed random init, the summary carries
  ``{name}_random_init: 1.0`` and the value is not a real FID), or the
  images resized to 4×4 by JAX's antialiased "linear" resize and flattened
  (``features="pixel"``). They reach the host as float64 sums
  (``models/metrics/fid.py``).

Every metric takes the ``dataset`` keyword (the ``Validator`` passes its
own, as the JAX package's does) and ``group``, the process group whose
ranks' rows make the evaluated set (the ``Validator`` passes its strategy's
data group; None: every process, or one process). A memo is what an
``eval_step`` returns plus ``memo["batch"]``, the batch. Each rank
accumulates its own rows' sufficient statistics, and ``summary`` sums them
over the group (``parallel.mesh.host_allreduce_sum``) as the JAX package's
does over its processes: the histograms, the per-batch values and their
count, FID's float64 ``n``, ``sum`` and ``sum_outer``. Every rank of the
group must call ``summary``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np
import torch

from ..data.base import pixel_decode
from ..models.losses.recon import psnr, ssim
from ..models.metrics.fid import FIDStatistics, frechet_distance
from ..models.metrics.inception import load_inception
from ..ops.resize import resize
from ..parallel.mesh import host_allreduce_sum
from ..registries import MetricRegistry
from ..utils.flags import Store

__all__ = ["AccuracyMetric", "BaseMetric", "CodebookUsageMetric", "CodebookPPLMetric", "ImageLossMetric",
           "LossMetric", "FIDMetric"]

logger = logging.getLogger("vector_quantization_tpu_torch")


def _mean_across_processes(values: list[float], group) -> float:
    """The mean of every rank's per-batch values (equal batches per rank)."""
    total = host_allreduce_sum(np.array([float(np.sum(values)), float(len(values))]), group)
    return float(total[0] / total[1]) if total[1] else 0.0


class BaseMetric:
    def __init__(self, *, dataset: Any = None, group: Any = None) -> None:
        self.dataset = dataset
        self.group = group

    def update(self, memo: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def summary(self, name: str) -> dict[str, float]:
        raise NotImplementedError


class _CodebookMixin(BaseMetric):
    def __init__(self, *, codebook_size: int, **kw: Any) -> None:
        super().__init__(**kw)
        self.codebook_size = codebook_size
        self.counts = np.zeros(codebook_size, np.int64)

    def update(self, memo: Mapping[str, Any]) -> None:
        codes = torch.as_tensor(memo["codes"]).reshape(-1).long()
        self.counts += torch.bincount(codes, minlength=self.codebook_size).cpu().numpy()


@MetricRegistry.register()
class CodebookUsageMetric(_CodebookMixin):
    def summary(self, name: str) -> dict[str, float]:
        counts = host_allreduce_sum(self.counts, self.group)
        return {name: float((counts > 0).sum() / self.codebook_size)}


@MetricRegistry.register()
class CodebookPPLMetric(_CodebookMixin):
    def summary(self, name: str) -> dict[str, float]:
        counts = host_allreduce_sum(self.counts, self.group)
        total = counts.sum()
        if total == 0:
            return {name: 0.0}
        p = counts / total
        p = p[p > 0]
        return {name: float(-(p * np.log(p)).sum())}


@MetricRegistry.register()
class ImageLossMetric(BaseMetric):
    """PSNR/SSIM/L1/MSE between the decoded prediction and the original
    images on [0, 1], one value per batch, averaged over the run."""

    def __init__(self, *, kind: str, **kw: Any) -> None:
        super().__init__(**kw)
        if kind not in ("l1", "mse", "psnr", "ssim"):
            raise ValueError(kind)
        self.kind = kind
        self.values: list[float] = []

    def update(self, memo: Mapping[str, Any]) -> None:
        pred = memo["pred"]
        pred01 = pixel_decode(pred).to(torch.float32) / 255.0
        gt01 = torch.as_tensor(memo["batch"]["original_image"]).to(pred.device, torch.float32) / 255.0
        if self.kind == "l1":
            value = torch.abs(pred01 - gt01).mean()
        elif self.kind == "mse":
            value = torch.square(pred01 - gt01).mean()
        elif self.kind == "psnr":
            value = psnr(pred01, gt01)
        else:
            value = ssim(pred01, gt01)
        self.values.append(float(value))

    def summary(self, name: str) -> dict[str, float]:
        return {name: _mean_across_processes(self.values, self.group)}


@MetricRegistry.register()
class LossMetric(BaseMetric):
    def __init__(self, *, key: str, **kw: Any) -> None:
        super().__init__(**kw)
        self.key = key
        self.values: list[float] = []

    def update(self, memo: Mapping[str, Any]) -> None:
        self.values.append(float(memo[self.key]))

    def summary(self, name: str) -> dict[str, float]:
        return {name: _mean_across_processes(self.values, self.group)}


@MetricRegistry.register()
class AccuracyMetric(LossMetric):
    def __init__(self, *, key: str = "accuracy", **kw: Any) -> None:
        super().__init__(key=key, **kw)


@MetricRegistry.register()
class FIDMetric(BaseMetric):
    """FID of ``memo[pred]`` against cached or run-accumulated ground-truth
    statistics (module docstring)."""

    def __init__(self, *, pred: str = "pred", fid_path: str | None = None, weights: str | None = None,
                 features: str = "inception", **kw: Any) -> None:
        super().__init__(**kw)
        if features not in ("inception", "pixel"):
            raise ValueError(f"unknown FID features {features!r}")
        self.pred = pred
        self.fid_path = fid_path or getattr(self.dataset, "fid_path", None)
        self.model, self.random_init = None, False
        if features == "inception":
            default = os.path.join(Store.PRETRAINED, "inception")
            if weights is None and os.path.isdir(default):
                weights = default
            if not weights:
                logger.warning("FIDMetric: no Inception weights (weights=None, no %s): the features are "
                               "a RANDOM init and the value is not a real FID (relative use only)", default)
            self.model, self.random_init = load_inception(weights, "cpu")
        self.pred_stats = FIDStatistics()
        self.gt_stats = None if self.fid_path else FIDStatistics()

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> np.ndarray:
        """uint8 (B, H, W, 3) on any device -> (B, F) f32 features on the host."""
        if self.model is None:
            out = resize(images.to(torch.float32) / 255.0, 4, 4, "linear").reshape(images.shape[0], -1)
        else:
            out = self.model.to(images.device)(images)
        return out.cpu().numpy()

    def update(self, memo: Mapping[str, Any]) -> None:
        pred = torch.as_tensor(pixel_decode(memo[self.pred]))
        self.pred_stats.update(self.features(pred))
        if self.gt_stats is not None:
            gt = torch.as_tensor(memo["batch"]["original_image"]).to(pred.device)
            self.gt_stats.update(self.features(gt))

    def _reduce_stats(self, stats: FIDStatistics) -> FIDStatistics:
        """(n, Σx, Σxxᵀ) summed over the group (float64; exact sums)."""
        if stats.dim is None:  # no rows here: the group's shapes still meet
            return stats
        stats.n = int(host_allreduce_sum(np.asarray(stats.n, np.int64), self.group))
        stats.sum = host_allreduce_sum(stats.sum, self.group)
        stats.sum_outer = host_allreduce_sum(stats.sum_outer, self.group)
        return stats

    def summary(self, name: str) -> dict[str, float]:
        self._reduce_stats(self.pred_stats)
        if self.gt_stats is not None:
            self._reduce_stats(self.gt_stats)
        gt = FIDStatistics.load(self.fid_path) if self.fid_path else self.gt_stats
        out = {name: frechet_distance(gt.mean, gt.cov, self.pred_stats.mean, self.pred_stats.cov)}
        if self.random_init:
            out[f"{name}_random_init"] = 1.0
        return out
