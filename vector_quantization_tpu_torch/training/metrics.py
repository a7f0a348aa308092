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
- ``FIDMetric`` is not ported: it needs the Inception network.

A memo is what an ``eval_step`` returns plus ``memo["batch"]``, the batch.
One process: the JAX package's cross-host reductions are sums over one
host here.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..data.base import pixel_decode
from ..models.losses.recon import psnr, ssim
from ..registries import MetricRegistry

__all__ = ["AccuracyMetric", "BaseMetric", "CodebookUsageMetric", "CodebookPPLMetric", "ImageLossMetric",
           "LossMetric", "FIDMetric"]

_METRICS_CLI = "ROADMAP.md queue A: Metrics and CLI"


class BaseMetric:
    def update(self, memo: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def summary(self, name: str) -> dict[str, float]:
        raise NotImplementedError


class _CodebookMixin(BaseMetric):
    def __init__(self, *, codebook_size: int) -> None:
        self.codebook_size = codebook_size
        self.counts = np.zeros(codebook_size, np.int64)

    def update(self, memo: Mapping[str, Any]) -> None:
        codes = torch.as_tensor(memo["codes"]).reshape(-1).long()
        self.counts += torch.bincount(codes, minlength=self.codebook_size).cpu().numpy()


@MetricRegistry.register()
class CodebookUsageMetric(_CodebookMixin):
    def summary(self, name: str) -> dict[str, float]:
        return {name: float((self.counts > 0).sum() / self.codebook_size)}


@MetricRegistry.register()
class CodebookPPLMetric(_CodebookMixin):
    def summary(self, name: str) -> dict[str, float]:
        total = self.counts.sum()
        if total == 0:
            return {name: 0.0}
        p = self.counts / total
        p = p[p > 0]
        return {name: float(-(p * np.log(p)).sum())}


@MetricRegistry.register()
class ImageLossMetric(BaseMetric):
    """PSNR/SSIM/L1/MSE between the decoded prediction and the original
    images on [0, 1], one value per batch, averaged over the run."""

    def __init__(self, *, kind: str) -> None:
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
        return {name: float(np.mean(self.values)) if self.values else 0.0}


@MetricRegistry.register()
class LossMetric(BaseMetric):
    def __init__(self, *, key: str) -> None:
        self.key = key
        self.values: list[float] = []

    def update(self, memo: Mapping[str, Any]) -> None:
        self.values.append(float(memo[self.key]))

    def summary(self, name: str) -> dict[str, float]:
        return {name: float(np.mean(self.values)) if self.values else 0.0}


@MetricRegistry.register()
class AccuracyMetric(LossMetric):
    def __init__(self, *, key: str = "accuracy") -> None:
        super().__init__(key=key)


@MetricRegistry.register()
class FIDMetric(BaseMetric):
    def __init__(self, **kwargs: Any) -> None:
        raise NotImplementedError(f"FIDMetric (the Inception network): {_METRICS_CLI}")
