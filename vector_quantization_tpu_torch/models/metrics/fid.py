"""FID statistics, the Fréchet distance and the Inception Score (the
port's own copy of ``vector_quantization_tpu/models/metrics/fid.py``, which
is plain numpy; every formula as it is there).

Features accumulate on the host in float64 as (Σx, Σxxᵀ, n) -> (μ, Σ) with
the unbiased covariance; FID(g, p) = ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2(Σ₁Σ₂)^{1/2}),
the trace of the square root from ``np.linalg.eigvals`` of the product
(real parts clipped at 0) after a 1e-6 diagonal offset; IS over ten splits.
``scipy.linalg.sqrtm`` or an ``eigvalsh`` form would change the number.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FIDStatistics", "frechet_distance", "inception_score"]


@dataclasses.dataclass
class FIDStatistics:
    """Streaming accumulator for (μ, Σ) of D-dim features. ``dim`` is
    inferred from the first ``update`` when not given (2048 for Inception,
    anything for alternate feature extractors)."""

    dim: int | None = None

    def __post_init__(self) -> None:
        self.n = 0
        if self.dim is not None:
            self.sum = np.zeros(self.dim, np.float64)
            self.sum_outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, features: np.ndarray) -> None:
        f = np.asarray(features, np.float64)
        if self.dim is None:
            self.dim = f.shape[1]
            self.sum = np.zeros(self.dim, np.float64)
            self.sum_outer = np.zeros((self.dim, self.dim), np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.sum_outer += f.T @ f

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.n, 1)

    @property
    def cov(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(self.sum_outer)
        mu = self.mean
        # unbiased covariance (matches np.cov / pytorch-fid)
        return (self.sum_outer - self.n * np.outer(mu, mu)) / (self.n - 1)

    def save(self, path: str) -> None:
        np.savez(
            path, n=self.n, sum=self.sum, sum_outer=self.sum_outer,
            mean=self.mean, cov=self.cov,
        )

    @classmethod
    def load(cls, path: str) -> "FIDStatistics":
        data = np.load(path)
        stats = cls(dim=int(data["sum"].shape[0]))
        stats.n = int(data["n"])
        stats.sum = data["sum"]
        stats.sum_outer = data["sum_outer"]
        return stats


def _sqrtm_trace(a: np.ndarray, b: np.ndarray, eps: float = 1e-6) -> float:
    """tr((A·B)^{1/2}) for symmetric PSD A, B via eigvals of the product."""
    eigvals = np.linalg.eigvals(a @ b)
    eigvals = np.real(eigvals)
    eigvals = np.clip(eigvals, 0.0, None)
    return float(np.sqrt(eigvals).sum())


def frechet_distance(
    mu1: np.ndarray,
    cov1: np.ndarray,
    mu2: np.ndarray,
    cov2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    diff = mu1 - mu2
    # regularise like pytorch-fid does when sqrtm is singular
    offset = np.eye(cov1.shape[0]) * eps
    tr_sqrt = _sqrtm_trace(cov1 + offset, cov2 + offset)
    fid = diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt
    return float(fid)


def inception_score(
    logits: np.ndarray, splits: int = 10, eps: float = 1e-16
) -> tuple[float, float]:
    """IS from (N, 1000) softmax probabilities (tools/fidelity.py parity)."""
    probs = np.asarray(logits, np.float64)
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        if part.size == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + eps) - np.log(py + eps))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
