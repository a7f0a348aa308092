"""Codebook statistics and the non-gradient codebook updates (port of
``vector_quantization_tpu/ops/codebook.py``): the EMA k-means of VQ-KD,
its k-means initialisation, and CVQ-VAE's anchor re-initialisation with
its four anchor rules (nearest, as Cluster runs it; multinomial, random
and cached, the last carrying the previous step's anchors).

One process, one device: the JAX functions' ``axis_name`` reductions
(``psum``, ``all_gather``) are not ported (ROADMAP.md queue A:
Parallelism), and the JAX call sites pass ``axis_name=None``.

Every nearest-code assignment goes through :func:`.vq_lookup.nearest_codes`
(the hand-written kernel on a CUDA tensor). Per-code sums are a scatter-add
(``index_add_``) in f32, not the JAX package's one-hot matmul: that one-hot
is (N, K) and lands on a TPU's matrix unit; here it would be an N x K
matrix for a sum of N rows. Draws take a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import vq_lookup
from .distances import normalize

__all__ = [
    "code_histogram",
    "code_frequency",
    "ema",
    "cluster_stats",
    "kmeans_update",
    "kmeans_init",
    "kmeans_iterate",
    "cvq_anchors",
    "cvq_decay",
    "cvq_update",
    "cached_anchors",
    "multinomial_anchors",
    "nearest_anchors",
    "random_anchors",
]

def code_histogram(codes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """bincount of code ids -> (K,) int32."""
    return torch.bincount(codes.reshape(-1).long(), minlength=codebook_size).to(torch.int32)


def code_frequency(codes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    return code_histogram(codes, codebook_size).float() / float(codes.numel())


def ema(old: torch.Tensor, new: torch.Tensor, decay) -> torch.Tensor:
    """``decay·old + (1−decay)·new``; ``decay`` a scalar or a tensor that
    broadcasts (CVQ's per-code column)."""
    decay = torch.as_tensor(decay, dtype=old.dtype, device=old.device)
    return old * decay + new.to(old.dtype) * (1.0 - decay)


def cluster_stats(
    x: torch.Tensor, codes: torch.Tensor, codebook_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per code: (counts (K,) f32, feature sums (K, D) f32)."""
    x = x.reshape(-1, x.shape[-1]).float()
    codes = codes.reshape(-1).long()
    counts = torch.bincount(codes, minlength=codebook_size).float()
    sums = torch.zeros((codebook_size, x.shape[1]), dtype=torch.float32, device=x.device)
    return counts, sums.index_add_(0, codes, x)


def _centroids(counts, sums, fallback):
    """Each code's mean, or ``fallback``'s row where no point chose it."""
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts > 0)[:, None], means, fallback)


@torch.no_grad()
def kmeans_update(
    codebook: torch.Tensor,
    x: torch.Tensor,
    codes: torch.Tensor,
    decay: float | None = None,
    *,
    normalize_input: bool = True,
    renormalize: bool = True,
) -> torch.Tensor:
    """One k-means/EMA step (VQ-KD): each code's centroid of the (normalised)
    features assigned to it, the old entry where none was; renormalised;
    EMA'd into the codebook with ``decay``; renormalised again."""
    if normalize_input:
        x = normalize(x.reshape(-1, x.shape[-1]))
    counts, sums = cluster_stats(x, codes, codebook.shape[0])
    centroids = _centroids(counts, sums, codebook)
    if renormalize:
        centroids = normalize(centroids)
    new = centroids if decay is None else ema(codebook, centroids, decay)
    if renormalize:
        new = normalize(new)
    return new.to(codebook.dtype)


@torch.no_grad()
def kmeans_iterate(x: torch.Tensor, e: torch.Tensor, iters: int, chunk_elems: int = 2**27) -> torch.Tensor:
    """``iters`` Lloyd iterations from the start ``e`` (K, D) over the
    points ``x`` (N, D): normalise the entries, assign every point by the
    l2 lookup, move each entry to its points' mean (an empty entry keeps
    its normalised value); the result normalised. Where N·K exceeds
    ``chunk_elems`` the points are assigned and summed in chunks of
    ``max(128, chunk_elems // K)`` rows, as the JAX package bounds its
    (N, K) intermediates."""
    n, k = x.shape[0], e.shape[0]
    chunk = n if n * k <= chunk_elems else max(128, chunk_elems // k)
    for _ in range(iters):
        e_n = normalize(e)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
        for lo in range(0, n, chunk):
            xc = x[lo:lo + chunk]
            c, s = cluster_stats(xc, vq_lookup.nearest_codes(xc, e_n, "l2"), k)
            counts += c
            sums += s
        e = _centroids(counts, sums, e_n)
    return normalize(e)


def _randperm_draw(generator: torch.Generator | None, device) -> Callable[[int, int], torch.Tensor]:
    def draw(n: int, m: int) -> torch.Tensor:
        return torch.randperm(n, generator=generator, device=device)[:m]

    return draw


@torch.no_grad()
def kmeans_init(
    x: torch.Tensor,
    codebook_size: int,
    generator: torch.Generator | None = None,
    iters: int = 10,
    *,
    normalize_input: bool = True,
    max_points: int = 2**20,
    chunk_elems: int = 2**27,
    draw: Callable[[int, int], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Data-dependent codebook init (VQ-KD's lazy init): features (…, D) ->
    a (K, D) codebook of unit rows.

    The features are flattened and normalised; more than ``max_points`` of
    them are subsampled to ``max_points``; fewer than K fill the first rows
    and leave the rest zero; otherwise K distinct points are the start of
    :func:`kmeans_iterate`. ``draw(n, m)`` returns m distinct indices of
    [0, n), in that order the subsample's and then the start's; by default
    ``torch.randperm`` under ``generator``."""
    draw = draw or _randperm_draw(generator, x.device)
    x = x.reshape(-1, x.shape[-1]).float()
    if normalize_input:
        x = normalize(x)
    n, dim = x.shape
    if n > max_points:
        x = x[draw(n, max_points)]
        n = max_points
    if n < codebook_size:
        return torch.cat([x, x.new_zeros((codebook_size - n, dim))])
    return kmeans_iterate(x, x[draw(n, codebook_size)], iters, chunk_elems)


# -- CVQ-VAE's online clustered re-initialisation ----------------------------


def cvq_decay(p: torch.Tensor, codebook_size: int, ema_decay: float, eps: float = 1e-3) -> torch.Tensor:
    """Per-code retention ``1 − exp(−p·K·10/(1−γ) − eps)``: ~1 for a code in
    use, ~eps for a dead one (which snaps to its anchor)."""
    return 1.0 - torch.exp(-p * codebook_size * 10.0 / (1.0 - ema_decay) - eps)


def nearest_anchors(x: torch.Tensor, d: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Per code, the closest feature: ``x[argmin_n d[n, k]]`` (the first on
    a tie)."""
    return x[torch.argmin(d, dim=0)]


def multinomial_anchors(x: torch.Tensor, d: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per code, one feature drawn with probability ``softmax(d.T)`` over
    the features: a softmax of the raw distance, as the reference computes
    it, so a farther feature is the likelier draw."""
    probs = torch.softmax(d.t().float(), dim=-1)  # (K, N)
    return x[torch.multinomial(probs, 1, generator=generator)[:, 0]]


def random_anchors(x: torch.Tensor, d: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """K features drawn without replacement when there are at least K;
    else all N features, then K − N rows of uniform [0, 1) noise."""
    k, (n, dim) = d.shape[1], x.shape
    if n >= k:
        return x[torch.randperm(n, generator=generator, device=x.device)[:k]]
    missing = torch.rand((k - n, dim), generator=generator, device=x.device, dtype=x.dtype)
    return torch.cat([x, missing])


def cached_anchors(x: torch.Tensor, d: torch.Tensor, generator: torch.Generator,
                   cache: torch.Tensor) -> torch.Tensor:
    """CachedAnchor: K rows drawn without replacement from the pool of
    this step's features, joined by the previous step's anchors (the
    ``cache``, (K, D)) when there are fewer than K features, and padded
    with uniform [0, 1) noise while still short. The anchors become the
    next cache."""
    k, (n, dim) = d.shape[1], x.shape
    pool = torch.cat([x, cache.to(x.dtype)]) if n < k else x
    if pool.shape[0] < k:
        missing = torch.rand((k - pool.shape[0], dim), generator=generator, device=x.device, dtype=x.dtype)
        pool = torch.cat([pool, missing])
    return pool[torch.randperm(pool.shape[0], generator=generator, device=x.device)[:k]]


ANCHORS = {"nearest": nearest_anchors, "multinomial": multinomial_anchors, "random": random_anchors,
           "cached": cached_anchors}


@torch.no_grad()
def cvq_anchors(x: torch.Tensor, d: torch.Tensor, anchor: str = "nearest",
                generator: torch.Generator | None = None, cache: torch.Tensor | None = None) -> torch.Tensor:
    """Each code's anchor (K, D) from the features ``x`` (N, D) and their
    distances ``d`` (N, K) to the codebook, by the named rule; the random
    rules draw from ``generator``, ``"cached"`` also reads ``cache``."""
    x = x.reshape(-1, x.shape[-1])
    if anchor == "cached":
        if cache is None:
            raise ValueError("anchor='cached' requires the anchor cache")
        return cached_anchors(x, d, generator, cache)
    return ANCHORS[anchor](x, d, generator)


@torch.no_grad()
def cvq_update(
    codebook: torch.Tensor,
    p: torch.Tensor,
    x: torch.Tensor,
    d: torch.Tensor,
    codes: torch.Tensor,
    *,
    ema_decay: float,
    eps: float = 1e-3,
    anchors: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One CVQ-VAE codebook step -> (new codebook, new probability): the
    code frequency EMA'd into ``p``, and the per-code decay blending each
    code's anchor into the codebook. ``anchors`` (K, D) are
    :func:`cvq_anchors`' (default: the nearest, by the distances ``d``
    (N, K)). (One device: the JAX function's ``sync``, gathering the
    features across devices or averaging the anchors, changes nothing
    here.)"""
    x = x.reshape(-1, x.shape[-1])
    p = ema(p, code_frequency(codes, codebook.shape[0]), ema_decay)
    if anchors is None:
        anchors = nearest_anchors(x, d)
    decay = cvq_decay(p, codebook.shape[0], ema_decay, eps)[:, None]
    return ema(codebook, anchors, decay).to(codebook.dtype), p
