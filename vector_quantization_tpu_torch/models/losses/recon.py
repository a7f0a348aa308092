"""Pixel reconstruction losses and metrics
(``vector_quantization_tpu/models/losses/recon.py``).

L1 and MSE on [-1, 1] images; the cosine-embedding loss over the channel
axis; PSNR (per-image ``-10·log10(MSE)``, averaged) and SSIM (uniform 7x7
window, VALID, K1 = 0.01, K2 = 0.03, the unbiased covariance, averaged over
pixels and channels: skimage's defaults) on [0, 1] images. Images are NHWC,
as in the JAX package; SSIM's window runs NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["l1_loss", "mse_loss", "cosine_loss", "psnr", "ssim"]


def cosine_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """mean(1 - cos(pred, target)) over the last axis."""
    p, t = pred.float(), target.float()
    dot = torch.sum(p * t, dim=-1)
    denom = torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(t, dim=-1)
    return weight * torch.mean(1.0 - dot / torch.clamp(denom, min=1e-8))


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * torch.mean(torch.abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * torch.mean(torch.square(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR, averaged over the batch. Inputs in [0, 1]."""
    mse = torch.mean(torch.square(pred - target), dim=tuple(range(1, pred.dim())))
    return torch.mean(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter over the spatial dims of (B, C, H, W), VALID."""
    c = x.shape[1]
    kernel = torch.full((c, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    return F.conv2d(x, kernel, groups=c)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over the batch. Inputs (B, H, W, C) in [0, data_range]."""
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = _uniform_filter(pred, win_size)
    mu_t = _uniform_filter(target, win_size)
    mu_pp = _uniform_filter(pred * pred, win_size)
    mu_tt = _uniform_filter(target * target, win_size)
    mu_pt = _uniform_filter(pred * target, win_size)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    var_p = cov_norm * (mu_pp - mu_p * mu_p)
    var_t = cov_norm * (mu_tt - mu_t * mu_t)
    cov = cov_norm * (mu_pt - mu_p * mu_t)
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)
