"""LPIPS perceptual loss on a VGG16 backbone
(``vector_quantization_tpu/models/losses/lpips.py``).

Inputs (B, H, W, 3) in [-1, 1] are shifted and scaled by LPIPS's constants;
VGG16's five stages (3x3 convs with padding 1 and ReLUs, a 2x2 VALID max
pool between stages) are tapped after each stage's last ReLU; each tap is
normalised over channels by ``rsqrt(Σ f² + 1e-10)``; the squared
difference goes through the tap's bias-free 1x1 conv ``lin{i}`` (flax
initialises it to 1.0), its spatial and channel mean is taken per image,
then the batch mean; the five scales are summed. This is the JAX module's
``deterministic=True``, which its training loss and metric run (its
dropout mode before the ``lin`` convs is not ported: nothing calls it).

The weights are frozen (``requires_grad=False``): the JAX package keeps
them in the state's ``extra`` and never differentiates them. Children keep
flax's names (``vgg.conv{i}``, ``lin{i}``) for the bridge.
:func:`lpips_state_dict` reads the pretrained weights from the two torch
files they are published as (where the JAX package reads its converted
orbax tree).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.converters import convert_vgg16_lpips, load_torch_state_dict

__all__ = ["LPIPS", "LPIPS_LIN_FILE", "LPIPS_VGG_FILE", "lpips_state_dict"]

LPIPS_VGG_FILE = "vgg16.pth"  # torchvision's vgg16 state dict (vgg16-397923af.pth)
LPIPS_LIN_FILE = "vgg.pth"  # LPIPS's lin 1x1 convs, ``{i}.weight`` or ``lins.{i}.weight``

_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)
# torchvision's VGG16 conv plan: (channels, convs per stage)
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class _VGG16Features(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        c, idx = 3, 0
        for width, depth in _STAGES:
            for _ in range(depth):
                self.add_module(f"conv{idx}", nn.Conv2d(c, width, 3, padding=1))
                c, idx = width, idx + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats, idx = [], 0
        for si, (_, depth) in enumerate(_STAGES):
            for _ in range(depth):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            feats.append(x)
            if si < len(_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.vgg = _VGG16Features()
        for i, (width, _) in enumerate(_STAGES):
            lin = nn.Conv2d(width, 1, 1, bias=False)
            nn.init.constant_(lin.weight, 1.0)
            self.add_module(f"lin{i}", lin)
        self.register_buffer("shift", torch.tensor(_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_STD).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred, target (B, H, W, 3) in [-1, 1] -> scalar LPIPS."""
        f_pred = self.vgg((pred.permute(0, 3, 1, 2) - self.shift) / self.scale)
        f_tgt = self.vgg((target.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        for i, (fp, ft) in enumerate(zip(f_pred, f_tgt)):
            fp = fp * torch.rsqrt(torch.sum(torch.square(fp), dim=1, keepdim=True) + 1e-10)
            ft = ft * torch.rsqrt(torch.sum(torch.square(ft), dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{i}")(torch.square(fp - ft))
            total = total + torch.mean(lin, dim=(1, 2, 3)).mean()
        return total


def lpips_state_dict(directory: str) -> dict[str, torch.Tensor]:
    """An ``LPIPS`` state dict from ``directory``'s ``LPIPS_VGG_FILE`` and
    ``LPIPS_LIN_FILE`` (both needed), through ``convert_vgg16_lpips``."""
    paths = [os.path.join(directory, name) for name in (LPIPS_VGG_FILE, LPIPS_LIN_FILE)]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(f"LPIPS weights: {', '.join(missing)} not found")
    return convert_vgg16_lpips(*(load_torch_state_dict(p) for p in paths))
