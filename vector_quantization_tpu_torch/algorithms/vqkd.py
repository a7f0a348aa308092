"""VQ-KD and Cluster: tokenizers trained against a frozen image-understanding
teacher (port of ``vector_quantization_tpu/algorithms/vqkd.py``).

``VQKDAlgorithm`` (BEiT v2): the decoder reconstructs the **teacher's
features** of the original image; the loss is the quantizer's commitment
term plus the cosine distance to those features. The codebook is
initialised by k-means over the first batch's features and then follows an
EMA k-means after every step, outside the optimizer (``exclude="codebook"``
by default). The teacher belongs to the algorithm: frozen, in eval mode,
run under ``no_grad`` on ``batch["original_image"]`` (uint8 NHWC);
``state.extra["teacher_params"]`` holds its weights by name (the module's
own tensors, under the JAX state's key).

``ClusterAlgorithm``, the training-free sibling: the teacher is the
encoder (``ClusterEncoder``), there is no decoder, and only the codebook
learns: the codebook loss through the optimizer (the config excludes the
encoder) and CVQ's anchor re-initialisation after each step.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..models.teachers import base as _teachers_base  # noqa: F401  (registers)
from ..models.teachers import convnext as _teachers_convnext  # noqa: F401
from ..models.teachers import encoder as _teachers_encoder  # noqa: F401
from ..models.teachers import vit as _teachers_vit  # noqa: F401
from ..registries import AlgorithmRegistry, TeacherRegistry
from ..training.state import TrainState
from .base import ReconstructionAlgorithm

__all__ = ["VQKDAlgorithm", "ClusterAlgorithm"]


@AlgorithmRegistry.register()
class VQKDAlgorithm(ReconstructionAlgorithm):
    def __init__(
        self,
        *,
        teacher: Mapping[str, Any] | nn.Module,
        teacher_image_key: str = "original_image",
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("recon_losses", {"cosine": {}})
        kwargs.setdefault("codebook_update", {"type": "kmeans", "decay": 0.99})
        kwargs.setdefault("lazy_kmeans_init", {"iters": 10})
        opt = dict(kwargs.get("optimizer") or {"type": "adamw", "lr": 2e-4})
        opt.setdefault("exclude", "codebook")  # EMA-updated, not optimized
        kwargs["optimizer"] = opt
        super().__init__(**kwargs)
        if not isinstance(teacher, nn.Module):
            teacher = TeacherRegistry.build(teacher)
        self.teacher = teacher.to(self.device).eval().requires_grad_(False)
        self.teacher_image_key = teacher_image_key

    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        state.extra["teacher_params"] = dict(self.teacher.named_parameters())
        return state

    def extra_modules(self) -> dict[str, tuple[nn.Module, bool]]:
        return {**super().extra_modules(), "teacher_params": (self.teacher, False)}

    @torch.no_grad()
    def _recon_target(self, out, batch, extra) -> torch.Tensor:
        image = torch.as_tensor(batch[self.teacher_image_key]).to(self.device)
        return self.teacher(image, return_2d=True)


@AlgorithmRegistry.register()
class ClusterAlgorithm(ReconstructionAlgorithm):
    """Frozen teacher as the encoder; the codebook learns by the codebook
    loss and CVQ's updates."""

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("codebook_update",
                          {"type": "cvq", "ema_decay": 0.99, "anchor": "nearest", "sync": True})
        kwargs.setdefault("recon_losses", {})
        super().__init__(**kwargs)
