"""What the kernels' launch plans read of a CUDA card."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = ["H100", "Card", "card"]


class Card(NamedTuple):
    """What a plan reads of the card: its SM count, the shared memory of
    one SM and the most of it one block may take (bytes)."""

    sms: int
    smem_sm: int
    smem_block: int


H100 = Card(132, 233_472, 232_448)  # NVIDIA H100 SXM (80GB HBM3), where the plans were tuned


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Card:
    props = torch.cuda.get_device_properties(index)
    return Card(props.multi_processor_count, props.shared_memory_per_multiprocessor,
                props.shared_memory_per_block_optin)


def card(device: torch.device) -> Card:
    """A CUDA device's :class:`Card`, read once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _card(idx)
