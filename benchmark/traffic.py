"""The one traffic generator: items of uint8 images and class labels drawn
from the run's seed, by the parameters of a traffic file.

A traffic file (``benchmark/traffic/<name>.json``) gives

- ``batch``: images in one item (a training step's batch, one image for
  an export);
- ``image_size``: the side of each square RGB image, in pixels;
- ``classes``: labels are uniform over this many classes;
- ``items_per_second``: an upper estimate of the program's rate, which
  sizes the pool: ``ceil(seconds · items_per_second)`` items for the
  window, plus ``extra_items`` for set-up's checked and warm-up items.

Every item is distinct. The pool is made once, on the host, at set-up, in
pinned memory where a card is used, and a run walks it in order, wrapping
only if the program outruns ``items_per_second``. The same seed gives the
same items: item ``i`` depends on the seed and ``i`` alone. A ``Feed``
stages items onto the device on a copy stream, two ahead of use.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass

import numpy as np
import torch

from .weights import derive


@dataclass
class Pool:
    images: torch.Tensor  # (P, B, S, S, 3) uint8, host
    labels: torch.Tensor  # (P, B) int64, host

    def __len__(self) -> int:
        return self.images.shape[0]


def make_pool(traffic: dict, seed: int, seconds: float, pin: bool) -> Pool:
    b, s = int(traffic["batch"]), int(traffic["image_size"])
    n = math.ceil(seconds * float(traffic["items_per_second"])) + int(traffic.get("extra_items", 0))
    images = torch.empty((n, b, s, s, 3), dtype=torch.uint8, pin_memory=pin)
    flat = images.numpy().reshape(n, -1)
    item_bytes = flat.shape[1]
    for i in range(n):
        rng = np.random.default_rng(derive(seed, f"image:{i}"))
        flat[i] = np.frombuffer(rng.bytes(item_bytes), dtype=np.uint8)
    rng = np.random.default_rng(derive(seed, "labels"))
    labels = torch.from_numpy(rng.integers(0, int(traffic["classes"]), size=(n, b), dtype=np.int64))
    return Pool(images, labels)


def to_pixels(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1], as the program's data layer maps them."""
    return u8.to(torch.float32) / 127.5 - 1.0


class Feed:
    """Items of a pool as device tensors, in order, staged ``depth`` ahead
    on a copy stream (the compute stream waits for each before use)."""

    def __init__(self, pool: Pool, device: torch.device, depth: int = 2, start: int = 0) -> None:
        self.pool, self.device, self.depth = pool, device, depth
        self.next_index = start
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.pending: collections.deque = collections.deque()

    def _stage(self) -> None:
        i = self.next_index % len(self.pool)
        self.next_index += 1
        if not self.cuda:
            self.pending.append((i, self.pool.images[i], self.pool.labels[i], None))
            return
        with torch.cuda.stream(self.copy_stream):
            img = self.pool.images[i].to(self.device, non_blocking=True)
            lab = self.pool.labels[i].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.pending.append((i, img, lab, done))

    def next(self) -> tuple[int, torch.Tensor, torch.Tensor]:
        """(pool index, images (B, S, S, 3) uint8, labels (B,)) on the device."""
        while len(self.pending) < self.depth:
            self._stage()
        i, img, lab, done = self.pending.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            img.record_stream(stream)
            lab.record_stream(stream)
        return i, img, lab
