"""Items of pre-exported code grids and class labels drawn from the run's
seed, by the parameters of a code-grid traffic file: what a C2I prior
trains on once the tokenizer has exported the corpus (LlamaGen's recipe,
``tools/tokenize_llamagen.py``).

A code-grid traffic file (``benchmark/traffic/<name>.json``) gives

- ``batch``: code grids in one item (a training step's batch);
- ``grid``: the side of each square grid of codes;
- ``codebook_size``: codes are uniform over this many;
- ``classes``: labels are uniform over this many classes;
- ``items_per_second`` and ``extra_items``: size the pool as in
  ``benchmark/traffic.py``.

Item ``i`` depends on the seed and ``i`` alone. The pool is made once on
the host at set-up, pinned where a card is used, and staged onto the device
two ahead by ``traffic.Feed`` (whose ``images`` are here the grids).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .traffic import Pool
from .weights import derive


def make_pool(traffic: dict, seed: int, seconds: float, pin: bool) -> Pool:
    """A pool whose ``images`` are (P, B, grid, grid) int32 codes and whose
    ``labels`` are (P, B) int64."""
    b, g = int(traffic["batch"]), int(traffic["grid"])
    n = math.ceil(seconds * float(traffic["items_per_second"])) + int(traffic.get("extra_items", 0))
    codes = torch.empty((n, b, g, g), dtype=torch.int32, pin_memory=pin)
    labels = torch.empty((n, b), dtype=torch.int64, pin_memory=pin)
    for i in range(n):
        codes[i] = torch.from_numpy(np.random.default_rng(derive(seed, f"codes:{i}")).integers(
            0, int(traffic["codebook_size"]), size=(b, g, g), dtype=np.int32))
        labels[i] = torch.from_numpy(np.random.default_rng(derive(seed, f"labels:{i}")).integers(
            0, int(traffic["classes"]), size=(b,), dtype=np.int64))
    return Pool(codes, labels)
