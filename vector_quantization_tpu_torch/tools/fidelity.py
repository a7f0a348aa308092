"""Inception Score of a folder of images (port of ``tools/fidelity.py``),
the reference's torch-fidelity cross-check.

    python -m vector_quantization_tpu_torch.tools.fidelity --pred DIR [--gt DIR] \\
        [--inception-weights PTH] [--splits 10] [--device cpu]

The score is over a softmax of the first 1000 pool features (the
feature extractor has no classifier head): a relative measure, as in the
JAX tool. Images and weights are read as ``tools.fid`` reads them; without
weights the line is tagged ``fid_random_init``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.metrics.fid import inception_score
from .fid import folder_images, inception

__all__ = ["main"]


def main(argv=None) -> tuple[float, float]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", default=None)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--device", default=None, help="default: cuda (cpu runs on the host)")
    args = p.parse_args(argv)

    features, random_init = inception(args.inception_weights, args.device)
    probs = [torch.softmax(torch.from_numpy(features(batch))[:, :1000], dim=-1).numpy()
             for batch in folder_images(args.pred, args.batch_size, args.image_size)]
    n = sum(len(b) for b in probs)
    mean, std = inception_score(np.concatenate(probs), splits=args.splits)
    print(f"IS: {mean:.4f} +- {std:.4f} (n={n})" + (" fid_random_init" if random_init else ""))
    return mean, std


if __name__ == "__main__":
    main()
