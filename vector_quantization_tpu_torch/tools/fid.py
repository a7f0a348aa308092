"""Offline FID of a folder of images vs cached statistics (or a second
folder), appended to ``fid.txt`` (port of ``tools/fid.py``).

    python -m vector_quantization_tpu_torch.tools.fid --pred work_dirs/x/visuals --stats data/val_fid.npz
    python -m vector_quantization_tpu_torch.tools.fid --pred DIR_A --gt DIR_B [--inception-weights PTH] \\
        [--device cpu]

Every ``.png``/``.jpg``/``.jpeg`` of a folder, in sorted order, through the
validator's ``Transform`` (shorter side to ``--image-size``, centre crop) and
the port's Inception (on CUDA unless ``--device cpu``). ``--inception-weights``
is pytorch-fid's state dict (a ``.pth`` or a directory holding one, read by
``pt_inception_state_dict``); without it the network is a fixed random
init, the line is tagged ``fid_random_init`` and the number is for relative
use only. ``--stats`` reads a ``cli.fid`` cache (``FIDStatistics.save``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.base import Transform, require_pil
from ..models.metrics.fid import FIDStatistics, frechet_distance
from ..models.metrics.inception import load_inception
from ..tasks.image_tokenization import model_device

__all__ = ["folder_images", "folder_stats", "inception", "main"]


def folder_images(path: str, batch_size: int, image_size: int):
    """The folder's images, sorted by name, as uint8 (B, S, S, 3) batches."""
    image = require_pil()
    transform = Transform(image_size)
    files = sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    for start in range(0, len(files), batch_size):
        imgs = []
        for f in files[start:start + batch_size]:
            with image.open(f) as img:
                imgs.append(transform(img))
        yield np.stack(imgs)


def folder_stats(path, apply, batch_size, image_size):
    stats = FIDStatistics()
    for batch in folder_images(path, batch_size, image_size):
        stats.update(apply(batch))
    return stats


def inception(weights: str | None, device: str | None):
    """(uint8 batch -> numpy pool features, whether the network is the
    random init) on ``device``."""
    dev = model_device(device)
    if not weights:
        print("WARNING: random inception init (no --inception-weights)")
    model, random_init = load_inception(weights, dev)

    def apply(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(batch).to(dev)).cpu().numpy()

    return apply, random_init


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", default=None)
    p.add_argument("--stats", default=None)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--out", default="fid.txt")
    p.add_argument("--device", default=None, help="default: cuda (cpu runs on the host)")
    args = p.parse_args(argv)
    assert args.gt or args.stats, "need --gt folder or --stats npz"

    apply, random_init = inception(args.inception_weights, args.device)
    pred = folder_stats(args.pred, apply, args.batch_size, args.image_size)
    if args.stats:
        gt = FIDStatistics.load(args.stats)
    else:
        gt = folder_stats(args.gt, apply, args.batch_size, args.image_size)
    fid = frechet_distance(gt.mean, gt.cov, pred.mean, pred.cov)
    line = f"{args.pred}: FID={fid:.4f} (n={pred.n})" + (" fid_random_init" if random_init else "")
    print(line)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return fid


if __name__ == "__main__":
    main()
