"""Export tokenized ImageNet in LlamaGen's dataset format (port of
``tools/tokenize_llamagen.py``): per image, ten-crop token grids saved as
``imagenet{size}_codes/{i}.npy`` (int32, shape (10, h, w)) plus
``imagenet{size}_labels/{i}.npy`` (int64, shape (1,)).

    python -m vector_quantization_tpu_torch.tools.tokenize_llamagen NAME CONFIG --out DIR \\
        [--load-model-from CKPT] [--crop-size S] [--device cpu]

The config's ``validator`` names the tokenizer and the dataset; each image
is one ``encode_to_quant`` call over its ten crops (one nearest-code lookup
of 10·h·w rows). ``DRY_RUN`` caps the export at 8 items.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cli.common import build_parser, prepare
from ..training.runner import build_runner
from ..utils.flags import Store

__all__ = ["ten_crop", "main"]


def ten_crop(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) → (10, size, size, 3): 4 corners + center, + flipped."""
    h, w = img.shape[:2]
    coords = [
        (0, 0),
        (0, w - size),
        (h - size, 0),
        (h - size, w - size),
        ((h - size) // 2, (w - size) // 2),
    ]
    crops = [img[y: y + size, x: x + size] for y, x in coords]
    crops += [c[:, ::-1] for c in crops]
    return np.stack(crops)


def main(argv=None) -> None:
    parser = build_parser(__doc__)
    parser.add_argument("--out", required=True)
    parser.add_argument("--crop-size", type=int, default=None)
    args = parser.parse_args(argv)
    config = prepare(args)

    runner = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)
    runner.init_state()
    if args.load_model_from:
        runner.load_model_from(args.load_model_from)
    model = runner.state.model  # a GAN state's model is its generator (JAX's params["generator"])
    device = runner.strategy.device

    dataset = runner.dataloader.dataset
    size = args.crop_size or dataset.image_size
    codes_dir = os.path.join(args.out, f"imagenet{size}_codes")
    labels_dir = os.path.join(args.out, f"imagenet{size}_labels")
    os.makedirs(codes_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)

    n = len(dataset)
    if Store.DRY_RUN:
        n = min(n, 8)
    for i in range(n):
        item = dataset[i]
        crops = torch.from_numpy(np.ascontiguousarray(ten_crop(item.image, size))).to(device)
        with torch.no_grad():
            codes = model.encode_to_quant(crops).cpu().numpy()
        np.save(os.path.join(codes_dir, f"{i}.npy"), codes)
        np.save(
            os.path.join(labels_dir, f"{i}.npy"),
            np.asarray([item.category]),
        )
    print(f"exported {n} items to {args.out}")


if __name__ == "__main__":
    main()
