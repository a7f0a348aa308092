"""Token → representative image patches collage (port of
``tools/visualize_patches.py``): tokenize the validator's batches, then for
each of the requested code ids collect the image patches of
``original_image`` that mapped to it and save a grid as a PNG (one row per
token, ``--per-token`` patches, zeros where fewer were found).

    python -m vector_quantization_tpu_torch.tools.visualize_patches NAME CONFIG --tokens 0 17 42 \\
        [--load-model-from CKPT] [--out patches.png] [--device cpu]

``DRY_RUN`` reads at most 2 batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cli.common import build_parser, prepare
from ..data.base import require_pil
from ..training.runner import build_runner
from ..utils.flags import Store

__all__ = ["main"]


def main(argv=None) -> None:
    parser = build_parser(__doc__)
    parser.add_argument("--tokens", type=int, nargs="+", required=True)
    parser.add_argument("--per-token", type=int, default=8)
    parser.add_argument("--out", default="patches.png")
    args = parser.parse_args(argv)
    config = prepare(args)
    image = require_pil()

    runner = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)
    runner.init_state()
    if args.load_model_from:
        runner.load_model_from(args.load_model_from)
    model = runner.state.model  # a GAN state's model is its generator (JAX's params["generator"])
    device = runner.strategy.device

    collected: dict[int, list[np.ndarray]] = {t: [] for t in args.tokens}
    n_batches = len(runner.dataloader)
    if Store.DRY_RUN:
        n_batches = min(n_batches, 2)
    for bi, batch in enumerate(runner.dataloader):
        if bi >= n_batches or all(
            len(v) >= args.per_token for v in collected.values()
        ):
            break
        with torch.no_grad():
            codes = model.encode_to_quant(torch.from_numpy(batch.image).to(device)).cpu().numpy()  # (B, h, w)
        b, h, w = codes.shape
        patch = batch.original_image.shape[1] // h
        for t in args.tokens:
            if len(collected[t]) >= args.per_token:
                continue
            ys, xs, zs = np.where(codes == t) if codes.ndim == 3 else ([], [], [])
            for img_i, py, px in zip(ys, xs, zs):
                if len(collected[t]) >= args.per_token:
                    break
                collected[t].append(
                    batch.original_image[
                        img_i,
                        py * patch: (py + 1) * patch,
                        px * patch: (px + 1) * patch,
                    ]
                )

    patch_size = max(
        (p.shape[0] for v in collected.values() for p in v), default=16
    )
    rows = []
    for t in args.tokens:
        patches = collected[t][: args.per_token]
        while len(patches) < args.per_token:
            patches.append(np.zeros((patch_size, patch_size, 3), np.uint8))
        rows.append(np.concatenate(patches, axis=1))
    grid = np.concatenate(rows, axis=0)
    image.fromarray(grid).save(args.out)
    print(f"saved {args.out} ({len(args.tokens)} tokens)")


if __name__ == "__main__":
    main()
