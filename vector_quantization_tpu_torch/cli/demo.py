"""``python -m vector_quantization_tpu_torch.cli.demo NAME CONFIG --image PATH``

One image through the tokenizer: resized and center-cropped to the
validator dataset's size, encoded to its code grid (printed, and written
to ``<out>/codes.npy``) and, where the model has a decoder, decoded to
``<out>/reconstruction.png``; ``<out>`` is ``--output`` or
``<work_dir>/demo``. Needs Pillow.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..data.base import Transform, pixel_decode, pixel_encode, require_pil
from ..training.runner import build_runner
from .common import build_parser, prepare

logger = logging.getLogger("vector_quantization_tpu_torch")


def main(argv=None) -> str:
    parser = build_parser(__doc__)
    parser.add_argument("--image", required=True)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    config = prepare(args)
    image = require_pil()

    runner = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)
    runner.init_state()
    if args.load_model_from:
        runner.load_model_from(args.load_model_from)
    model = runner.state.model

    with image.open(args.image) as img:
        original = Transform(runner.dataloader.dataset.image_size)(img)
    x = torch.from_numpy(pixel_encode(original)).to(runner.strategy.device)[None]
    out_dir = args.output or os.path.join(runner.work_dir, "demo")
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        codes = model.encode_to_quant(x)
        print("token grid:")
        print(codes[0].cpu().numpy())
        np.save(os.path.join(out_dir, "codes.npy"), codes[0].cpu().numpy())
        if getattr(model, "decoder", None) is not None:
            recon = pixel_decode(model.decode_from_quant(codes)[0]).cpu().numpy()
            image.fromarray(recon).save(os.path.join(out_dir, "reconstruction.png"))
            logger.info("wrote %s/reconstruction.png", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
