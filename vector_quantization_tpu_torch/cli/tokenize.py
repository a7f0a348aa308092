"""``python -m vector_quantization_tpu_torch.cli.tokenize NAME CONFIG [--train]``

Runs the tokenizer's ``encode_to_quant`` (no decode) over the validator's
dataset (``--train``: the trainer's) and writes each batch's
``{id_, category, tokens}`` to ``<work_dir>/tokens/<i>_<process>.npz``
(``--output`` another directory); tokens are int32 (B, h, w).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..parallel.mesh import init_distributed, process_index
from ..training.runner import build_runner
from ..utils.flags import Store
from .common import build_parser, prepare

logger = logging.getLogger("vector_quantization_tpu_torch")


def main(argv=None) -> str:
    parser = build_parser(__doc__)
    parser.add_argument("--train", action="store_true", help="tokenize the trainer's split")
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    init_distributed()
    config = prepare(args)
    cfg = config.copy()
    if args.train:
        cfg["validator"]["dataset"] = config["trainer"]["dataset"]
    runner = build_runner(cfg, "validator", device=args.device, work_dir=args.work_dir)
    runner.init_state()
    if args.load_model_from:
        runner.load_model_from(args.load_model_from)
    model = runner.state.model

    out_dir = args.output or os.path.join(runner.work_dir, "tokens")
    os.makedirs(out_dir, exist_ok=True)
    rank = process_index()
    n = len(runner.dataloader)
    if Store.DRY_RUN:
        n = min(n, 2)
    for i, batch in enumerate(runner.dataloader):
        if i >= n:
            break
        image = runner.strategy.shard_batch({"image": batch["image"]})["image"]
        with torch.no_grad():
            codes = model.encode_to_quant(image)
        np.savez(os.path.join(out_dir, f"{i}_{rank}.npz"), id_=np.asarray(batch["id_"]),
                 category=batch["category"], tokens=codes.cpu().numpy())
        if i % 20 == 0:
            logger.info("tokenized %d/%d batches", i, n)
    logger.info("tokens written to %s", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
