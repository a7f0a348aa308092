"""``python -m vector_quantization_tpu_torch.cli.fid NAME CONFIG``

Builds the FID reference cache of a dataset split: Inception's pool
features of the split's original images (on CUDA unless ``--device cpu``),
accumulated as float64 sums on the host, saved as the ``.npz`` that
``FIDMetric`` reads (``FIDStatistics.save``) to ``--fid-path``, else the
dataset's ``fid_path``, else ``work_dirs/<NAME>/<dataset>_fid.npz``.

``--split`` (default ``validator``) names the config's runner whose
dataset is read; its ``fid_batch_size`` (default 64) is the batch size,
clamped to the dataset's length; the last batch is padded as the data
loader pads it. ``--inception-weights``: a pytorch-fid state dict (``.pth``
or a directory holding one); without it the network is a fixed random init
and the statistics are not a real FID's. Under ``DRY_RUN`` at most 2
batches.
"""

from __future__ import annotations

import itertools
import logging
import os

import numpy as np
import torch

from ..data.loader import DataLoader
from ..models.metrics.fid import FIDStatistics
from ..models.metrics.inception import load_inception
from ..parallel.mesh import host_allreduce_sum, init_distributed, process_index
from ..registries import DatasetRegistry
from ..tasks.image_tokenization import model_device
from ..utils.flags import Store
from .common import build_parser, prepare

logger = logging.getLogger("vector_quantization_tpu_torch")


def main(argv=None) -> str:
    parser = build_parser(__doc__)
    parser.add_argument("--fid-path", default=None)
    parser.add_argument("--inception-weights", default=None)
    parser.add_argument("--split", default="validator")
    args = parser.parse_args(argv)
    init_distributed(args.device)
    config = prepare(args)
    device = model_device(args.device)
    split = config[args.split]
    dataset = DatasetRegistry.build(split["dataset"])
    batch_size = max(1, min(split.get("fid_batch_size", 64), len(dataset)))
    loader = DataLoader(dataset, batch_size=batch_size, num_workers=8, drop_last=False)
    if not args.inception_weights:
        logger.warning("no --inception-weights: the Inception network is a RANDOM init")
    model, _ = load_inception(args.inception_weights, device)
    stats = FIDStatistics()
    n = min(len(loader), 2) if Store.DRY_RUN else len(loader)
    with torch.inference_mode():
        for i, batch in enumerate(itertools.islice(loader, n)):
            stats.update(model(torch.from_numpy(batch["original_image"]).to(device)).cpu().numpy())
            if i % 10 == 0:
                logger.info("fid cache: %d/%d batches", i, n)
    # every process's rows: the float64 sums added over the processes
    stats.n = int(host_allreduce_sum(np.asarray(stats.n, np.int64)))
    stats.sum, stats.sum_outer = host_allreduce_sum(stats.sum), host_allreduce_sum(stats.sum_outer)
    fid_path = args.fid_path or dataset.fid_path or os.path.join("work_dirs", args.name, f"{dataset.name}_fid.npz")
    if process_index() == 0:
        os.makedirs(os.path.dirname(fid_path) or ".", exist_ok=True)
        stats.save(fid_path)
        logger.info("saved FID stats (n=%d) to %s", stats.n, fid_path)
    return fid_path


if __name__ == "__main__":
    main()
