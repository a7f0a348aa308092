"""Driver ``export``: the ten-crop token export of a corpus, one image at
a time, as the program's ``tools/tokenize_llamagen.py`` runs it.

Each item is one uint8 image of the traffic's size: cut on the host into
ten crops of ``crop`` px (:func:`ten_crop`, a frozen copy of the tool's),
copied to the device, mapped to [-1, 1] there, encoded by one
``encode_to_quant`` of the program's tokenizer (its encoder, then one
nearest-code lookup over the ten crops' rows), and read back to the host.
No file is written. Set-up warms the shapes with ``warm_items`` items;
after the window the reference encodes a sample of the window's images,
drawn from the seed, and judges their codes.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import compare, loop, traffic as tf, weights as wt
from benchmark.reference import steps as ref


def ten_crop(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) -> (10, size, size, 3): 4 corners + center, + flipped."""
    h, w = img.shape[:2]
    coords = [(0, 0), (0, w - size), (h - size, 0), (h - size, w - size), ((h - size) // 2, (w - size) // 2)]
    crops = [img[y: y + size, x: x + size] for y, x in coords]
    crops += [c[:, ::-1] for c in crops]
    return np.stack(crops)


def build(cell):
    import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: F401  (registers the classes it builds)
    import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: F401
    import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: F401
    from vector_quantization_tpu_torch.registries import ModelRegistry

    model = ModelRegistry.build(dict(cell.config["model"]), device=cell.device)
    w = ref.ir_weights(cell.config, cell.seed, cell.device)
    wt.load(model.encoder, w, "ir.encoder.")
    wt.load(model.quantizer, w, "ir.quantizer.")
    return model


def checks(codes: list, reference_feats: list, codebook) -> tuple[dict, dict]:
    gaps = [compare.code_gap(f, codebook, torch.as_tensor(c)) for f, c in zip(reference_feats, codes)]
    return {"code_gap": max(gaps, default=float("inf"))}, {"code_gaps": " ".join(f"{g:.3g}" for g in gaps)}


def run(cell) -> dict:
    dev, size = cell.device, int(cell.traffic["crop"])
    cell.mark("imports")
    model = build(cell)
    cell.mark("program and weights")
    pool = tf.make_pool(cell.traffic, cell.seed, cell.seconds, pin=False)
    counter = iter(range(10 ** 9))
    cell.mark("traffic")

    def item():
        with cell.range("traffic"):
            i = next(counter) % len(pool)
            crops = np.ascontiguousarray(ten_crop(pool.images[i][0].numpy(), size))
        with cell.range("stage"):
            x = tf.to_pixels(torch.from_numpy(crops).to(dev))
        with cell.range("encode"), torch.no_grad():
            codes = model.encode_to_quant(x)
        with cell.range("readback"):
            return i, codes.cpu().numpy()

    for _ in range(int(cell.workload["warm_items"])):
        item()
    setup_s = loop.start(cell)
    cell.mark("warm-up")

    done, window_s, trace = loop.window(cell, item)

    peak = loop.peak_bytes(dev)
    images = len(done)
    grid = (size // 2 ** (len(cell.config["enc_width_mults"]) - 1),) * 2
    k = int(cell.config["codebook_size"])
    failed = sum(1 for _, c in done if c.shape != (10, *grid) or c.min() < 0 or c.max() >= k)
    sample = random.Random(wt.derive(cell.seed, "sample")).sample(
        range(images), min(int(cell.workload["sampled_images"]), images))
    judged = [done[j] for j in sample]
    del model, done
    loop.release(dev)

    crops = [torch.from_numpy(np.ascontiguousarray(ten_crop(pool.images[i][0].numpy(), size))) for i, _ in judged]
    feats, _, codebook = ref.encode(cell.config, ref.ir_weights(cell.config, cell.seed, dev), dev, crops)
    return {"setup_s": setup_s, "window_s": window_s, "trace": trace, "memory_peak_bytes": peak,
            "attempted": images, "failed": failed,
            "counters": {"images": images, "crops": 10 * images, "peak_bytes": peak},
            **dict(zip(("checks", "detail"), checks([c for _, c in judged], feats, codebook)))}
