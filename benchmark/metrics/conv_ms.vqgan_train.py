"""conv_ms.vqgan_train: device ms a step of the convolutions (generator,
LPIPS, PatchGAN; forward and backward)."""

from benchmark import readers

OPS = readers.CONV_OPS


def read(run):
    ms = readers.device_ms(run, OPS)
    steps = run.counters.get("steps", 0)
    return ms / steps if ms is not None and steps else None
