"""encoder_conv_ms: device ms an image (ten crops) of the convolutions."""

from benchmark import readers

OPS = readers.CONV_OPS


def read(run):
    ms = readers.device_ms(run, OPS)
    n = run.counters.get("images", 0)
    return ms / n if ms is not None and n else None
