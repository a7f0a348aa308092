"""gpt2_matmul_ms: device ms a step of the matrix products (the operators
below, forward and backward: GPT-2's projections, its einsum attention,
the tied head; the encoder's attention products too, a small share),
convolutions excluded."""

from benchmark import readers

OPS = readers.MATMUL_OPS


def read(run):
    ms = readers.device_ms(run, OPS, exclude=readers.CONV_OPS)
    steps = run.counters.get("steps", 0)
    return ms / steps if ms is not None and steps else None
