"""gpt2_gemm_ms.train: device ms a step launched inside the program's range
``gpt2.gemm`` (``ops/f32_gemm.py``: each product of GPT-2's ``_Dense``
layers and tied head, forward and backward, with the kernel's prologue that
splits an operand and the sum of its split-K parts). A program without the
range leaves it out."""

from benchmark import readers

RANGE = ("gpt2.gemm",)


def read(run):
    ms = readers.device_ms(run, RANGE)
    steps = run.counters.get("steps", 0)
    return ms / steps if ms is not None and steps else None
