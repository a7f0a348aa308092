"""tokenize_ms.train: device ms a step launched inside the program's span
``vq.ar.tokens`` (``algorithms/ar.py`` ``ARAlgorithm._tokens``: the frozen
tokenizer's encoder and K1 under ``no_grad``, the packing of [class |
codes])."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, "vq.ar.tokens")
