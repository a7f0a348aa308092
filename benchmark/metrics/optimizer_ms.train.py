"""optimizer_ms.train: device ms a step launched inside the program's span
``vq.optimizer`` (``algorithms/base.py`` ``apply_gradients``: AdamW with
the global-norm clip, ``training/optim.py``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, "vq.optimizer")
