"""ar_step_mfu: the least time of the traced window's AR steps (their
operations from ``benchmark/flops.py`` at 989 TFLOP/s, or their bytes at
3.35 TB/s) over the traced window, in %."""

from benchmark import flops, readers


def read(run):
    if not readers.traced(run):
        return None
    c, tr = run.cell.config, run.cell.traffic
    f, b = flops.ar_step(c, int(tr["batch"]), int(tr["image_size"]))
    return readers.share_pct(run, flops.least_s(f, b), run.counters.get("steps", 0))
