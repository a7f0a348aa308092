"""export_mfu: the least time of the traced window's encodes (ten crops
an image: the encoder's convolutions and products and the lookup's, from
``benchmark/flops.py``) over the traced window, in %."""

from benchmark import flops, readers


def read(run):
    if not readers.traced(run):
        return None
    c, tr = run.cell.config, run.cell.traffic
    f, b = flops.encode(c, 10, int(tr["crop"]))
    return readers.share_pct(run, flops.least_s(f, b), run.counters.get("images", 0))
