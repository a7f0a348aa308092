"""device_idle.vqgan_train: the share of the traced window in which nothing ran on
the device (1 - the union of its operations' intervals / the window), %."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
