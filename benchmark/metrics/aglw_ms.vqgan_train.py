"""aglw_ms.vqgan_train: device ms a step launched inside the program's span
``vq.vqgan.aglw`` (``algorithms/vqgan.py`` ``VQGANAlgorithm._aglw``: the
adaptive weight's two gradients at the decoder's last conv, through LPIPS
and through the PatchGAN, and their norms), its backward included."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, "vq.vqgan.aglw")
