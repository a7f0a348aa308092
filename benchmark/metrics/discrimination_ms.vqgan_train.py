"""discrimination_ms.vqgan_train: device ms a step launched inside the
program's span ``vq.vqgan.discrimination`` (``algorithms/vqgan.py``: the
PatchGAN on the detached reconstruction and on the real images, the
hinge loss, its gradient and the discriminator's Adam step), its backward
included."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, "vq.vqgan.discrimination")
