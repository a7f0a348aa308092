"""mla_ms.moe: device ms a step of the DeepSeek-V3 prior's latent attention,
forward (the span ``vq.mla``: the input norm, the four projections, RoPE,
the attention) and backward (the range ``mla.backward``)."""

from benchmark import moe_trace

FORWARD = ("vq.mla",)
BACKWARD = ("mla.backward",)
EXCLUDE = ()


def read(run):
    return moe_trace.part_ms(run, FORWARD, BACKWARD, EXCLUDE)
