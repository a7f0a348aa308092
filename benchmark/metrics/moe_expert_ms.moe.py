"""moe_expert_ms.moe: device ms a step of the held routed experts' groups of
rows, forward (the span ``vq.moe.experts``) and backward (the range
``moe.experts.backward``)."""

from benchmark import moe_trace

FORWARD = ("vq.moe.experts",)
BACKWARD = ("moe.experts.backward",)
EXCLUDE = ()


def read(run):
    return moe_trace.part_ms(run, FORWARD, BACKWARD, EXCLUDE)
