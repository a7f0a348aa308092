"""moe_routing_ms.moe: device ms a step of the MoE layers' routing: the
router, the balance loss, the dispatch (the sort of the choices by held
expert, the gather of rows) and the combine (the weighted scatter-add),
forward (spans ``vq.moe.route``, ``vq.moe.balance``, ``vq.moe.dispatch``,
``vq.moe.combine``, and the bias's move after the optimizer, inside
``vq.moe.balance``) and backward (the range ``moe.backward`` less the
experts' and the shared experts' ranges inside it)."""

from benchmark import moe_trace

FORWARD = ("vq.moe.route", "vq.moe.balance", "vq.moe.dispatch", "vq.moe.combine")
BACKWARD = ("moe.backward",)
EXCLUDE = ("moe.experts.backward", "moe.shared.backward")


def read(run):
    return moe_trace.part_ms(run, FORWARD, BACKWARD, EXCLUDE)
