"""What the metric readers share: the device's idle share of a traced
window, and device time by the PyTorch operator that launched it.

A kernel's name says little about what it was for (cuDNN's FFT
convolutions run complex GEMMs), so a kernel is classed by the operators
open on the host when it was launched: every operator of a class, forward
and backward, is named in the lists below.
"""

from __future__ import annotations

from . import trace as tr

CONV_OPS = ("aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
            "aten::convolution_backward", "aten::cudnn_convolution_backward")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear",
              "aten::einsum")


def traced(run) -> bool:
    """Whether the run has a device trace with something in its window."""
    t = run.trace
    return t is not None and t.window_us > 0 and bool(t.ops)


def idle_pct(run) -> float | None:
    if not traced(run):
        return None
    return 100.0 * (1.0 - tr.busy_us(run.trace) / run.trace.window_us)


def device_ms(run, op_names, exclude=()) -> float | None:
    """Device milliseconds in which an operation launched under one of
    ``op_names`` (and under none of ``exclude``) ran: the union of their
    intervals, so kernels that overlap on two streams count once."""
    t = run.trace
    if t is None:
        return None
    ops = tr.ops_under(t, op_names)
    if exclude:
        skip = set(tr.ops_under(t, exclude))
        ops = [o for o in ops if o not in skip]
    return tr.union_us([(a, b) for _, a, b in ops]) * 1e-3 if ops else None


def share_pct(run, least_s_each: float, count: int) -> float | None:
    """100 x the least time of ``count`` pieces of work over the traced window."""
    if not traced(run) or count <= 0:
        return None
    return 100.0 * least_s_each * count / (run.trace.window_us * 1e-6)
