"""Device time of the DeepSeek-V3 prior's parts in a traced window, forward
and backward.

The forward's launches are the calling thread's, inside the program's
``vq.`` spans (``benchmark/spans.py``). The backward runs on autograd's
thread, which holds none of them; the program names it with ranges of its
own (``utils/debug.py`` ``BackwardRange``: ``mla.backward``,
``moe.backward``, ``moe.experts.backward``, ``moe.shared.backward``),
read on the launch's own thread (``readers``).
"""

from __future__ import annotations

from . import spans, trace as tr


def part_ops(run, forward: tuple, backward: tuple, backward_exclude: tuple = ()) -> list:
    """Window device operations launched inside one of the ``forward``
    spans, or inside one of the ``backward`` ranges and none of
    ``backward_exclude``: (name, start, end)."""
    t = run.trace
    chain = spans.chains(t)
    ops = [o for name in forward for o in spans.ops_in(t, name, chain)]
    back = tr.ops_under(t, backward)
    if backward_exclude:
        skip = set(tr.ops_under(t, backward_exclude))
        back = [o for o in back if o not in skip]
    return ops + back


def part_ms(run, forward: tuple, backward: tuple, backward_exclude: tuple = ()) -> float | None:
    """Device ms a step in which one of :func:`part_ops` ran (the union of
    their intervals); None where none ran."""
    steps = run.counters.get("steps", 0)
    if run.trace is None or not steps:
        return None
    ops = part_ops(run, forward, backward, backward_exclude)
    return tr.union_us([(a, b) for _, a, b in ops]) * 1e-3 / steps if ops else None
