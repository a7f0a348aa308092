"""The program's own spans in a traced window, as the per-layer metrics read them.

The port marks its phases with ``record_function`` ranges named ``vq.*``
(``utils/debug.py`` ``span``: ``vq.train_step``, ``vq.backward``,
``vq.optimizer``, ...), recorded only while a profiler records. They are
in the trace's ``ranges`` and in each launch's ``callers``, beside the
benchmark's own ranges.

A backward's kernels are launched by autograd's engine on a thread of its
own, which holds none of the calling thread's spans: its launches' callers
are ``autograd::engine::evaluate_function: ...`` frames, or nothing. Such a
launch takes the ``vq.`` spans of the nearest launch before it, in
correlation order, that a thread with spans made: the caller blocks in
``torch.autograd.grad`` until the engine is done, and ``grad`` launches its
seed's fill on the calling thread, inside the caller's span, before the
engine starts. CUPTI numbers the runtime calls of all threads from one
counter, so the order of the correlation ids is the order of the launches
(on an H100: ``benchmark/tests/test_bench_spans.py``'s card test, and no
inversion among the ~500k runtime calls of a traced VQGAN window).
"""

from __future__ import annotations

from . import trace as tr

PREFIX = "vq."
STEP = "vq.train_step"
ENGINE = "autograd::engine::evaluate_function"


def chains(t) -> dict:
    """correlation -> the ``vq.`` spans open at its launch, outermost first
    (a launch of autograd's engine: those of the launch it follows)."""
    out, last = {}, ()
    for corr in sorted(c for c in t.callers if c is not None):
        names = t.callers[corr]
        own = tuple(n for n in names if n.startswith(PREFIX))
        if own or (names and not any(n.startswith(ENGINE) for n in names)):
            last = own
        out[corr] = last
    return out


def ops_in(t, name: str, chain: dict | None = None) -> list:
    """Window device operations launched inside the span ``name``, its
    backward included: (name, start, end)."""
    chain = chains(t) if chain is None else chain
    out = []
    for op_name, ts, dur, corr in t.ops:
        if name in chain.get(corr, ()):
            a, b = max(ts, t.t0), min(ts + dur, t.t1)
            if b > a:
                out.append((op_name, a, b))
    return out


def device_ms(run, name: str) -> float | None:
    """Device milliseconds in which an operation launched inside the span
    ``name`` ran (the union of their intervals); None: no such operation."""
    t = run.trace
    if t is None:
        return None
    ops = ops_in(t, name)
    return tr.union_us([(a, b) for _, a, b in ops]) * 1e-3 if ops else None


def ms_a_step(run, name: str) -> float | None:
    ms = device_ms(run, name)
    steps = run.counters.get("steps", 0)
    return ms / steps if ms is not None and steps else None


def open_at(ranges: list, times: list) -> list:
    """For each of ``times`` (ascending), the ``vq.`` ranges open at it
    (``ts <= t < ts + dur``), outermost first."""
    spans = sorted((ts, ts + dur, name) for name, ts, dur in ranges if name.startswith(PREFIX))
    out, active, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s[1] > t]
        out.append(tuple(s[2] for s in active))
    return out


def stalls(t) -> dict:
    """Idle gaps of the window that begin while the host is inside a train
    step, by the innermost ``vq.`` span open at their start (``none``: the
    step itself): {span: [microseconds, gaps, gaps of 1 ms or more]}."""
    gaps = tr.idle_gaps(t)
    out: dict = {}
    for (start, length), names in zip(gaps, open_at(t.ranges, [g[0] for g in gaps])):
        if STEP not in names:
            continue
        key = names[-1] if names[-1] != STEP else "none"
        row = out.setdefault(key, [0.0, 0, 0])
        row[0] += length
        row[1] += 1
        row[2] += length >= 1e3
    return out

