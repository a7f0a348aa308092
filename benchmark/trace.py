"""The device trace of a traced window, reduced to what the per-layer
metrics read.

A traced run profiles its measured window with ``torch.profiler`` (host
and device activity), writes the Chrome trace under ``TMPDIR``, reads it
back into a :class:`Trace` and deletes the file. Times are microseconds on
the profiler's clock, which host and device events share.

- device operations: kernels, copies and fills (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), each with its launch's correlation id;
- ranges: the benchmark's own ``record_function`` ranges on the host
  (``window`` around the measured window; ``traffic``, ``stage``,
  ``step``, ``encode``, ``readback`` around what it does; the metrics'
  entry ranges, such as ``k1`` around the nearest-code entry);
- callers: for each launch, the names of the host ranges and PyTorch
  operators (``aten::mm``, ``aten::convolution_backward``, ...) open on
  its thread when it was made, which say what a device operation was for.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGES = ("traffic", "stage", "step", "encode", "readback")


@dataclass
class Trace:
    ops: list = field(default_factory=list)  # (name, ts, dur, correlation)
    ranges: list = field(default_factory=list)  # (name, ts, dur)
    callers: dict = field(default_factory=dict)  # correlation -> names of the host spans around its launch
    t0: float = 0.0
    t1: float = 0.0

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def window_ops(self) -> list:
        """Device operations clipped to the window: (name, start, end)."""
        out = []
        for name, ts, dur, _ in self.ops:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b > a:
                out.append((name, a, b))
        return out


def from_events(events: list) -> Trace:
    """A Trace from Chrome trace events; the window is the ``window`` range."""
    tr = Trace()
    spans: dict = {}  # thread -> [(ts, end, name)] of operators and ranges
    calls: dict = {}  # thread -> [(ts, correlation)] of launches
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        thread = (e.get("pid"), e.get("tid"))
        if cat in DEVICE_CATS:
            tr.ops.append((e["name"], ts, dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            calls.setdefault(thread, []).append((ts, args["correlation"]))
        elif cat in ("cpu_op", "user_annotation"):
            spans.setdefault(thread, []).append((ts, ts + dur, e["name"]))
            if cat == "user_annotation":
                tr.ranges.append((e["name"], ts, dur))
    for thread, launches in calls.items():
        tr.callers.update(_covering(sorted(spans.get(thread, [])), sorted(launches)))
    windows = [r for r in tr.ranges if r[0] == "window"]
    if windows:
        _, ts, dur = max(windows, key=lambda r: r[2])
        tr.t0, tr.t1 = ts, ts + dur
    return tr


def _covering(spans: list, launches: list) -> dict:
    """correlation -> names of the spans that were open at its launch."""
    out, active, k = {}, [], 0
    for t, corr in launches:
        while k < len(spans) and spans[k][0] <= t:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s[1] >= t]
        out[corr] = tuple(s[2] for s in active)
    return out


def union_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def busy_us(tr: Trace) -> float:
    """Window time in which some operation ran on the device."""
    return union_us([(a, b) for _, a, b in tr.window_ops()])


def idle_gaps(tr: Trace) -> list:
    """Gaps of the window with nothing on the device: (start, length)."""
    gaps, cur = [], tr.t0
    for a, b in sorted((a, b) for _, a, b in tr.window_ops()):
        if a > cur:
            gaps.append((cur, a - cur))
        cur = max(cur, b)
    if tr.t1 > cur:
        gaps.append((cur, tr.t1 - cur))
    return gaps


def host_label(tr: Trace, t: float) -> str:
    """The innermost of the benchmark's host ranges open at ``t``."""
    best = None
    for name, ts, dur in tr.ranges:
        if name in HOST_RANGES and ts <= t < ts + dur and (best is None or ts > best[1]):
            best = (name, ts)
    return best[0] if best else "other"


def ops_under(tr: Trace, names) -> list:
    """Window device operations launched inside a host span whose name is
    in ``names`` (an operator such as ``aten::mm``, or a range)."""
    names = set(names)
    out = []
    for op_name, ts, dur, corr in tr.ops:
        if names.intersection(tr.callers.get(corr, ())):
            a, b = max(ts, tr.t0), min(ts + dur, tr.t1)
            if b > a:
                out.append((op_name, a, b))
    return out


def device_us(ops: list) -> float:
    return sum(b - a for _, a, b in ops)


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by host range, in seconds: the result line's ``breakdown``."""
    by_name: dict = {}
    for name, a, b in tr.window_ops():
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(idle_gaps(tr), key=lambda g: -g[1])[:n]
    return {"device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": [[host_label(tr, a), d * 1e-6] for a, d in gaps]}


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """Profile the body when ``enabled``; yields a holder whose ``trace``
    is set once the body has ended."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        yield holder
    if cuda:
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.trace = from_events(events)
