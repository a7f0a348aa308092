"""host_stall_ms.vqgan_train: device-idle ms a step whose gap begins while
the host is inside the program's span ``vq.train_step``; the device waits
on the host there, since the step makes no explicit sync. Also prints on
standard error the split of that time by the innermost ``vq.`` span open
at each gap's start (``none``: inside the step, outside its phases)."""

import sys

from benchmark import readers, spans

NAME = "host_stall_ms.vqgan_train"


def read(run):
    steps = run.counters.get("steps", 0)
    if not readers.traced(run) or not steps:
        return None
    split = spans.stalls(run.trace)
    if not split:
        return None
    parts = [f"{k} {us * 1e-3 / steps:.3f} ({n} gaps, {long} of 1 ms or more)"
             for k, (us, n, long) in sorted(split.items(), key=lambda kv: -kv[1][0])]
    print(f"{NAME} by span (ms a step over {steps} steps): " + ", ".join(parts), file=sys.stderr)
    return sum(v[0] for v in split.values()) * 1e-3 / steps
