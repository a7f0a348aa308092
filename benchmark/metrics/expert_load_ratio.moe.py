"""expert_load_ratio.moe: over the window, the most rows any held expert of
any MoE layer took over the mean of all held experts and layers (the
program's counters): 1 where the router spread the tokens evenly."""


def read(run):
    rows = [r for layer in run.counters.get("expert_rows", []) for r in layer]
    mean = sum(rows) / len(rows) if rows else 0
    return max(rows) / mean if mean else None
