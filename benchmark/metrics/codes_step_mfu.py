"""codes_step_mfu: the least time of the traced window's steps on code
grids (their operations from ``benchmark/flops_codes.py`` at 989 TFLOP/s,
or their bytes at 3.35 TB/s) over the traced window, in %. The DeepSeek-V3
prior's steps are counted on the rows its held experts took in the window
(the program's counters)."""

from benchmark import flops, flops_codes, readers


def read(run):
    if not readers.traced(run):
        return None
    c, tr, n = run.cell.config, run.cell.traffic, run.counters.get("steps", 0)
    b, t = int(tr["batch"]), 1 + int(tr["grid"]) ** 2
    if c.get("model_type") == "deepseek_v3":
        if "expert_rows" not in run.counters:
            return None
        rows = sum(sum(layer) for layer in run.counters["expert_rows"])
        f, nbytes = flops_codes.deepseek_step(c, b, t, 0)
        total_f = n * f + 3 * 2 * rows * flops_codes.deepseek_forward_macs(c, t)[1]
        return readers.share_pct(run, flops.least_s(total_f, n * nbytes), 1)
    f, nbytes = flops_codes.gpt2_step(c, b, t)
    return readers.share_pct(run, flops.least_s(f, nbytes), n)
