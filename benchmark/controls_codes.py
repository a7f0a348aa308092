"""Readings that set the upper end of each limit of the code-grid cells
(``drivers/train_ar_codes.py``): the control and the faults, at a cell's
own sizes, on the card, for several seeds in one process.

    python3 benchmark/controls_codes.py --workload <cell> --seeds 11 12 13 [--out FILE]

For each seed the reference trains the checked steps in float32 with TF32
off (the truth the benchmark judges by) and again in the program's place
as

- ``control``: the reference in TF32, the precision below the float32 the
  configurations state (the DeepSeek prior's truth follows its routes
  within the cell's ``route_gap``, as it follows the program's);
- ``half_batch``: half of each batch left out, the mean taken over the
  rest;
- ``altered_code`` (GPT-2): one code of the first step changed where the
  tokens are made;
- ``altered_route`` (DeepSeek-V3): one token's choice of the first MoE
  layer of the first step changed where the router chooses.

A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by their
definition and needs no run. Each reading is one JSON line: the cell, the
seed, the reading's name and its numbers, named as the cell's checks. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _altered(routes: list, experts: int) -> list:
    """The routes with the first token's first choice of the first layer of
    the first step moved to an expert it did not choose."""
    out = [[r.clone() for r in step] for step in routes]
    row = out[0][0][0]
    row[0] = next(e for e in range(experts) if e not in set(row.tolist()))
    return out


def readings(workload: str, seed: int, device: str = "cuda", root: Path = ROOT) -> list[dict]:
    from benchmark import codes, harness
    from benchmark.reference import codes_steps as ref

    import torch

    bench = root / "benchmark"
    w = harness.load_json(bench / "workloads" / f"{workload}.json")
    cfg = harness.load_json(bench / "configs" / f"{w['config']}.json")
    traffic = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
    driver = harness.load_module(bench / "drivers" / f"{w['driver']}.py", f"bench_driver_{w['driver']}")
    harness.prepare_torch()
    dev = torch.device(device)
    n = int(w["check_steps"])
    pool = codes.make_pool(traffic, seed, 0.0, pin=False)
    items = [(pool.images[i], pool.labels[i]) for i in range(n)]
    tol = float(w["limits"].get("route_gap", 0.0))
    deep = ref.is_deepseek(cfg)
    truth = ref.run(cfg, seed, dev, items)
    out = []

    def reading(name, program, reference):
        got = driver.checks({**program, "token_gap": 0, "bias": program.get("bias", [])}, reference, cfg)[0]
        out.append({"workload": workload, "seed": seed, "reading": name, **got})

    control = ref.run(cfg, seed, dev, items, tf32=True)
    control_truth = ref.run(cfg, seed, dev, items, control.get("routes"), tol) if deep else truth
    reading("control", control, control_truth)
    reading("half_batch", ref.run(cfg, seed, dev, items, half=True), truth)
    if deep:
        altered = _altered(truth["routes"], cfg["router_experts"])
        program = ref.run(cfg, seed, dev, items, altered, force=True)
        reading("altered_route", program, ref.run(cfg, seed, dev, items, altered, tol))
    else:
        changed = [(c.clone(), lab) for c, lab in items]
        flat = changed[0][0].view(-1)
        flat[0] = (flat[0] + 7) % int(traffic["codebook_size"])
        program = ref.run(cfg, seed, dev, changed)
        got = driver.checks({**program, "token_gap": 1}, truth, cfg)[0]
        out.append({"workload": workload, "seed": seed, "reading": "altered_code", **got})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    lines = []
    for seed in args.seeds:
        for r in readings(args.workload, seed):
            print(json.dumps(r), flush=True)
            lines.append(r)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
