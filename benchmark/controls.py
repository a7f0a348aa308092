"""Readings that set the upper end of each limit: the control and the
faults, at a cell's own sizes, on the card, for several seeds in one
process.

    python3 benchmark/controls.py --workload <cell> --seeds 11 12 13 [--out FILE]

For each seed, the reference runs in float32 with TF32 off (the truth the
benchmark judges by) and again in its place as

- ``control``: the reference in TF32, the precision below the float32
  the configurations state;
- ``half_batch`` (training cells): half of each batch left out, the mean
  taken over the rest;
- ``altered_code``: one code of the truth's changed where it is produced
  (read without a run).

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


def _altered(codes: list, k: int) -> list:
    out = [c.clone() for c in codes]
    flat = out[0].reshape(-1)
    flat[0] = (flat[0] + k // 2) % k
    return out


def readings(workload: str, seed: int, device: str = "cuda", root: Path = ROOT) -> list[dict]:
    from benchmark import harness, traffic as tf
    from benchmark.reference import steps as ref

    import torch

    bench = root / "benchmark"
    w = harness.load_json(bench / "workloads" / f"{workload}.json")
    cfg = harness.load_json(bench / "configs" / f"{w['config']}.json")
    traffic = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
    driver = harness.load_module(bench / "drivers" / f"{w['driver']}.py", f"bench_driver_{w['driver']}")
    harness.prepare_torch()
    dev = torch.device(device)
    seconds = int(w.get("sampled_images", 0)) / float(traffic["items_per_second"])
    pool = tf.make_pool(traffic, seed, seconds, pin=False)
    out = []
    if w["driver"] == "train_ar":
        n = int(w["check_steps"])
        items = [(pool.images[i], pool.labels[i]) for i in range(n)]
        images = [pool.images[i] for i in range(n)]
        truth = ref.ar_run(cfg, seed, dev, items, images)
        k = cfg["ir"]["codebook_size"]
        for name, kw in (("control", {"tf32": True}), ("half_batch", {"half": True})):
            other = ref.ar_run(cfg, seed, dev, items, images, **kw)
            codes = other["codes"] if name == "control" else truth["codes"]
            out.append((name, driver.checks(other, truth, codes)[0]))
        out.append(("altered_code", driver.checks(truth, truth, _altered(truth["codes"], k))[0]))
    elif w["driver"] == "train_vqgan":
        items = [(pool.images[i], pool.labels[i]) for i in range(int(w["check_steps"]))]
        truth = ref.vqgan_run(cfg, seed, dev, items)
        for name, kw in (("control", {"tf32": True}), ("half_batch", {"half": True})):
            other = ref.vqgan_run(cfg, seed, dev, items, **kw)
            codes = other["codes"] if name == "control" else truth["codes"]
            out.append((name, driver.checks({**other, "codes": codes}, truth)[0]))
        out.append(("altered_code", driver.checks({**truth, "codes": _altered(truth["codes"], cfg["codebook_size"])},
                                                  truth)[0]))
    elif w["driver"] == "export":
        size = int(traffic["crop"])
        crops = [torch.from_numpy(driver.ten_crop(pool.images[i][0].numpy(), size).copy())
                 for i in range(len(pool))]
        weights = ref.ir_weights(cfg, seed, dev)
        feats, codes, e = ref.encode(cfg, weights, dev, crops)
        _, low, _ = ref.encode(cfg, weights, dev, crops, tf32=True)
        out.append(("control", driver.checks(low, feats, e)[0]))
        out.append(("altered_code", driver.checks(_altered(codes, cfg["codebook_size"]), feats, e)[0]))
        out.append(("half_batch", driver.checks([c[: c.shape[0] // 2] for c in codes], feats, e)[0]))
    else:
        raise SystemExit(f"no controls for driver {w['driver']!r}")
    return [{"workload": workload, "seed": seed, "reading": name, **vals} for name, vals in out]


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
