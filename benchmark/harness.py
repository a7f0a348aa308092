"""Runs one cell once and builds its result line.

Everything a cell is made of is found by name under ``benchmark/``:

- ``workloads/<cell>.json``: the configuration's and the traffic's names,
  the driver's name, the numbers compared with the reference and their
  limits;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic generator's parameters;
- ``drivers/<driver>.py``: a module with ``run(cell) -> dict`` (set-up,
  the measured window, the check against the reference);
- ``metrics/<metric>.py``: a module with ``read(run) -> float | None`` for
  every metric that ``BENCHMARK.json`` names, and optionally ``RANGES``,
  host ranges that traced runs put around entries of the program
  (``{range: (module, attribute)}``).

``BENCHMARK.json``, at the root of the checkout, says which metrics a cell
reports: its ``end_to_end`` metrics with ``--trace 0``, its ``per_layer``
ones with ``--trace 1``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vector_quantization_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """What a driver is given: the cell's files, the run's arguments, and
    the host ranges it marks what it does with."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    ranges: dict = field(default_factory=dict)  # traced runs: {range: (module, attribute)}
    calls: dict = field(default_factory=dict)  # range -> shapes of the window's calls
    marks: list = field(default_factory=list)  # (set-up phase, host seconds since the start)
    notes: dict = field(default_factory=dict)  # more lines for standard error

    def mark(self, phase: str) -> None:
        """Note the end of a set-up phase (reported on standard error)."""
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def range(self, name: str):
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def entry_ranges(self):
        """In traced runs, put each declared range around its entry of the
        program for the body's duration, and record the shapes of its calls."""
        patched = []
        try:
            for rname, (modname, attr) in self.ranges.items():
                mod = importlib.import_module(modname)
                orig = getattr(mod, attr)
                log = self.calls.setdefault(rname, [])

                def wrapper(*args, _orig=orig, _rname=rname, _log=log, **kwargs):
                    _log.append([tuple(a.shape) for a in args if hasattr(a, "shape")])
                    with self.range(_rname):
                        return _orig(*args, **kwargs)

                wrapper.__dict__.update(orig.__dict__)
                setattr(mod, attr, wrapper)
                patched.append((mod, attr, orig, wrapper))
            yield
        finally:
            for mod, attr, orig, wrapper in reversed(patched):
                orig.__dict__.update({k: v for k, v in wrapper.__dict__.items() if k in orig.__dict__})
                setattr(mod, attr, orig)


@dataclass
class Run:
    """A finished run as the metric readers see it."""

    cell: Cell
    setup_s: float
    window_s: float
    counters: dict
    trace: object = None


def metrics_for(spec: dict, cell: str, traced: bool) -> list[dict]:
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def prepare_torch() -> None:
    """float32 as the configurations state it: no TF32 anywhere, no autotuning."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(4)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path | None = None, t_start: float | None = None) -> tuple[dict, dict]:
    """One run of cell ``name``: the result line's object, and the driver's
    account of its widest gaps (for standard error). ``root``: the
    checkout (``BENCHMARK.json`` and ``benchmark/``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = BENCH.parent if root is None else Path(root)
    bench = root / BENCH.name
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SystemExit(f"{name}: BENCHMARK.json's {key} {entry[key]!r}, the workload file's {workload[key]!r}")
    config = load_json(bench / "configs" / f"{workload['config']}.json")
    traffic = load_json(bench / "traffic" / f"{workload['traffic']}.json")
    wanted = metrics_for(spec, name, trace)
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
               for m in wanted}

    prepare_torch()
    import torch

    dev = torch.device(device)
    cell = Cell(name, workload, config, traffic, int(seed), float(seconds), bool(trace), dev, t_start)
    if trace:
        for r in readers.values():
            cell.ranges.update(getattr(r, "RANGES", {}))
    driver = load_module(bench / "drivers" / f"{workload['driver']}.py", f"bench_driver_{workload['driver']}")
    out = driver.run(cell)

    run = Run(cell, out["setup_s"], out["window_s"], out["counters"], out.get("trace"))
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = workload["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in out["checks"].items()}
    missing = sorted(set(limits) - set(checks))
    correct = (not missing and out["attempted"] > 0 and out["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    if dev.type == "cuda":
        kind, platform, count = torch.cuda.get_device_name(dev), "gpu", 1
    else:
        kind, platform, count = "cpu", "cpu", 1
    device_info = {"platform": platform, "kind": kind, "count": count,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        from . import trace as tr

        device_info["busy_s"] = tr.busy_us(run.trace) * 1e-6
        device_info["window_s"] = run.trace.window_us * 1e-6
        result["breakdown"] = tr.breakdown(run.trace)
    if missing:
        checks.update({k: {"value": float("nan"), "limit": float(limits[k])} for k in missing})
    result["checks"] = checks
    detail = {"setup": ", ".join(f"{p} {t:.2f}" for p, t in cell.marks), **cell.notes, **out.get("detail", {})}
    return result, detail
