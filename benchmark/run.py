"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the program (``vector_quantization_tpu_torch``). Set-up builds the
cell's program, weights and traffic from the seed and warms its shapes;
the window runs for ``--seconds``; the reference then judges what the
window's path produced. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from
the window's device trace), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with its limit, which also end
standard error. Without a CUDA card, without the program, or with JAX
loaded once the window has closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="makes the weights and the traffic")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a device trace")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if importlib.util.find_spec("vector_quantization_tpu_torch") is None:
        print("the program (vector_quantization_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, detail = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", ROOT,
                                      T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, text in detail.items():
        print(f"detail {name}: {text}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
