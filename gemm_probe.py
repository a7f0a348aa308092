#!/usr/bin/env python3
"""GPT-2's f32 products through the split-TF32 kernel against cuBLAS f32, on the card.

Usage: python3 gemm_probe.py [--root DIR] [--seed 0] [--replays 5] [--rows 16448] [--sweeps | --swap]

Imports ``vector_quantization_tpu_torch`` from ``--root`` (default: this
script's directory), so that one call can time two versions of the kernel
in turn. Builds the tree's ``csrc/f32_gemm.cu`` (its ptxas lines are
printed) and, at GPT-2-medium's 15 products of a training step at
``--rows`` rows (64 x 257: ``c_attn`` 1024 -> 3072, ``c_proj`` 1024 ->
1024, ``mlp_fc`` 1024 -> 4096, ``mlp_proj`` 4096 -> 1024, each forward
``x @ w``, input gradient ``gy @ w.T`` and weight gradient ``x.T @ gy``,
and the tied head 1024 -> 17384: ``h @ wte.T``, ``gy @ wte``,
``gy.T @ h``), prints one JSON line a product with:

- the error against a float64 product, max|got - ref| / max|ref|, of the
  kernel (``ops/f32_gemm.py`` ``matmul``), of ``torch.mm`` in f32 (cuBLAS
  on the CUDA cores) and of ``torch.mm`` in TF32 (``allow_tf32``, the
  control), on N(0, 1) operands;
- milliseconds per call by CUDA-graph replay (``chip_smoke.graph_ms``),
  kernel and ``torch.mm`` f32 in turns (kernel, mm, mm, kernel): the mm is
  what the port ran before;
- the call's device kernels and their times (``torch.profiler``): the
  prologue that splits B, the product, the sum of split-K parts.

With ``--sweeps`` it then builds copies of the source at each
``PROMOTE`` in ``PROMOTES`` (stages of 32 summed on the tensor cores
before their sum joins the f32 accumulator; 2^20: once a tile), all at
once, and prints, for the weight gradients (the sums over ``--rows``) and
the forwards, each copy's error and time through the wrapper's own launch;
and for the four forwards the kernel's time against ``torch.mm`` at 128 ... 8192 rows
(where ``MIN_ROWS`` comes from).

With ``--swap`` it prints only, for each product whose plan swaps the
operands (``plan(...).swap``: the weight gradients of ``c_attn`` and
``mlp_fc``), its time through the wrapper with the shipped plan and with
the same plan unswapped (``a`` read as it lies, ``b`` split), the prologue
included, in the order shipped, unswapped, unswapped, shipped, twice; and
each one's error against float64. Ends with the ``nvidia-smi`` name and
power limit. Exits non-zero without a CUDA device or where the kernel's
error exceeds 4x cuBLAS f32's.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import GPT2_DENSE as LAYERS
from chip_smoke import gpt2_operands as operands
from chip_smoke import gpt2_products as products
from chip_smoke import graph_ms

PROMOTES = (1, 2, 4, 8, 1 << 20)
SWEEP_ROWS = (128, 256, 512, 1024, 2048, 4096, 8192)


def rel_err(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def tf32_mm(a, b):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def device_kernels(fn) -> list:
    """[kernel name, device ms] of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.name[:60], round(e.device_time_total * 1e-3, 4)] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def timed(fns: dict, replays: int) -> dict:
    """ms per call of each of ``fns`` by graph replay, in the order a, b, b, a."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(round(graph_ms([fns[k]], replays), 4))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replays", type=int, default=5)
    p.add_argument("--rows", type=int, default=64 * 257)
    p.add_argument("--sweeps", action="store_true")
    p.add_argument("--swap", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from vector_quantization_tpu_torch.ops import _build
    from vector_quantization_tpu_torch.ops import f32_gemm as fg

    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log = _build.build_all()["f32_gemm"]
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln or "Compiling entry" in ln
                                or "arning" in ln]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sms = fg.card(dev).sms
    bad = []
    for spec in products(args.rows) if not args.swap else ():
        a, b = operands(spec, gen, dev)
        ref = a.double() @ b.double()
        got = fg.matmul(a, b)
        row = {"product": spec[0], "M": a.shape[0], "K": a.shape[1], "N": b.shape[1],
               "plan": fg.plan(a.shape[0], a.shape[1], b.shape[1], sms)._asdict(),
               "err_kernel": rel_err(got, ref), "err_cublas_f32": rel_err(torch.mm(a, b), ref),
               "err_tf32": rel_err(tf32_mm(a, b), ref)}
        row["kernel_over_cublas"] = row["err_kernel"] / row["err_cublas_f32"]
        row["kernel_over_tf32"] = row["err_kernel"] / row["err_tf32"]
        del ref, got
        row.update({f"{k}_ms": v for k, v in timed({"kernel": lambda: fg.matmul(a, b),
                                                     "mm": lambda: torch.mm(a, b)}, args.replays).items()})
        row["kernels"] = device_kernels(lambda: fg.matmul(a, b))
        row["tflops_kernel"] = 2 * a.shape[0] * a.shape[1] * b.shape[1] / min(row["kernel_ms"]) * 1e-9
        print(json.dumps(row), flush=True)
        if row["kernel_over_cublas"] > 4:
            bad.append(spec[0])
        del a, b
        torch.cuda.empty_cache()
    if args.sweeps:
        from flash_fwd_probe import build

        root = Path(args.root).resolve() / "vector_quantization_tpu_torch"
        src = (root / "csrc" / "f32_gemm.cu").read_text()
        line = re.search(r"constexpr int PROMOTE = \d+;", src).group(0)
        libs = build(src, {q: [(line, f"constexpr int PROMOTE = {q};")] for q in PROMOTES},
                     root / "_kernels_build" / "gemm_probe")
        shipped = fg._functions
        for spec in products(args.rows):
            if not spec[0].endswith((".dw", ".dwte", ".fwd")):
                continue
            a, b = operands(spec, gen, dev)
            ref = a.double() @ b.double()
            row = {"sweep": "promote", "product": spec[0]}
            for q, (lib, _) in libs.items():
                fg._functions = lambda lib=lib: fg._bind(lib)
                row[f"err_{q}"] = rel_err(fg.matmul(a, b), ref)
                row[f"ms_{q}"] = timed({"kernel": lambda: fg.matmul(a, b)}, args.replays)["kernel"]
            fg._functions = shipped
            print(json.dumps(row), flush=True)
            del a, b, ref
            torch.cuda.empty_cache()
        for name, k, n in LAYERS:
            for rows in SWEEP_ROWS:
                a = torch.randn((rows, k), generator=gen, device=dev)
                b = torch.randn((k, n), generator=gen, device=dev)
                t = timed({"kernel": lambda: fg.matmul(a, b), "mm": lambda: torch.mm(a, b)}, args.replays)
                print(json.dumps({"sweep": "rows", "layer": name, "rows": rows, "kernel_ms": t["kernel"],
                                  "mm_ms": t["mm"]}), flush=True)
    if args.swap:
        shipped = fg.plan

        def unswapped(m, k, n, sms):
            p = shipped(m, k, n, sms)
            tiles = -(-m // fg._BM) * -(-n // fg._BN) * p.splits
            return p._replace(swap=False, tiles=tiles, blocks=min(tiles, sms))

        def through(plan_fn, a, b):
            fg.plan = plan_fn
            try:
                return fg.matmul(a, b)
            finally:
                fg.plan = shipped

        for spec in products(args.rows):
            _, (ra, ca), (rb, cb), how = spec
            m, k, n = (ca, ra, cb) if how == "a.T" else (ra, ca, cb if how != "b.T" else rb)
            if not shipped(m, k, n, sms).swap:
                continue
            a, b = operands(spec, gen, dev)
            ref = a.double() @ b.double()
            row = {"sweep": "swap", "product": spec[0], "M": m, "K": k, "N": n,
                   "err_shipped": rel_err(through(shipped, a, b), ref),
                   "err_unswapped": rel_err(through(unswapped, a, b), ref)}
            del ref
            fns = {"shipped": lambda: through(shipped, a, b), "unswapped": lambda: through(unswapped, a, b)}
            t1, t2 = timed(fns, args.replays), timed(fns, args.replays)
            row.update({f"{key}_ms": t1[key] + t2[key] for key in fns})
            row["kernels_unswapped"] = device_kernels(fns["unswapped"])
            print(json.dumps(row), flush=True)
            del a, b
            torch.cuda.empty_cache()
    print(json.dumps({"launches": fg.matmul.launches, "split_launches": fg.matmul.split_launches}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if bad:
        print(f"gemm_probe: error above 4x cuBLAS f32's at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
