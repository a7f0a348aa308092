#!/usr/bin/env python3
"""Where K4-fwd's time goes: the kernel and three cut-down copies of it.

Usage: python3 flash_fwd_probe.py [--reps 40] [--seed 0]

Builds ``vector_quantization_tpu_torch/csrc/flash_attention.cu`` as it is
and three copies with parts of the forward cut out by text substitution,
with the flags of ``ops/_build.py``:

- ``no_products``: no score, softmax or P V work (loads, waits, stores);
- ``no_loads``: no TMA loads and no waits on them (products on whatever
  shared memory holds, and stores);
- ``loads_only``: no products and no stores.

Each is timed at the training shape (B, T, H, Dh) = (64, 257, 16, 64) bf16
with CUDA events around ``--reps`` back-to-back launches, after a warm-up,
in three rounds of alternating order. Prints one JSON line per variant
(microseconds per launch for each round), then the ``nvidia-smi`` name and
power limit. The unmodified kernel is checked against the plain version;
the cut copies compute garbage, and only their times mean anything. Exits
non-zero without a CUDA device or if a substitution no longer matches the
source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vector_quantization_tpu_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "vector_quantization_tpu_torch" / "_kernels_build" / "probe"
SHAPE = (64, 257, 16, 64)

NO_PRODUCTS = [("fwd_scores<DH, L>(sc,", "if (0) fwd_scores<DH, L>(sc,"),
               ("fwd_softmax_pv<DH, L>(st,", "if (0) fwd_softmax_pv<DH, L>(st,")]
NO_LOADS = [("mbar_wait(full + 8 * s,", "if (0) mbar_wait(full + 8 * s,"),
            ("mbar_wait(qfull + 8 * g,", "if (0) mbar_wait(qfull + 8 * g,"),
            ("    tma_tile<DH>(", "    if (0) tma_tile<DH>("),
            ("mbar_expect_tx(qfull", "if (0) mbar_expect_tx(qfull"),
            ("mbar_expect_tx(full", "if (0) mbar_expect_tx(full")]
NO_STORES = [("fwd_store<DH>(ob, lb, st,", "if (0) fwd_store<DH>(ob, lb, st,")]
VARIANTS = {"kernel": [], "no_products": NO_PRODUCTS, "no_loads": NO_LOADS,
            "loads_only": NO_PRODUCTS + NO_STORES}


def cut(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"probe: {old!r} is no longer in the source")
        src = src.replace(old, new)
    return src


def build(src: str, variants: dict, out: Path) -> dict:
    """Every variant of ``src`` (name -> text substitutions) compiled with the
    flags of ``ops/_build.py``, all at once: {name: (library, nvcc log)}."""
    from vector_quantization_tpu_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pairs in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(cut(src, pairs))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out / f"lib{name}.so")), log)
    return libs


def entry(lib, name: str, n_ptr: int):
    """A flash C entry: ``n_ptr`` pointers, B, T, H, Dh, scale, stream."""
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype, fn.argtypes = i, [p] * n_ptr + [i] * 4 + [ctypes.c_float, p]
    return fn


def time_rounds(fns: dict, launch, reps: int) -> dict:
    """Microseconds per launch of each of ``fns``: CUDA events around
    ``reps`` back-to-back ``launch(fn)`` after a warm-up, in three rounds
    of alternating order."""
    def timed(fn) -> float:
        for _ in range(3):
            launch(fn)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            launch(fn)
        e1.record()
        e1.synchronize()
        return 1e3 * e0.elapsed_time(e1) / reps

    times = {name: [] for name in fns}
    for rnd in range(3):
        for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            times[name].append(timed(fns[name]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vector_quantization_tpu_torch.ops import flash_attention as fa

    fns = {name: entry(lib, "vqt_flash_fwd", 5)
           for name, (lib, _) in build(SOURCE.read_text(), VARIANTS, OUT).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, t, h, dh = SHAPE
    q, k, v = [torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn) -> None:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 b, t, h, dh, dh ** -0.5, stream)
        if err != 0:
            raise SystemExit(f"flash_fwd_probe: launch failed, CUDA error {err}")

    launch(fns["kernel"])
    ro, rl = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = fa.excess_over_bf16_step(o, ro)
    lse_err = float((lse - rl).abs().max())
    if err > 2e-3 or lse_err > 1e-4:
        raise SystemExit(f"flash_fwd_probe: the kernel disagrees with the plain version "
                         f"(o {err}, lse {lse_err})")
    for name, us in time_rounds(fns, launch, args.reps).items():
        print(json.dumps({"variant": name, "shape": list(SHAPE), "us_per_launch": us,
                          "reps": args.reps}), flush=True)
    print(json.dumps({"kernel_o_err_beyond_one_bf16_step": err, "kernel_lse_max_abs_err": lse_err}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
