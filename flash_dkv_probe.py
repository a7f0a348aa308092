#!/usr/bin/env python3
"""Where K4-dkv's time goes: the kernel, a variant and three cut-down copies.

Usage: python3 flash_dkv_probe.py [--reps 40] [--seed 0]

Builds ``vector_quantization_tpu_torch/csrc/flash_attention.cu`` as it is
and copies changed by text substitution, with the flags of
``ops/_build.py``:

- ``wg2``: two warpgroups per block instead of three (256 threads, one
  block per SM, up to 255 registers a thread);
- ``no_loads``: no TMA loads and no waits on them (products on whatever
  shared memory holds, and stores);
- ``no_products``: no score, exponential or product work (loads, waits,
  stores);
- ``loads_only``: no products and no stores.

Each is timed at the training shape (B, T, H, Dh) = (64, 257, 16, 64) bf16
with CUDA events around ``--reps`` back-to-back launches, after a warm-up,
in three rounds of alternating order. Prints one JSON line per build (the
dK/dV kernel's registers and spills per head dim, from ptxas), one per
variant (microseconds per launch for each round), then the ``nvidia-smi``
name and power limit. The kernel and ``wg2`` are checked against the
plain version (dk, dv within 1e-2 of max(1, max|ref|)); the cut copies
compute garbage, and only their times mean anything. (A copy without the
stores would measure nothing: the compiler drops products whose sums are
never stored.) Exits non-zero without a CUDA device
or if a substitution no longer matches the source.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import ptxas_entries
from flash_fwd_probe import build, entry, time_rounds

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vector_quantization_tpu_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "vector_quantization_tpu_torch" / "_kernels_build" / "dkv_probe"
SHAPE = (64, 257, 16, 64)

WG2 = [("static constexpr int WG = DH <= 64 ? 3 : 2,", "static constexpr int WG = 2,")]
NO_PRODUCTS = [("dkv_tile<DH, L>(dka,", "if (0) dkv_tile<DH, L>(dka,")]
NO_STORES = [("dkv_store<DH>(dk + head,", "if (0) dkv_store<DH>(dk + head,")]
NO_LOADS = [("mbar_wait(kvfull + 8 * g, r & 1);", "if (0) mbar_wait(kvfull + 8 * g, r & 1);"),
            ("mbar_wait(qfull + 8 * s,", "if (0) mbar_wait(qfull + 8 * s,"),
            ("mbar_expect_tx(kvfull + 8 * g, 2 * TILE);", "if (0) mbar_expect_tx(kvfull + 8 * g, 2 * TILE);"),
            ("mbar_expect_tx(bar, 2 * TILE);", "if (0) mbar_expect_tx(bar, 2 * TILE);"),
            ("    tma_tile<DH>(kvbuf + 2 * g * TILE,", "    if (0) tma_tile<DH>(kvbuf + 2 * g * TILE,"),
            ("    tma_tile<DH>(kvbuf + (2 * g + 1) * TILE,", "    if (0) tma_tile<DH>(kvbuf + (2 * g + 1) * TILE,"),
            ("    tma_tile<DH>(qbuf + 2 * s * TILE, mq, bar,", "    if (0) tma_tile<DH>(qbuf + 2 * s * TILE, mq, bar,"),
            ("    tma_tile<DH>(qbuf + (2 * s + 1) * TILE, mdo,", "    if (0) tma_tile<DH>(qbuf + (2 * s + 1) * TILE, mdo,")]
VARIANTS = {"kernel": [], "wg2": WG2, "no_loads": NO_LOADS, "no_products": NO_PRODUCTS,
            "loads_only": NO_PRODUCTS + NO_STORES}
CHECKED = ("kernel", "wg2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_dkv_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vector_quantization_tpu_torch.ops import flash_attention as fa

    fns = {}
    for name, (lib, log) in build(SOURCE.read_text(), VARIANTS, OUT).items():
        fns[name] = entry(lib, "vqt_flash_bwd_dkv", 8)
        print(json.dumps({"variant": name,
                          "ptxas": ptxas_entries(log, "flash_bwd_dkv_kernel")}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, t, h, dh = SHAPE
    q, k, v, do = [torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4)]
    o, lse = fa.flash_attention_fwd(q, k, v)
    di = fa._di(o, do)
    _, rk, rv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn) -> None:
        err = fn(*[x.data_ptr() for x in (q, k, v, do, lse, di, dk, dv)],
                 b, t, h, dh, dh ** -0.5, stream)
        if err != 0:
            raise SystemExit(f"flash_dkv_probe: launch failed, CUDA error {err}")

    errs = {}
    for name in CHECKED:
        launch(fns[name])
        torch.cuda.synchronize()
        errs[name] = max(float((g.float() - r.float()).abs().max()) / max(1.0, float(r.float().abs().max()))
                         for g, r in ((dk, rk), (dv, rv)))
        if errs[name] > 1e-2:
            raise SystemExit(f"flash_dkv_probe: {name} disagrees with the plain version ({errs[name]})")
    for name, us in time_rounds(fns, launch, args.reps).items():
        print(json.dumps({"variant": name, "shape": list(SHAPE), "us_per_launch": us,
                          "reps": args.reps, "max_err": errs.get(name)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
