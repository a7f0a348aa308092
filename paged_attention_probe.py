#!/usr/bin/env python3
"""Where K3's time goes: the paged decode attention under other plans and
other lengths.

Usage: python3 paged_attention_probe.py [--seed 0]

Times ``paged_decode_attention`` (``csrc/paged_attention.cu``) at the
serving shape of ``chip_smoke.py`` (q (64, 16, 64) bf16 over int8 pools
(24, 321, 64, 16, 64), page tables sliced to 5 pages) by CUDA-graph replay
with the layer rotated over all 24, as ``chip_smoke.py`` does:

- ``plan``: the shipped plan and others (stage bytes and ring stages, so
  chunk size and loads in flight; one split per row, which drops the
  combine launch), at the phase's ragged random lengths;
- ``lengths``: the shipped plan at lengths all 0 (the fixed cost of the two
  launches: every block exits at once), the decode step's own lengths, and
  all full (320);
- ``l2``: the shipped plan with the layer held fixed, so that the 24 calls
  read the same ~22 MB from L2 and not from device memory;
- ``cut``: copies of the source changed by text substitution (built with
  the flags of ``ops/_build.py``): ``no_compute`` (loads and waits, no
  scores, softmax or products) and ``no_loads`` (no copies: the products
  run on whatever shared memory holds) and ``no_combine`` (the split
  kernel alone: the second launch left out).

Each variant but the cut copies (which compute garbage) is checked against
the plain version (1e-4 of max(1, max|ref|)) before it is timed. Prints one JSON line per variant, then the
``nvidia-smi`` name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from pathlib import Path

import numpy as np
import torch

from chip_smoke import P_SLOT, PAGE_SIZE, SLOTS, decode_positions, graph_ms
from flash_fwd_probe import build

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vector_quantization_tpu_torch" / "csrc" / "paged_attention.cu"
OUT = ROOT / "vector_quantization_tpu_torch" / "_kernels_build" / "paged_probe"
CUTS = {
    "no_compute": [("    if (computes) {\n      const unsigned char* sk",
                    "    if (false) {\n      const unsigned char* sk")],
    "no_loads": [("for (int s = kv_s0; s < n; s += kv_step)", "for (int s = kv_s0; s < 0; s += kv_step)"),
                 ("for (int s = sc_s0; s < n; s += sc_step)", "for (int s = sc_s0; s < 0; s += sc_step)")],
    "no_combine": [("  paged_combine_kernel<DH><<<", "  if (0) paged_combine_kernel<DH><<<")],
}
# the split kernel alone, each block writing its start and end (%globaltimer,
# ns) into `out` viewed as int64 pairs
_STAMP = ("{ unsigned long long t1; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));"
          " if (tid == 0) { unsigned long long* o = (unsigned long long*)a.out;"
          " const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;"
          " o[2 * blk] = t0; o[2 * blk + 1] = t1; } }")
TIMELINE = CUTS["no_combine"] + [
    ("const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;",
     "const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31; unsigned long long t0;"
     " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t0));"),
    ("  if (p_begin >= n_pages) {  // nothing to attend in this split\n",
     "  if (p_begin >= n_pages) {  // nothing to attend in this split\n" + _STAMP),
    ("  if (!computes) return;", "  __syncthreads(); " + _STAMP + "\n  if (!computes) return;"),
]


PLANS = {  # name: (stage_bytes, stages, one split per row)
    "shipped": (None, None, False),
    "chunk8_stages4": (20 << 10, 4, False),
    "chunk16_stages3": (40 << 10, 3, False),
    "chunk32_stages2": (80 << 10, 2, False),
    "one_split": (None, None, True),
}


def timeline(pa, lib, tensors, kw, lens) -> None:
    """One call of the timeline copy at ``lens``: block count, span of the
    kernel, and the blocks' durations and start offsets (microseconds)."""
    fn = lib.vqt_paged_decode_attention
    shipped = pa._kernel
    fn.restype, fn.argtypes = shipped().restype, shipped().argtypes
    pa._kernel = lambda: fn
    try:
        lengths = torch.from_numpy(np.asarray(lens, np.int32)).to(tensors[0].device)
        for _ in range(3):
            out = pa.paged_decode_attention(*tensors, lengths, 5, **kw)
        torch.cuda.synchronize()
    finally:
        pa._kernel = shipped
    plan = pa.decode_plan(SLOTS, 16, 64, P_SLOT, PAGE_SIZE, torch.int8,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    n = plan.splits * SLOTS * plan.groups
    stamps = out.view(-1).view(torch.int64)[: 2 * n].view(n, 2).cpu().numpy().astype(np.float64)
    t0 = stamps[:, 0].min()
    start, dur = (stamps[:, 0] - t0) / 1e3, (stamps[:, 1] - stamps[:, 0]) / 1e3
    live = dur > 0.5
    print(json.dumps({
        "probe": "timeline", "blocks": n, "live_blocks": int(live.sum()),
        "span_us": float((stamps[:, 1].max() - t0) / 1e3),
        "live_duration_us_pcts_0_10_50_90_100": np.percentile(dur[live], [0, 10, 50, 90, 100]).tolist(),
        "live_start_us_pcts_0_10_50_90_100": np.percentile(start[live], [0, 10, 50, 90, 100]).tolist(),
        "exit_at_once_duration_us_max": float(dur[~live].max()) if (~live).any() else None,
    }), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_probe: no CUDA device", file=sys.stderr)
        return 1
    from vector_quantization_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, h, dh, ps, n_layers = SLOTS, 16, 64, PAGE_SIZE, 24
    num_pages = 1 + b * P_SLOT
    rng = np.random.default_rng(0)
    table = torch.from_numpy(np.resize(rng.permutation(np.arange(1, num_pages)),
                                       (b, P_SLOT + 1)).astype(np.int32)).to(dev)[:, :P_SLOT]
    ragged = rng.integers(0, P_SLOT * ps + 1, b).astype(np.int32)
    ragged[:4] = [0, 1, ps, ps + 1]
    shape = (n_layers, num_pages, ps, h, dh)
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    kw = dict(k_scale_pool=torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3,
              v_scale_pool=torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3)
    cases = [("plan", name, ragged) for name in PLANS] + [
        ("lengths", "zero", np.zeros(b, np.int32)),
        ("lengths", "decode_step", decode_positions()[1] + 1),
        ("lengths", "full", np.full(b, P_SLOT * ps, np.int32)),
        ("l2", "fixed_layer", ragged),
    ] + [("cut", name, ragged) for name in CUTS]
    cut_libs = build(SOURCE.read_text(), {**CUTS, "timeline": TIMELINE}, OUT)
    shipped_kernel = pa._kernel
    shipped_plan = pa.decode_plan
    for kind, name, lens in cases:
        stage_bytes, stages, one_split = PLANS.get(name, (None, None, False))
        over = {key: val for key, val in (("stage_bytes", stage_bytes), ("stages", stages)) if val}
        if one_split:
            over["num_sms"] = 1  # BLOCKS_PER_SM blocks in all: one split per row

        def plan(*a, _over=over, **kw_):
            if "num_sms" in _over:
                a = a[:6]
            return shipped_plan(*a, **{**kw_, **_over})

        pa.decode_plan = plan
        if kind == "cut":
            fn = cut_libs[name][0].vqt_paged_decode_attention
            fn.restype, fn.argtypes = shipped_kernel().restype, shipped_kernel().argtypes
            pa._kernel = lambda fn=fn: fn
        layers = [5] * n_layers if kind == "l2" else range(n_layers)
        try:
            lengths = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
            got = pa.paged_decode_attention(q, k, v, table, lengths, 5, **kw)
            want = pa.paged_decode_attention_reference(q, k, v, table, lengths, 5, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
            us = [1e3 * graph_ms([lambda i=i: pa.paged_decode_attention(
                q, k, v, table, lengths, i, **kw) for i in layers]) for _ in range(3)]
            used = plan(b, h, dh, P_SLOT, ps, torch.int8, torch.cuda.get_device_properties(0)
                        .multi_processor_count)
        finally:
            pa.decode_plan, pa._kernel = shipped_plan, shipped_kernel
        print(json.dumps({"probe": kind, "variant": name, "mean_length": float(np.mean(lens)),
                          "us_per_call": us, "max_err": err, "plan": used._asdict()}), flush=True)
        if err > 1e-4 and kind != "cut":
            raise SystemExit(f"{name}: max_err {err} > 1e-4")
    timeline(pa, cut_libs["timeline"][0], (q, k, v, table), kw, ragged)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
