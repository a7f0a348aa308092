#!/usr/bin/env python3
"""Where K2's time goes: the INT8 matmul with parts cut out, the harness's
floor per graph node, and the library yardstick's two nodes.

Usage: python3 int8_matmul_probe.py [--source PATH] [--seed 0]

``--source`` is an ``int8_matmul.cu`` (default: the package's own,
``vector_quantization_tpu_torch/csrc/int8_matmul.cu``; the stripe design,
tried and not shipped, is
``vector_quantization_tpu_torch/csrc/designs/int8_matmul_stripe.cu``). The
probe recognises the design by its kernel's name and builds it as it is
and copies changed by text
substitution (``flash_fwd_probe.cut``, which raises on a miss), with the
flags of ``ops/_build.py``, all at once. Every variant is timed at the five
serving shapes of ``chip_smoke.py`` (B = 64; qkv, o, gate+up, down, lm head
of Llama-medium) by CUDA-graph replay (``chip_smoke.graph_ms``), with the
weight rotated through more than 50 MB as ``chip_smoke.py`` phase
``int8_matmul`` does. What is timed, per design:

- ``w8a16_kernel`` (the split-K design with f32 atomics into a zeroed
  output): ``shipped`` (a ``torch.zeros`` node, then the kernel, as its
  wrapper ran them), ``no_memset`` (the kernel alone, storing where it
  would add), ``no_products`` and ``no_loads`` (also without the memset),
  and ``empty`` (the kernel returning at once: one node's floor);
- ``w8a16_stripe_kernel`` (one launch per call: a block per 32-column
  stripe over all of D or a cluster's share of it, each warp streaming its
  own k tiles):
  ``shipped``, ``no_products`` (loads only), ``no_loads`` (products on
  whatever shared memory holds), ``no_store`` (the warps' sums meet but
  are not stored), ``empty``, the shipped kernel under every other plan
  (tile depth, split of D over a cluster, ring depth; each checked
  against the plain version before it is timed), and a block
  timeline (``timeline``, also on the no-loads and no-products copies):
  when each block's warp 0 saw its first tile, finished its own tiles,
  passed the block's barriers, and ended;
- for both: ``zeros`` (the ``torch.zeros`` node alone), ``matmul``
  (``torch.matmul(x, w_bf16)`` alone), ``scale`` (``y * s`` alone, on a
  precomputed ``y``) and ``library`` (the two together: ``library_ms``).

Prints one JSON line per (variant, shape) with microseconds per call over
three graph timings, then the ``nvidia-smi`` name and power limit. The
shipped variant is checked against the plain version; the cut copies
compute garbage, and only their times mean anything. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from chip_smoke import HBM_BYTES_PER_S, MEDIUM, SLOTS, VOCAB, graph_ms
from flash_fwd_probe import build

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vector_quantization_tpu_torch" / "csrc" / "int8_matmul.cu"
OUT = ROOT / "vector_quantization_tpu_torch" / "_kernels_build" / "int8_probe"
_D, _F = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
SHAPES = [("qkv", _D, 3 * _D), ("o", _D, _D), ("gateup", _D, 2 * _F), ("down", _F, _D),
          ("lm_head", _D, VOCAB)]

# the split-K design: grid (F / 128, D / k_chunk, B / 64), atomics into zeros
PARENT = {
    "shipped": [],
    "no_memset": [("if (atomic) atomicAdd(dst, v);\n          else *dst = v;", "*dst = v;")],
    "empty": [("  if (k_begin >= k_end) return;", "  return;")],
}
PARENT["no_products"] = PARENT["no_memset"] + [
    ("for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);",
     "for (int mi = 0; mi < 4; ++mi) if (b0 == 0x12345u && b1 == 0x6789u) acc[mi][ni][0] += 1.f;")]
PARENT["no_loads"] = PARENT["no_memset"] + [
    ("  load_tile(k_begin);\n", "  xreg.v = make_uint4(1u, 2u, 3u, 4u); wreg.v = xreg.v;\n"),
    ("    if (it + 1 < ntiles) load_tile(k_begin + (it + 1) * BK);\n", "")]
PARENT_MARK = "w8a16_kernel("

# one launch per call: a block per 32-column stripe over all of D, each warp
# streaming its own k tiles
STRIPE = {
    "shipped": [],
    "no_products": [("for (int kk = 0; kk < KT / 16; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")],
    "no_loads": [("  for (int j = 0; j < S - 1; ++j) issue(j);\n", ""),
                 ("    issue(j + S - 1);\n", "")],
    "no_store": [("        a.out[(size_t)(m0 + row) * a.F + n0 + col + u] = part[u] * a.scale[n0 + col + u];",
                  "        if (part[u] == 1234.5f) a.out[0] = part[u];")],
    "empty": [("  const int S = a.stages, KS = a.split;\n",
               "  return;\n  const int S = a.stages, KS = a.split;\n")],
}
# thread 0 (warp 0) stamps %globaltimer (ns) at entry, when its first tile
# landed, after its last tile, when every warp is past its last tile, when
# the partials are written, and at the end (the sums not stored), into
# `out` viewed as int64 sextuples
_T = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tl[{}]));"
STAMPS = [
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  unsigned long long tl[6] = {0, 0, 0, 0, 0, 0}; " + _T.format(0) + "\n"),
    ("    wait_copies(S - 1);  // tile j landed\n    __syncwarp();\n",
     "    wait_copies(S - 1);  // tile j landed\n    __syncwarp();\n"
     "    if (j == 0) { " + _T.format(1) + " }\n"),
    ("  // the partials meet: every warp is past its last tile\n  __syncthreads();\n",
     "  " + _T.format(2) + "\n  __syncthreads();\n  " + _T.format(3) + "\n"),
    ("  __syncthreads();\n  // the block's sums",
     "  __syncthreads();\n  " + _T.format(4) + "\n  // the block's sums"),
    ("  if (KS == 1) return;\n",
     "  if (threadIdx.x == 0) { " + _T.format(5) + " unsigned long long* o = "
     "(unsigned long long*)a.out; const int blk = blockIdx.y * gridDim.x + blockIdx.x;"
     " for (int k = 0; k < 6; ++k) o[6 * blk + k] = tl[k]; }\n  if (KS == 1) return;\n"),
]
STRIPE["timeline"] = STAMPS + STRIPE["no_store"]
STRIPE["timeline_no_loads"] = STAMPS + STRIPE["no_store"] + STRIPE["no_loads"]
STRIPE["timeline_no_products"] = STAMPS + STRIPE["no_store"] + STRIPE["no_products"]
STRIPE_MARK = "w8a16_stripe_kernel"


class StripePlan(NamedTuple):
    """A launch of the stripe design: a block per 32 columns and 64 rows, k
    tiles ``kt`` deep, D split over clusters of ``split`` blocks, ``stages``
    tiles in each warp's ring, and which operands are copied 16 bytes at a
    time (``x_vec``, ``w_vec``; else 4 bytes at a time)."""

    kt: int
    split: int
    stages: int
    x_vec: bool
    w_vec: bool

    def grid(self, b: int, f: int) -> tuple[int, int]:
        return -(-f // 32) * self.split, -(-b // 64)

    def smem(self) -> int:
        stage = 64 * self.kt * 2 + self.kt * 32
        raw = (0 if self.x_vec else 64 * (2 * self.kt + 4)) + (0 if self.w_vec else self.kt * 36)
        return 1024 + max(8 * self.stages * stage, 8 * 64 * 36 * 4) + 8 * self.stages * raw + 8192


def vec_ok(ptr: int, pitch_bytes: int) -> bool:
    """Whether the stripe design copies an operand 16 bytes at a time."""
    return ptr % 16 == 0 and pitch_bytes % 16 == 0


def stripe_plan(b: int, d: int, f: int, num_sms: int, x_vec: bool, w_vec: bool) -> StripePlan:
    """The stripe design's own choice: D split over clusters of 2 or 4
    while the grid fits on the card one block to an SM and every warp keeps
    a 64-deep tile; 64-deep tiles when the grid fits one block to an SM,
    else 32-deep (two blocks to an SM); two tiles to a warp's ring."""
    stripes = -(-f // 32) * -(-b // 64)
    split = max(k for k in (1, 2, 4) if k == 1 or (stripes * k <= num_sms and d // k >= 512))
    kt = 64 if stripes * split <= num_sms else 32
    stages = 2
    while stages > 1 and StripePlan(kt, split, stages, x_vec, w_vec).smem() > 227 * 1024:
        stages -= 1
    return StripePlan(kt, split, stages, x_vec, w_vec)


def parent_k_chunk(b: int, d: int, f: int, num_sms: int) -> int:
    """The split-K design's depth per block (its wrapper's ``split_k``)."""
    k_tiles, blocks = -(-d // 32), -(-f // 128) * -(-b // 64)
    splits = min(k_tiles, max(1, -(-2 * num_sms // blocks)))
    return min(max(-(-k_tiles // splits), 8), k_tiles) * 32


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def emit(variant: str, shape: str, b: int, d: int, f: int, us: list, **extra) -> None:
    byts = d * f + b * d * 2 + f * 4 + b * f * 4
    print(json.dumps({"variant": variant, "shape": shape, "B": b, "D": d, "F": f,
                      "us_per_call": us, "bound_us": 1e6 * byts / HBM_BYTES_PER_S, **extra}),
          flush=True)


def times(calls) -> list[float]:
    return [1e3 * graph_ms(calls) for _ in range(3)]


def rotated(d: int, f: int, gen, dev) -> list[torch.Tensor]:
    copies = -(-150_000_000 // (d * f))  # > 50 MB L2 per rotation
    return [torch.randint(-127, 128, (d, f), generator=gen, device=dev, dtype=torch.int8)
            for _ in range(copies)]


def probe_parent(src: str, dev, gen) -> None:
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul_reference

    libs = build(src, PARENT, OUT / "parent")
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.vqt_int8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fns[name] = fn
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, d, f in SHAPES:
        b = SLOTS
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        k_chunk = parent_k_chunk(b, d, f, sms)
        splits = math.ceil(d / k_chunk)
        out = torch.empty((b, f), device=dev)

        def call(fn, w, zero):
            o = torch.zeros((b, f), device=dev) if zero else out
            err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(), b, d, f, k_chunk,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"int8_matmul_probe: launch failed, CUDA error {err}")
            return o

        got = call(fns["shipped"], ws[0], splits > 1)
        want = int8_matmul_reference(x, ws[0], s)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-3:
            raise SystemExit(f"int8_matmul_probe: parent {shape} disagrees ({rel})")
        for name, fn in fns.items():
            zero = name == "shipped" and splits > 1
            emit(name, shape, b, d, f, times([lambda w=w, fn=fn, z=zero: call(fn, w, z)
                                              for w in ws]),
                 design="split_k", k_chunk=k_chunk, splits=splits, weight_copies=len(ws),
                 **({"max_rel_err": rel} if name == "shipped" else {}))
        library_nodes(shape, b, d, f, x, s, ws, dev)
        del ws


def probe_stripe(src: str, dev, gen) -> None:
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul_reference

    libs = build(src, STRIPE, OUT / "stripe")
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.vqt_int8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fns[name] = fn
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, d, f in SHAPES:
        b = SLOTS
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        x_vec, w_vec = vec_ok(x.data_ptr(), 2 * d), vec_ok(ws[0].data_ptr(), f)
        shipped = stripe_plan(b, d, f, sms, x_vec, w_vec)
        want = int8_matmul_reference(x, ws[0], s)

        def call(fn, w, plan):
            out = torch.empty((b, f), device=dev)
            err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), b, d, f,
                     plan.kt, plan.split, plan.stages, int(plan.x_vec), int(plan.w_vec),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"int8_matmul_probe: launch failed, CUDA error {err}")
            return out

        plans = [shipped] + [p for p in (StripePlan(kt, k, st, x_vec, w_vec)
                                         for kt in (32, 64) for k in (1, 2, 4)
                                         for st in (1, 2, 3, 4))
                             if p != shipped and p.smem() <= 227 * 1024]
        for name, fn in fns.items():
            if name.startswith("timeline"):
                stripe_timeline(fn, call, shipped, name, shape, b, f, ws)
                continue
            for plan in (plans if name == "shipped" else [shipped]):
                extra = {"design": "stripe", "plan": plan._asdict(),
                         "grid": plan.grid(b, f), "weight_copies": len(ws)}
                if name == "shipped":
                    got = call(fn, ws[0], plan)
                    torch.cuda.synchronize()
                    rel = float((got - want).abs().max() / want.abs().max())
                    if rel > 1e-3 or not bool(torch.isfinite(got).all()):
                        raise SystemExit(f"int8_matmul_probe: {shape} {plan} disagrees ({rel})")
                    extra.update(max_rel_err=rel, **occupancy(libs[name][0], plan))
                label = name if plan is shipped or name != "shipped" else "plan"
                emit(label, shape, b, d, f,
                     times([lambda w=w, fn=fn, p=plan: call(fn, w, p) for w in ws]), **extra)
        library_nodes(shape, b, d, f, x, s, ws, dev)
        del ws


def occupancy(lib, plan: StripePlan) -> dict:
    """A stripe plan's dynamic shared memory per block and resident blocks
    per SM on the current card."""
    i = ctypes.c_int
    fn = lib.vqt_int8_matmul_occupancy
    fn.restype, fn.argtypes = i, [i] * 4 + [ctypes.POINTER(i)] * 2
    smem, blocks = i(), i()
    if fn(plan.kt, plan.stages, int(plan.x_vec), int(plan.w_vec), ctypes.byref(smem),
          ctypes.byref(blocks)) != 0:
        raise SystemExit("int8_matmul_probe: occupancy query failed")
    return {"dynamic_smem": smem.value, "blocks_per_sm": blocks.value}


def stripe_timeline(fn, call, plan, name, shape, b, f, ws) -> None:
    """One graph replay of a timeline copy over the rotated weights; the
    last call's stamps: per block, microseconds from the kernel's first
    entry to each stamp (percentiles), and each phase's median."""
    import numpy as np

    outs = []
    graph_ms([lambda w=w: outs.append(call(fn, w, plan)) for w in ws], replays=1)
    torch.cuda.synchronize()
    gx, gy = plan.grid(b, f)
    st = outs[-1].view(-1).view(torch.int64)[: 6 * gx * gy].view(-1, 6).cpu().numpy()
    st = st[st[:, 0] > 0]  # blocks of a split's cluster write their stamps, all
    st = (st - st[:, 0].min()).astype(np.float64) / 1e3
    pct = [0, 10, 50, 90, 100]
    names = ("entry", "first_tile", "own_tiles", "all_tiles", "partials", "end")
    print(json.dumps({
        "variant": name, "shape": shape, "blocks": gx * gy, "plan": plan._asdict(),
        "span_us": float(st[:, 5].max()),
        **{f"{n}_us_pcts_0_10_50_90_100": np.percentile(st[:, k], pct).tolist()
           for k, n in enumerate(names)},
        "phase_us_median": {names[k]: float(np.median(st[:, k] - st[:, k - 1]))
                            for k in range(1, 6)},
    }), flush=True)


def library_nodes(shape, b, d, f, x, s, ws, dev) -> None:
    wb = [w.to(torch.bfloat16) for w in ws]
    y = torch.matmul(x, wb[0])
    emit("zeros", shape, b, d, f, times([lambda: torch.zeros((b, f), device=dev)] * len(ws)))
    emit("matmul", shape, b, d, f, times([lambda w=w: torch.matmul(x, w) for w in wb]))
    emit("scale", shape, b, d, f, times([lambda: y * s] * len(ws)))
    emit("library", shape, b, d, f, times([lambda w=w: torch.matmul(x, w) * s for w in wb]))
    del wb


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", type=Path, default=SOURCE)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("int8_matmul_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src = args.source.read_text()
    if PARENT_MARK in src:
        probe_parent(src, dev, gen)
    elif STRIPE_MARK in src:
        probe_stripe(src, dev, gen)
    else:
        raise SystemExit("int8_matmul_probe: no known design in " + str(args.source))
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
