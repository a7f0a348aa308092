#!/usr/bin/env python3
"""Where K2's time goes: the shipped choice per shape, each design with parts
cut out and under other plans, the harness's floor per graph node, and the
library yardstick's two nodes.

Usage: python3 int8_matmul_probe.py [--source PATH] [--seed 0] [--cuts]

First, at the five serving shapes of ``chip_smoke.py`` (B = 64; qkv, o,
gate+up, down, lm head of Llama-medium), ``planned``: the package's own
``int8_matmul``, under the plan its ``plan_for`` picks (printed beside it),
next to ``library``. Then the design of ``--source``, an INT8 matmul source
(default: the split-K design,
``vector_quantization_tpu_torch/csrc/int8_matmul.cu``; the wide design is
``vector_quantization_tpu_torch/csrc/int8_matmul_wide.cu``). The probe
recognises the design by its kernel's name and builds it as it is and
copies changed by text substitution (``flash_fwd_probe.cut``, which raises
on a miss), with the flags of ``ops/_build.py``, all at once. Every variant
is timed at the five shapes by CUDA-graph replay (``chip_smoke.graph_ms``),
with the weight rotated through more than 50 MB as ``chip_smoke.py`` phase
``int8_matmul`` does. What is timed, per design:

- ``w8a16_kernel`` (the split-K design with f32 atomics into a zeroed
  output): ``shipped`` (a ``torch.zeros`` node, then the kernel, as its
  wrapper runs them), ``no_memset`` (the kernel alone, storing where it
  would add), ``no_products`` and ``no_loads`` (also without the memset),
  and ``empty`` (the kernel returning at once: one node's floor);
- ``w8a16_wide_kernel`` (one launch per call: a block per 128 columns over
  a cluster's share of D, x's share held in shared memory), at the aligned
  shapes: ``shipped`` (under the package's ``wide_plan``), ``no_products``
  (loads only), ``no_loads`` (products on whatever shared memory holds),
  ``no_store`` (the sums meet but are not stored), ``empty``, the shipped
  kernel under every other plan (``plan``: every cluster size of 1, 2, 4,
  8 and ring depth that fits; each checked against the plain version
  before it is timed), ``cvt_pack`` (the widened bf16 pair packed by a
  conversion instruction in place of a byte permute) and a block timeline
  (``timeline``, also on the no-loads and no-products copies): when each
  block's thread 0 entered, saw its first tile, was past its last tile,
  saw every peer of its cluster started, saw the sums met, and ended;
- ``w8a16_tiled_kernel`` (``csrc/int8_matmul_tiled.cu``, the design for
  many rows): the threshold sweep instead of the serving shapes. At B in
  ``SWEEP_ROWS`` (128 to 8256) and each of the five widths, ``below`` (the
  plan ``plan`` picks without the tiled design: wide where the rows are
  aligned and a share fits, ragged where w's are not, else split-K), ``tiled`` (the tiled design
  forced), ``split_k`` (split-K forced, where ``below`` is not split-K)
  and ``library``, alternately (below, tiled, tiled, below) in one call;
  each kernel checked against the plain version first; the line carries
  ``planned``, the design the package's ``plan`` picks at that shape.
  With ``--cuts``, instead: at the five widths at 8256 rows, the tiled
  kernel as it is (``shipped``) and with parts cut out: ``no_store`` (the
  output's global stores), ``no_epilogue`` (the whole epilogue, the sums
  kept live), ``no_widen`` (the A fragments' ldmatrix and widening),
  ``no_mma`` (the wgmmas), ``no_x_tma`` (x's TMA copies); the
  shipped kernel beside the SM clock and
  power that ``nvidia-smi`` samples during the shipped kernel's timing;
- ``w8a16_ragged_kernel`` (``csrc/int8_matmul_ragged.cu``, the design for
  weight rows that are not 16-byte aligned): the sweep at the lm head's
  width, B in ``RAGGED_ROWS`` (1 to 1024): the package's plan (``ragged``)
  and split-K forced, alternately (ragged, split-K, split-K, ragged), and
  ``library``; at 64 rows also every column tile (128, 144) and ring depth
  (3-8) whose block fits the card; each kernel checked against the plain
  version first; the line carries ``planned``, the design ``plan`` picks.
  With ``--cuts``, instead: at the head at 64 rows and at 1 row, the kernel
  as it is (``shipped``) and with parts cut out: ``no_products`` (the B
  tiles' ldmatrix, widening and stores, and the wgmmas), ``no_mma`` (the
  wgmmas), ``no_widen`` (the widening: raw bytes stored), ``no_shift`` (the
  rows' shift into place), ``no_w_loads`` (the weight's copies),
  ``no_loads`` (those and x's TMA), ``no_store`` (the output's stores),
  ``no_epilogue`` (the images and stores, the sums kept live), ``empty``;
  then ``timeline``: when each block's thread 0 entered, had x's first
  chunk, was past its last stage, past the image, and ended;
- for the split-K and wide designs: ``zeros`` (the ``torch.zeros`` node alone), ``matmul``
  (``torch.matmul(x, w_bf16)`` alone), ``scale`` (``y * s`` alone, on a
  precomputed ``y``) and ``library`` (the two together: ``library_ms``).

Prints one JSON line per (variant, shape) with microseconds per call over
three graph timings, then the ``nvidia-smi`` name and power limit. The
shipped and planned variants are checked against the plain version; the
cut copies compute garbage, and only their times mean anything. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import HBM_BYTES_PER_S, MEDIUM, SLOTS, VOCAB, graph_ms
from flash_fwd_probe import build
from vector_quantization_tpu_torch.ops import int8_matmul as im
from vector_quantization_tpu_torch.ops.int8_matmul import (
    Plan, card, int8_matmul, int8_matmul_reference, occupancy, plan_for, split_k, wide_plan,
)

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

# one launch per call: a block per 128 columns over a cluster's share of D
WIDE = {
    "shipped": [],
    "no_products": [("    for (int kk = 0; kk < WKT / 32; ++kk) {",
                     "    for (int kk = 0; kk < 0; ++kk) {")],
    "no_loads": [("  for (int j = 0; j < S; ++j) issue(j);\n", ""),
                 ("    if (j > 0) issue(j - 1 + S);  // into tile j - 1's ring slot\n", "")],
    "no_store": [("  *reinterpret_cast<float4*>(dst) = v;\n}",
                  "  if (v.x == 1234.5f) *reinterpret_cast<float4*>(dst) = v;\n}")],
    "empty": [("  const int KS = a.split, S = a.stages;\n",
               "  return;\n  const int KS = a.split, S = a.stages;\n")],
}
# thread 0 stamps %globaltimer (ns) at entry, when its first tile landed,
# past its last tile, when every peer has started, when every row's copies
# landed (the last two only with a split), and at the end (the sums not
# stored), into `out` viewed as int64 sextuples
_T = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tl[{}]));"
_WRITE = ("if (threadIdx.x == 0) { " + _T.format(5) + " unsigned long long* o = "
          "(unsigned long long*)a.out; const int blk = blockIdx.y * gridDim.x + blockIdx.x;"
          " for (int k = 0; k < 6; ++k) o[6 * blk + k] = tl[k]; }")
STAMPS = [
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  unsigned long long tl[6] = {0, 0, 0, 0, 0, 0}; " + _T.format(0) + "\n"),
    ("    __syncthreads();  // everyone's have; every warp is past tile j - 1\n",
     "    __syncthreads();  // everyone's have; every warp is past tile j - 1\n"
     "    if (j == 0) { " + _T.format(1) + " }\n"),
    ("  asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n  // group q = 2 mi + hr",
     "  " + _T.format(2) + "\n  asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "  // group q = 2 mi + hr"),
    ("    for (int q = 0; q < GROUPS; ++q) store(q, sums(q));\n    return;\n",
     "    for (int q = 0; q < GROUPS; ++q) store(q, sums(q));\n    " + _WRITE + "\n    return;\n"),
    ("  // every peer has started\n", "  // every peer has started\n  " + _T.format(3) + "\n"),
    ("  cluster_sync();  // every copy has landed; nothing reads or writes this block's after\n",
     "  cluster_sync();  // every copy has landed; nothing reads or writes this block's after\n"
     "  " + _T.format(4) + "\n"),
    ("    store(rank * GPB + ql, sum);\n  }\n}\n",
     "    store(rank * GPB + ql, sum);\n  }\n  " + _WRITE + "\n}\n"),
]
WIDE["timeline"] = STAMPS + WIDE["no_store"]
WIDE["timeline_no_loads"] = STAMPS + WIDE["no_store"] + WIDE["no_loads"]
WIDE["timeline_no_products"] = STAMPS + WIDE["no_store"] + WIDE["no_products"]
# the int8 widening's bf16 pair packed by a conversion instruction in place
# of a byte permute
WIDE["cvt_pack"] = [(
    "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n",
    "  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
    "  return *reinterpret_cast<uint32_t*>(&v);\n")]
WIDE_MARK = "w8a16_wide_kernel"
TILED_MARK = "w8a16_tiled_kernel"
RAGGED_MARK = "w8a16_ragged_kernel"
# the ragged design (csrc/int8_matmul_ragged.cu) with parts cut out; `a.B <
# 0` is never true, so a cut part stays compiled but does not run
RAGGED = {
    "shipped": [],
    # the B tile's ldmatrix, widening and stores, and the wgmmas
    "no_products": [("      uint32_t bw[Sh::H / 2][4], bm[2] = {0u, 0u};\n",
                     "      uint32_t bw[Sh::H / 2][4], bm[2] = {0u, 0u};\n      if (a.B < 0) {\n"),
                    ("      if (jl + 1 < TL) shift_store(jl + 1);\n",
                     "      }\n      if (jl + 1 < TL) shift_store(jl + 1);\n      if (a.B < 0) {\n"),
                    ("      fence_proxy_async();  // the B tile's stores, seen by wgmma\n",
                     "      }\n      fence_proxy_async();  // the B tile's stores, seen by wgmma\n"),
                    ("      for (int kk = 0; kk < 4; ++kk) wgmma_ss<",
                     "      for (int kk = 0; kk < 4 && a.B < 0; ++kk) wgmma_ss<")],
    "no_mma": [("      for (int kk = 0; kk < 4; ++kk) wgmma_ss<",
                "      for (int kk = 0; kk < 4 && a.B < 0; ++kk) wgmma_ss<")],
    "no_widen": [("            for (int p = 0; p < 2; ++p) sts32(bt + b_at(2 * (i + qq) + p, m), widen2(u, p));\n",
                  "            for (int p = 0; p < 2; ++p) sts32(bt + b_at(2 * (i + qq) + p, m), u + p);\n"),
                 ("        for (int m = 0; m < 2; ++m) sts32(bt + b_at(2 * Sh::H, m), widen2(bm[m] ^ 0x80808080u, cg));\n",
                  "        for (int m = 0; m < 2; ++m) sts32(bt + b_at(2 * Sh::H, m), bm[m] + cg);\n")],
    "no_shift": [("      if (jl + 1 < TL) shift_load();\n", "      if (jl + 1 < TL && a.B < 0) shift_load();\n"),
                 ("      if (jl + 1 < TL) shift_store(jl + 1);\n", "      if (jl + 1 < TL && a.B < 0) shift_store(jl + 1);\n")],
    "no_w_loads": [("        if (cp_row[i] >= 0 && in_k + cp_row[i] < a.D) cp16(",
                    "        if (cp_row[i] >= 0 && in_k + cp_row[i] < a.D && a.B < 0) cp16(")],
    "no_store": [("    const float* const sc = scale_s + c0;\n",
                  "    if (c0 != 1234567) continue;\n    const float* const sc = scale_s + c0;\n")],
    # the sums kept live by one conditional store
    "no_epilogue": [("  asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n  __syncthreads();  // every warp",
                     "  if (acc[0] + acc[Sh::ACC - 1] != 1234.5f) return;\n"
                     "  asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n  __syncthreads();  // every warp")],
    "empty": [("  const int S = a.stages;\n", "  if (a.B > 0) return;\n  const int S = a.stages;\n")],
}
RAGGED["no_loads"] = RAGGED["no_w_loads"] + [
    ("    mbar_expect_tx(xbar + 8 * (c & 1), q_end * X_TILE);\n    for (int q = 0; q < q_end; ++q)\n",
     "    mbar_expect_tx(xbar + 8 * (c & 1), 0);\n    for (int q = 0; q < q_end && a.B < 0; ++q)\n")]
# thread 0 stamps %globaltimer (ns) at entry, when x's first chunk has
# landed, past its last stage, past the partial images, and at the end (no
# output stored), into `out` viewed as int64 quintuples
_RT = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tl[{}]));"
RAGGED["timeline"] = RAGGED["no_store"] + [
    ("  const int S = a.stages;\n",
     "  unsigned long long tl[5] = {0, 0, 0, 0, 0}; " + _RT.format(0) + "\n  const int S = a.stages;\n"),
    ("    mbar_wait(xbar + 8 * (c & 1), (c >> 1) & 1);\n",
     "    mbar_wait(xbar + 8 * (c & 1), (c >> 1) & 1);\n    if (c == 0) { " + _RT.format(1) + " }\n"),
    ("  __syncthreads();  // every warp past its last stage: x's buffers and the rings are free\n",
     "  __syncthreads();  // every warp past its last stage: x's buffers and the rings are free\n  "
     + _RT.format(2) + "\n"),
    ("  __syncthreads();\n  // output word l of row r",
     "  __syncthreads();\n  " + _RT.format(3) + "\n  // output word l of row r"),
    ("        if (c0 + i >= 0 && c0 + i < nb) dst[c0 + i] = sv[i] * sc[i];\n    }\n  }\n}\n",
     "        if (c0 + i >= 0 && c0 + i < nb) dst[c0 + i] = sv[i] * sc[i];\n    }\n  }\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) { " + _RT.format(4) + " unsigned long long* o = "
     "(unsigned long long*)a.out; const int blk = blockIdx.y * gridDim.x + blockIdx.x;"
     " for (int k = 0; k < 5; ++k) o[5 * blk + k] = tl[k]; }\n}\n"),
]
# the ragged sweep: rows of x at the head
RAGGED_ROWS = (1, 7, 64, 128, 256, 512, 1024)
SWEEP_ROWS = (128, 256, 512, 1024, 2048, 8256)
# the tiled design with parts cut out (its outputs are garbage)
TILED = {
    "shipped": [],
    "no_store": [("  if (p.out_aligned) {\n    if (row < p.B && o.col < p.F)",
                  "  if (y.x != 1234.5f) return;\n  if (p.out_aligned) {\n    if (row < p.B && o.col < p.F)")],
    "no_widen": [("      ldsm_x4_t(bw, ws + (32 * h + (lane >> 3) * 8 + (lane & 7)) * 128 +\n"
                  "                        ((chunk ^ (lane & 7)) << 4));\n",
                  "      bw[0] = ws + h; bw[1] = lane; bw[2] = bw[1] + 3; bw[3] = bw[0] ^ 5;\n"),
                 ("        a[2 * h + q][0] = widen2(lo, 0);\n        a[2 * h + q][1] = widen2(lo, 1);\n"
                  "        a[2 * h + q][2] = widen2(hi, 0);\n        a[2 * h + q][3] = widen2(hi, 1);\n",
                  "        a[2 * h + q][0] = lo;\n        a[2 * h + q][1] = hi;\n"
                  "        a[2 * h + q][2] = lo ^ 7;\n        a[2 * h + q][3] = hi ^ 9;\n")],
    "no_mma": [("    for (int kk = 0; kk < 4; ++kk) wgmma_256(",
                "    for (int kk = 0; kk < 0; ++kk) wgmma_256(")],
    # the sums kept live by one conditional store of their total
    "no_epilogue": [("    store_tile(p, acc, o, g, t4);\n",
                     "    float sum = 0.f;\n#pragma unroll\n    for (int i = 0; i < ACC; ++i) sum += acc[i];\n"
                     "    if (sum == 1234.5f) p.out[tid] = sum;\n")],
    "no_x_tma": [("          mbar_expect_tx(full + 8 * s, X_STAGE + (p.w_tma ? W_STAGE : 0));\n"
                  "          tma2d(st, &tx, full + 8 * s, kb * TK, m0);\n",
                  "          mbar_expect_tx(full + 8 * s, p.w_tma ? W_STAGE : 0);\n")],
}


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


def probe_planned(dev, gen) -> None:
    """The package's ``int8_matmul`` as it ships, per shape, beside the
    library call."""
    for shape, d, f in SHAPES:
        b = SLOTS
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        chosen = plan_for(x, ws[0])
        got, want = int8_matmul(x, ws[0], s), int8_matmul_reference(x, ws[0], s)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-3 or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"int8_matmul_probe: planned {shape} disagrees ({rel})")
        emit("planned", shape, b, d, f, times([lambda w=w: int8_matmul(x, w, s) for w in ws]),
             plan=chosen._asdict(), max_rel_err=rel, weight_copies=len(ws))
        library_nodes(shape, b, d, f, x, s, ws, dev)
        del ws


def probe_parent(src: str, dev, gen) -> None:
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
        k_chunk = split_k(b, d, f, sms)
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


def wide_entry(lib):
    """A build's C entry of the wide kernel."""
    fn = lib.vqt_int8_matmul_wide
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def sweep(b: int, d: int, f: int, shipped: Plan, dev) -> list[Plan]:
    """Every other wide plan that fits a block."""
    tiles, sms = -(-d // 64), card(dev).sms
    plans = (Plan("wide", 128, k, 64, st, -(-tiles // k) * 64)
             for k in (1, 2, 4, 8) if k <= tiles and -(-f // 128) * -(-b // 64) * k <= 2 * sms
             for st in sorted({2, 4, min(max(-(-tiles // k), 2), 8)}))
    return [p for p in plans if p != shipped and p.smem() <= card(dev).smem_block]


def probe_wide(src: str, dev, gen) -> None:
    libs = build(src, WIDE, OUT / "wide")
    fns = {name: wide_entry(lib) for name, (lib, _) in libs.items()}
    for shape, d, f in SHAPES:
        b = SLOTS
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        shipped = wide_plan(b, d, f, card(dev))
        if plan_for(x, ws[0]) != shipped:  # rows not aligned, or a share too deep
            del ws
            continue
        want = int8_matmul_reference(x, ws[0], s)

        def call(name, w, p):
            out = torch.empty((b, f), device=dev)
            err = fns[name](x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), b, d, f,
                            p.split, p.stages, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"int8_matmul_probe: launch failed, CUDA error {err}")
            return out

        for name in fns:
            if name.startswith("timeline"):
                timeline(call, shipped, name, shape, b, d, f, ws)
                continue
            for p in ([shipped] + sweep(b, d, f, shipped, dev) if name == "shipped"
                      else [shipped]):
                extra = {"plan": p._asdict(), "grid": p.grid(b, d, f), "weight_copies": len(ws)}
                if name == "shipped":
                    got = call(name, ws[0], p)
                    torch.cuda.synchronize()
                    rel = float((got - want).abs().max() / want.abs().max())
                    if rel > 1e-3 or not bool(torch.isfinite(got).all()):
                        raise SystemExit(f"int8_matmul_probe: {shape} {p} disagrees ({rel})")
                    extra.update(max_rel_err=rel, **occupancy(p, b, d, f))
                label = name if p is shipped or name != "shipped" else "plan"
                emit(label, shape, b, d, f,
                     times([lambda w=w, n=name, p=p: call(n, w, p) for w in ws]), **extra)
        library_nodes(shape, b, d, f, x, s, ws, dev)
        del ws


def timeline(call, plan, name, shape, b, d, f, ws) -> None:
    """One graph replay of a timeline copy over the rotated weights; the
    last call's stamps: per block, microseconds from the kernel's first
    entry to each stamp (percentiles), and each phase's median."""
    import numpy as np

    outs = []
    graph_ms([lambda w=w: outs.append(call(name, w, plan)) for w in ws], replays=1)
    torch.cuda.synchronize()
    gx, gy, _ = plan.grid(b, d, f)
    st = outs[-1].view(-1).view(torch.int64)[: 6 * gx * gy].view(-1, 6).cpu().numpy()
    st = st[st[:, 0] > 0]  # every block writes its stamps (a split's owners after the meet)
    st = (st - st[:, 0].min()).astype(np.float64) / 1e3
    names = ("entry", "first_tile", "last_tile", "peers_started", "sums_met", "end")
    cols = range(6) if plan.split > 1 else (0, 1, 2, 5)  # unsplit: no meet
    pct = [0, 10, 50, 90, 100]
    print(json.dumps({
        "variant": name, "shape": shape, "blocks": gx * gy, "plan": plan._asdict(),
        "span_us": float(st[:, 5].max()),
        **{f"{names[k]}_us_pcts_0_10_50_90_100": np.percentile(st[:, k], pct).tolist()
           for k in cols},
        "phase_us_median": {names[k]: float(np.median(st[:, k] - st[:, j]))
                            for j, k in zip(cols, cols[1:])},
    }), flush=True)


def probe_tiled(dev, gen) -> None:
    """The threshold sweep of the tiled design (module docstring). The
    package's own kernels run through ``_launch`` under each forced plan;
    bound_us here is the larger of the bytes' and the operations' floors."""
    for b in SWEEP_ROWS:
        for shape, d, f in SHAPES:
            x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
            s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
            ws = rotated(d, f, gen, dev)
            x_aligned, w_aligned = (2 * d) % 16 == 0, f % 16 == 0
            # the plan below TILED_MIN_ROWS at these rows (x's rows aligned at every width)
            below = ((wide_plan if w_aligned else im.ragged_plan)(b, d, f, card(dev))
                     or im.split_k_plan(b, d, f, card(dev).sms))
            plans = {"below": below, "tiled": im.tiled_plan(b, d, f)}
            if below.design != "split_k":
                plans["split_k"] = im.split_k_plan(b, d, f, card(dev).sms)
            want = int8_matmul_reference(x, ws[0], s)
            for name, p in plans.items():
                got = im._launch(x, ws[0], s, p)
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                if rel > 1e-3 or not bool(torch.isfinite(got).all()):
                    raise SystemExit(f"int8_matmul_probe: {name} at ({b}, {d}, {f}) disagrees ({rel})")
            del got, want

            def one(p):
                return 1e3 * graph_ms([lambda w=w: im._launch(x, w, s, p) for w in ws])

            us = {name: [] for name in plans}
            for name in ("below", "tiled", "tiled", "below"):
                us[name].append(one(plans[name]))
            if "split_k" in plans:
                us["split_k"] = [one(plans["split_k"]) for _ in range(2)]
            wb = [w.to(torch.bfloat16) for w in ws]
            us["library"] = [1e3 * graph_ms([lambda w=w: torch.matmul(x, w) * s for w in wb])
                             for _ in range(2)]
            del wb
            ops, byts = 2 * b * d * f, d * f + b * d * 2 + f * 4 + b * f * 4
            print(json.dumps({
                "variant": "sweep", "shape": shape, "B": b, "D": d, "F": f,
                "planned": im.plan(b, d, f, card(dev), x_aligned, w_aligned).design,
                "plans": {k: p._asdict() for k, p in plans.items()}, "us_per_call": us,
                "tiled_over_below": min(us["tiled"]) / min(us["below"]),
                "tiled_over_library": min(us["tiled"]) / min(us["library"]),
                "bound_us": 1e6 * max(byts / HBM_BYTES_PER_S, ops / 989e12),
                "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= ops / 989e12 else "operations",
                "weight_copies": len(ws)}), flush=True)
            del ws


def probe_tiled_cuts(src: str, dev, gen) -> None:
    """The tiled kernel and its cut copies at the five widths at 8256 rows
    (module docstring); the shipped copy is checked against the plain
    version."""
    libs = build(src, TILED, OUT / "tiled")
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.vqt_int8_matmul_tiled
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[name] = fn
    b, sms = SWEEP_ROWS[-1], card(dev).sms
    for shape, d, f in SHAPES:
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        def call(name, w):
            out = torch.empty((b, f), device=dev)
            err = fns[name](x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), b, d, f, d,
                            sms, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"int8_matmul_probe: launch failed, CUDA error {err}")
            return out

        got, want = call("shipped", ws[0]), int8_matmul_reference(x, ws[0], s)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-3:
            raise SystemExit(f"int8_matmul_probe: tiled {shape} disagrees ({rel})")
        del got, want
        for name in fns:
            extra = {}
            if name == "shipped":
                smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                        "--format=csv,noheader,nounits", "-lms", "50"],
                                       stdout=subprocess.PIPE, text=True)
            us = times([lambda w=w, n=name: call(n, w) for w in ws])
            if name == "shipped":
                smi.terminate()
                samples = [ln.split(",") for ln in smi.communicate()[0].splitlines() if "," in ln]
                clocks = sorted(float(c) for c, _ in samples)
                power = sorted(float(pw) for _, pw in samples)
                extra = {"max_rel_err": rel, "sm_clock_mhz_min_median_max":
                         [clocks[0], clocks[len(clocks) // 2], clocks[-1]] if clocks else None,
                         "power_w_min_median_max": [power[0], power[len(power) // 2], power[-1]]
                         if power else None, "clock_samples": len(clocks)}
            emit(name, shape, b, d, f, us, design="tiled", weight_copies=len(ws), **extra)
        del ws


def ragged_plans(b: int, d: int, f: int) -> dict:
    """The ragged design's plans swept at one shape: its shipped plan, and
    at 64 rows every column tile and ring depth whose block fits the card."""
    gpu = card(torch.device("cuda"))
    plans = {"ragged": im.ragged_plan(b, d, f, gpu)}
    if b == SLOTS:
        sweep = (Plan("ragged", n, 1, 64, st, -(-d // 64) * 64) for n in (128, 144) for st in range(3, 9))
        plans.update({f"ragged_n{p.n}_s{p.stages}": p for p in sweep if p.smem() <= gpu.smem_block})
    return plans


def probe_ragged(dev, gen) -> None:
    """The ragged design at the head's width, B in ``RAGGED_ROWS``: the
    package's plan (``ragged``) and split-K forced, alternately (ragged,
    split-K, split-K, ragged), and the library call; at 64 rows also every
    column tile and ring depth. Each kernel is checked against the plain
    version first."""
    _, d, f = SHAPES[-1]
    for b in RAGGED_ROWS:
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)
        plans = {**ragged_plans(b, d, f), "split_k": im.split_k_plan(b, d, f, card(dev).sms)}
        want = int8_matmul_reference(x, ws[0], s)
        for name, p in plans.items():
            got = im._launch(x, ws[0], s, p)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max() / want.abs().max())
            if rel > 1e-3 or not bool(torch.isfinite(got).all()):
                raise SystemExit(f"int8_matmul_probe: {name} at ({b}, {d}, {f}) disagrees ({rel})")
        del got, want

        def one(p):
            return 1e3 * graph_ms([lambda w=w: im._launch(x, w, s, p) for w in ws])

        us = {name: [] for name in plans}
        for name in ("ragged", "split_k", "split_k", "ragged"):
            us[name].append(one(plans[name]))
        for name in plans:
            if name not in ("ragged", "split_k"):
                us[name].append(one(plans[name]))
        wb = [w.to(torch.bfloat16) for w in ws]
        us["library"] = [1e3 * graph_ms([lambda w=w: torch.matmul(x, w) * s for w in wb])
                         for _ in range(2)]
        del wb
        ops, byts = 2 * b * d * f, d * f + b * d * 2 + f * 4 + b * f * 4
        print(json.dumps({
            "variant": "ragged_sweep", "shape": "lm_head", "B": b, "D": d, "F": f,
            "planned": im.plan(b, d, f, card(dev), True, False).design,
            "plans": {k: p._asdict() for k, p in plans.items()}, "us_per_call": us,
            "ragged_over_split_k": min(us["ragged"]) / min(us["split_k"]),
            "ragged_over_library": min(us["ragged"]) / min(us["library"]),
            "bound_us": 1e6 * max(byts / HBM_BYTES_PER_S, ops / 989e12),
            "weight_copies": len(ws)}), flush=True)
        del ws


def probe_ragged_cuts(src: str, dev, gen) -> None:
    """The ragged kernel and its cut copies (``RAGGED``) at the head, at 64
    rows and at 1 row; the shipped copy checked against the plain version;
    then one graph replay of the timeline copy: per block, microseconds
    from the first block's entry to each stamp."""
    import numpy as np

    libs = build(src, RAGGED, OUT / "ragged")
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.vqt_int8_matmul_ragged
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[name] = fn
    _, d, f = SHAPES[-1]
    for b in (SLOTS, 1):
        p = im.ragged_plan(b, d, f, card(dev))
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
        ws = rotated(d, f, gen, dev)

        def call(name, w):
            out = torch.empty((b, f), device=dev)
            err = fns[name](x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), b, d, f,
                            p.n, p.stages, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"int8_matmul_probe: launch failed, CUDA error {err}")
            return out

        got, want = call("shipped", ws[0]), int8_matmul_reference(x, ws[0], s)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-3:
            raise SystemExit(f"int8_matmul_probe: ragged at {b} rows disagrees ({rel})")
        for name in fns:
            if name == "timeline":
                continue
            emit(name, "lm_head", b, d, f, times([lambda w=w, n=name: call(n, w) for w in ws]),
                 design="ragged", plan=p._asdict(), weight_copies=len(ws),
                 **({"max_rel_err": rel} if name == "shipped" else {}))
        outs = []
        graph_ms([lambda w=w: outs.append(call("timeline", w)) for w in ws], replays=1)
        torch.cuda.synchronize()
        gx, gy, _ = p.grid(b, d, f)
        st = outs[-1].view(-1)[: 10 * gx * gy].view(torch.int64).view(-1, 5).cpu().numpy()
        st = (st - st[:, 0].min()).astype(np.float64) / 1e3
        names = ("entry", "x_chunk0_landed", "loop_done", "images_written", "end")
        pct = [0, 10, 50, 90, 100]
        print(json.dumps({
            "variant": "timeline", "shape": "lm_head", "B": b, "blocks": gx * gy, "plan": p._asdict(),
            "span_us": float(st[:, 4].max()),
            **{f"{n}_us_pcts_0_10_50_90_100": np.percentile(st[:, k], pct).tolist()
               for k, n in enumerate(names)},
            "phase_us_median": {names[k]: float(np.median(st[:, k] - st[:, k - 1])) for k in range(1, 5)},
        }), flush=True)
        del ws


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
    p.add_argument("--cuts", action="store_true",
                   help="the tiled or ragged design's cut copies in place of its sweep")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("int8_matmul_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src = args.source.read_text()
    if TILED_MARK in src:
        (probe_tiled_cuts(src, dev, gen) if args.cuts else probe_tiled(dev, gen))
        print(nvidia_smi(), flush=True)
        return 0
    if RAGGED_MARK in src:
        (probe_ragged_cuts(src, dev, gen) if args.cuts else probe_ragged(dev, gen))
        print(nvidia_smi(), flush=True)
        return 0
    probe_planned(dev, gen)
    if PARENT_MARK in src:
        probe_parent(src, dev, gen)
    elif WIDE_MARK in src:
        probe_wide(src, dev, gen)
    else:
        raise SystemExit("int8_matmul_probe: no known design in " + str(args.source))
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
