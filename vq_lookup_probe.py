#!/usr/bin/env python3
"""Where K1's time goes: the nearest-code lookup's call, split by CUDA-graph replay.

Usage: python3 vq_lookup_probe.py [--root DIR] [--seed 0] [--replays 20] [--cuts]

Imports ``vector_quantization_tpu_torch`` from ``--root`` (default: this
script's directory), so that one call can time two trees in turn, for
example a parent commit unpacked with ``git archive`` beside the change.
The tree's ``ops/_build.py`` builds ``csrc/vq_lookup.cu`` with its own flags
(``-Xptxas -v``); the probe prints the kernels' ptxas lines.

At four shapes (``path_f32``, ``path_bf16``: the tokenizer's N = K = 16384,
D = 8, Gaussian rows; ``path_normalized``: the same with unit rows, as the
LlamaGen quantizer feeds the lookup; ``flagship_d256``: N = K = 16384, D =
256, f32), it checks the call against the plain version (``compare_codes``)
and times by graph replay, in microseconds per call over three rounds:

- ``whole``: ``nearest_codes(x, e)`` as a caller makes it;
- ``library``: ``argmin(addmm(esq, x, e^T, alpha=-1))`` with ``esq`` made
  outside the graph (one PyTorch call's worth of the same function, which
  writes and reads the N x K matrix).

It also counts the device kernels one call launches (``torch.profiler``) and
prints their names. Prints one JSON line per shape, then the ``nvidia-smi``
name and power limit. Exits non-zero without a CUDA device or if a lookup
disagrees with the plain version beyond near-ties.

With ``--cuts`` (the tensor-core kernel only), it then builds copies of
``csrc/vq_lookup.cu`` with parts cut out by text substitution
(``flash_fwd_probe.cut``, which raises on a miss), all at once, and times
each through the same launch as the wrapper at path_f32, path_bf16 and
flagship_d256:

- ``shipped``; ``stages16``: a ring of 16 stages at D <= 8 in place of 8;
- ``no_branch``: the row's index search never runs (fminf trees and quad
  shuffles stay); ``no_shuffle``: also no quad shuffles; ``no_select``: no
  selection at all (the products still run);
- ``no_mma``: no wgmma (the accumulators keep what they held);
  ``no_esq``: at D <= 8 no esq pass; ``no_esq_no_select``: both;
- ``no_mma_no_select``: the loop's copies, waits and releases alone;
  ``skeleton_no_loads``: also without copies; ``no_loads``: no ring copies
  (products on whatever shared memory holds);
- ``prologue_only``: the main kernel returns at once; ``main_only``: the
  prologue returns at once; ``empty``: both.

It also prints the main kernel's resident blocks per SM
(``vqt_nearest_blocks_per_sm``). The cut copies compute wrong codes; only
their times mean anything.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import graph_ms, kernels_per_call

SHAPES = [  # (name, N, K, D, dtype, unit rows)
    ("path_f32", 16384, 16384, 8, torch.float32, False),
    ("path_bf16", 16384, 16384, 8, torch.bfloat16, False),
    ("path_normalized", 16384, 16384, 8, torch.float32, True),
    ("flagship_d256", 16384, 16384, 256, torch.float32, False),
]


def graph_us(fn, replays: int) -> list[float]:
    """Microseconds per call of ``fn`` by CUDA-graph replay
    (``chip_smoke.graph_ms``), in three rounds."""
    return [round(1e3 * graph_ms([fn], replays), 3) for _ in range(3)]


NO_BRANCH = [("    if (qm[h] < rbest[h]) {", "    if (qm[h] < -3.0e38f) {")]
NO_SHUFFLE = NO_BRANCH + [
    ("for (int h = 0; h < 2; ++h) qm[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));",
     "for (int h = 0; h < 2; ++h) qm[h] = m[h];"),
    ("for (int h = 0; h < 2; ++h) qm[h] = fminf(qm[h], __shfl_xor_sync(0xffffffffu, qm[h], 2));", "")]
NO_SELECT = [("      select_tile(acc, (t_begin + j) * BN + 2 * t4, rbest, best, bidx);",
              "      if (a.N < 0) select_tile(acc, (t_begin + j) * BN + 2 * t4, rbest, best, bidx);"),
             ("      if (last) select_tile(acc, t * BN + 2 * t4, rbest, best, bidx);",
              "      if (last && a.N < 0) select_tile(acc, t * BN + 2 * t4, rbest, best, bidx);")]
NO_MMA = [('  asm volatile(\n      "{\\n .reg .pred p;\\n setp.ne.b32 p, %69, 0;\\n"',
           '  if (0) asm volatile(\n      "{\\n .reg .pred p;\\n setp.ne.b32 p, %69, 0;\\n"')]
NO_LOADS = [("mbar_expect_tx(bar, E_STAGE * 4 + (last ? B_TILE * 4 : 0) + xc);", "mbar_expect_tx(bar, 0);"),
            ("    bulk_copy(st_e(s), a.eb", "    if (0) bulk_copy(st_e(s), a.eb"),
            ("if (last) bulk_copy(st_q(s)", "if (0) bulk_copy(st_q(s)"),
            ("    if (!x_res)\n      bulk_copy(st_x(s)", "    if (0)\n      bulk_copy(st_x(s)")]
NO_MAIN = [("  const TX* x = static_cast<const TX*>(a.x);\n  const int warp",
            "  if (a.N > 0) return;\n  const TX* x = static_cast<const TX*>(a.x);\n  const int warp")]
NO_PROLOGUE = [("  const TE* e = static_cast<const TE*>(p.e);\n  const int lane",
                "  if (p.K > 0) return;\n  const TE* e = static_cast<const TE*>(p.e);\n  const int lane")]
STAGES16 = [("constexpr int STAGES_REG = 8, STAGES = 4;", "constexpr int STAGES_REG = 16, STAGES = 4;")]
NO_ESQ = [("      wgmma_tf32(acc, ones, b_desc(st_q(s)), 1);\n      wg_commit();\n"
           "      fence_acc(acc);\n    };",
           "      wg_commit();\n      fence_acc(acc);\n    };")]
SKELETON = NO_MMA + NO_SELECT
CUTS = {"shipped": [], "stages16": STAGES16, "no_branch": NO_BRANCH, "no_shuffle": NO_SHUFFLE,
        "no_select": NO_SELECT, "no_mma": NO_MMA, "no_esq": NO_ESQ,
        "no_esq_no_select": NO_ESQ + NO_SELECT, "no_mma_no_select": SKELETON,
        "skeleton_no_loads": SKELETON + NO_LOADS, "no_loads": NO_LOADS,
        "prologue_only": NO_MAIN, "main_only": NO_PROLOGUE, "empty": NO_MAIN + NO_PROLOGUE}


def run_cuts(vq, root: Path, shapes, replays: int) -> None:
    """Time every copy of ``CUTS`` through the wrapper's own launch."""
    from flash_fwd_probe import build
    from vector_quantization_tpu_torch.ops.device import card

    src = (root / "vector_quantization_tpu_torch" / "csrc" / "vq_lookup.cu").read_text()
    libs = build(src, CUTS, root / "vector_quantization_tpu_torch" / "_kernels_build" / "vq_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        lib.vqt_nearest_codes.restype = i
        lib.vqt_nearest_codes.argtypes = [p, i, p, i, p, ctypes.c_longlong, p, i, i, i, i, i, p]
    occ = libs["shipped"][0].vqt_nearest_blocks_per_sm
    occ.restype, occ.argtypes = i, [i, i, i, i, ctypes.POINTER(i)]
    for name, x, e in shapes:
        (n, d), k = x.shape, e.shape[0]
        bf = x.dtype == torch.bfloat16
        pl = vq.plan(n, k, d, bf, bf, card(x.device))
        blocks = i(0)
        err = occ(int(bf), int(bf), int(pl.reg_x), pl.smem_bytes, ctypes.byref(blocks))
        ws = torch.empty((pl.workspace_bytes,), dtype=torch.uint8, device=x.device)
        codes = torch.empty((n,), dtype=torch.int32, device=x.device)
        row = {"shape": name, "plan": pl._asdict(), "blocks_per_sm": blocks.value, "occupancy_err": err}
        for cut, (lib, _) in libs.items():
            def call(lib=lib):
                rc = lib.vqt_nearest_codes(x.data_ptr(), int(bf), e.data_ptr(), int(bf), ws.data_ptr(),
                                           pl.workspace_bytes, codes.data_ptr(), n, k, d,
                                           pl.tiles_per_split, int(pl.x_resident),
                                           torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"vq_lookup_probe: {cut} launch failed: CUDA error {rc}")
            row[cut] = graph_us(call, replays)
        print(json.dumps(row), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replays", type=int, default=20)
    p.add_argument("--cuts", action="store_true")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from vector_quantization_tpu_torch.ops import _build
    from vector_quantization_tpu_torch.ops import vq_lookup as vq

    if not torch.cuda.is_available():
        print("vq_lookup_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log = _build.build_all()["vq_lookup"]
    print(json.dumps({"root": str(root), "ptxas": [ln.strip() for ln in log.splitlines()
                                                   if "Used" in ln or "spill" in ln
                                                   or "Compiling entry" in ln]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    timed = []
    for name, n, k, d, dtype, unit in SHAPES:
        x = torch.randn((n, d), generator=gen, device=dev)
        e = torch.randn((k, d), generator=gen, device=dev)
        if unit:
            x, e = x / x.norm(dim=1, keepdim=True), e / e.norm(dim=1, keepdim=True)
        x, e = x.to(dtype), e.to(dtype)
        rep = vq.compare_codes(x, e, vq.nearest_codes(x, e), vq.nearest_codes_reference(x, e))
        row = {"root": str(root), "shape": name, "N": n, "K": k, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "unit_rows": unit,
               "rows_differing": rep["differ"], "ok": rep["ok"],
               "kernels_per_call": kernels_per_call(lambda: vq.nearest_codes(x, e))}
        row["whole_us"] = graph_us(lambda: vq.nearest_codes(x, e), args.replays)
        esq = 0.5 * (e.float() * e.float()).sum(dim=1)
        xf, ef = x.float(), e.float()
        row["library_us"] = graph_us(
            lambda: torch.argmin(torch.addmm(esq, xf, ef.T, alpha=-1), dim=1), args.replays)
        print(json.dumps(row), flush=True)
        if not rep["ok"]:
            print(f"vq_lookup_probe: {name}: codes disagree beyond near-ties", file=sys.stderr)
            return 1
        if name != "path_normalized":
            timed.append((name, x, e))
        del xf, ef, esq
    if args.cuts:
        run_cuts(vq, root, timed, args.replays)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
