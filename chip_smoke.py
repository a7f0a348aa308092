#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Usage: python3 chip_smoke.py [--seed 0] [--requests 48]

Builds the port's CUDA kernels from ``vector_quantization_tpu_torch/csrc``
(one ``nvcc`` per source, all at once; the ``build`` line gives each
source's ptxas register counts; for the flash forward, dK/dV and dQ
kernels at each head dim, their registers, spill bytes, shared memory and
resident blocks per SM at T = 257; for the paged attention's split kernel
per (query, pool, head dim) type, its registers and spills, and at the
serving shape its plan and resident blocks per SM; for the INT8 matmul's
split-K and wide kernels, their registers, spills and static shared
memory; for the lookup kernel per operand types and D variant, and its
prologue, their registers, spills and static shared memory, with the
lookup's dynamic shared memory and resident blocks per SM at the path
shape), then runs these phases, each printing one JSON line; any failure
exits non-zero:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN convolutions
   for the whole run.
2. ``int8_matmul``: the wrapper, under the plan ``ops/int8_matmul.plan``
   picks per shape (printed with the source that ran and, for the wide
   design, its dynamic shared memory, blocks per SM and clusters at once),
   against its plain version at the serving shapes (B = 64; qkv, o,
   gate+up, down, lm head of Llama-medium), B in {1, 7} and a ragged F
   (both designs run at one shape at least); max relative error <= 1e-3
   (bf16 inputs, f32 sums in another order). Device times per call (CUDA
   graph replay, weights rotated through enough copies to exceed the 50 MB
   L2) for the kernel, the plain version and a yardstick ``library_ms`` =
   ``torch.matmul(x, w_bf16) * scale`` over a pre-dequantised bf16 weight
   (twice the weight bytes: not the same work); then ``decode_step_mean``,
   each time's mean per launch over the decode step's 97 launches.
3. ``paged_decode_attention``: kernel against its plain version at B = 64,
   H = 16, Dh = 64, ps = 64, L = 24 with random page tables and ragged
   lengths (0 and 1 included), int8 pools (limit 1e-4) and bf16 pools
   (limit 2e-3), abs error over max(1, max|ref|). Device times with the
   layer rotated over all 24, at those lengths and at the decode step's own
   (phase 4's positions + 1), each with its bound; ``library_ms`` =
   ``F.scaled_dot_product_attention`` over an already gathered, dequantised
   bf16 dense cache.
4. ``decode_step``: one full-width Llama-medium decode step (24 layers, 16
   heads, hidden 1024, ffn 2816, vocab 17385; bf16, INT8 weights, fused
   qkv, INT8 paged pool, B = 64) on the same inputs twice, through the
   kernels and through the plain versions. Each block, fed the kernel
   path's own input, agrees within max|diff| <= 1e-2 * max|out| (a couple
   of bf16 steps); the logits, after 24 layers of bf16 rounding that
   amplify the kernels' ~3e-7 summation-order differences, within
   max|diff| <= 5e-2 * max|ref|, with >= 90% of rows' argmax equal.
5. ``serving``: ``ARServer`` at that width (weights made from ``--seed``
   with numpy), INT8 KV, page size 64, 64 batch rows (32 CFG streams),
   ``steps_per_sync`` 64, alpha 1.75, top-k 600, top-p 0.92, 256 image
   tokens; ``--requests`` requests so slots turn over. Every request must
   finish with 256 codes in [0, 16384), every page must be freed, K3 and
   each K2 kernel that a serving shape's plan names must have launched,
   and no plain version may have run on a CUDA tensor.
6. ``dense_vs_paged``: the model of phase 4 fed the same 127 prior steps of
   the same tokens (B = 64) through the dense INT8 cache (scalar offset,
   einsum attention) and the paged INT8 pool (K3); the 128th step's logits
   within 5e-2 * max|ref| of the pool's, >= 90% of rows' argmax equal, 24
   K3 launches a step, no plain version on the card. Then K2 against its
   plain version (max relative error <= 1e-3) and timed as in phase 2 at
   the dense path's new shapes: generate()'s gate/up (64, 1024, 2816) and
   the INT8 cache-free forward's (8256, 1024, 2816).
7. ``serving_dense``: ``ARServer()`` with its default engine (dense cache,
   shared column) at bench.py's serving recipe: phase 4's model, 64 rows =
   32 CFG streams, alpha 1.75, top-k 600, top-p 0.92, INT8 KV,
   ``steps_per_sync`` 128 in ``sync_chunk``s of 64, 256 image tokens. Two
   arrival patterns on one server: ``--requests`` up front (aligned), and
   16 up front then 16 more after each sync (staggered). Every request
   finishes with 256 codes in range, the shared column stays within its
   cap, each K2 kernel of phase 5 launches, no plain version on the card;
   effective tokens/s, images/min and the efficiency report per pattern.
8. ``generate``: ``generate()`` as bench.py's ar section runs it: Llama-
   medium bf16 with INT8 weights, unfused (7 K2 launches a layer and the
   head: 169 a forward), B = 64 rows of class 0, 256 tokens, INT8 dense
   cache grown 32 columns a segment, top-k 600, top-p 0.92. Codes (64,
   256) in range, K2 launched 257 x 169 = 43,433 times in one call (the
   prefill and 256 steps), no plain version on the card; tokens/s over the
   median of 3 timed calls after the first.
9. ``vq_lookup``: the nearest-code kernel (TF32 wgmma, an f32 operand
   split in two) against its plain version at the tokenizer's shape N = K
   = 16384, D = 8 (f32 and bf16, Gaussian rows; f32 unit rows, what the
   LlamaGen quantizer feeds), the flagship D = 256, a ragged 1000 x 777 x
   40 (cosine), N = 1, and planted exact ties (duplicated codebook rows,
   f32 and bf16). Codes may differ only as near-ties (both codes' plain
   scores within 1e-5 * max|score| of the row's best: TF32 parts and f32
   sums in another order); planted ties go to the lowest index exactly.
   Each row carries the launch plan ``ops/vq_lookup.plan`` picked. Device
   times (CUDA graph) at the path shapes and the flagship, each beside its
   two bounds (``bound_ms``: this design's on the TF32 tensor cores;
   ``bound_f32_cuda_cores_ms``: the same products on the f32 pipes), the
   kernels one call launches (torch.profiler) and ``library_ms`` =
   ``argmin(addmm(esq/2, x, e^T, alpha=-1))``, which writes and reads the
   N x K matrix (not the same work).
10. ``tokenizer``: the LlamaGen VQGAN (configs/llamagen/vqgan_imagenet_ddp.py,
   built through the port's config loader and registry; 69,593,227
   parameters, weights made from ``--seed`` with numpy in the flax layout
   and loaded through the bridge), f32. 64 images of 256 px: encode_to_quant
   -> (64, 16, 16) codes through the kernel, the same features again
   through the plain lookup (codes agree, near-ties aside),
   decode_from_quant -> (64, 256, 256, 3), and the full forward on 8 images.
   Encode and decode images/s on the host clock (after a warm-up pass of
   the same batch), and the convolutions' and Linears' FLOPs per image.
11. ``class_to_image``: the code grids of the requests that phase 5 served
   -> decode_from_quant -> pixel_decode -> uint8 (requests, 256, 256, 3).
12. ``flash_attention``: K4-fwd, K4-dkv and K4-dq against their plain
   versions (both backward versions fed the kernel's o and lse), bf16, at
   the path shape (B, T, H, Dh) = (64, 257, 16, 64), ragged T in {1, 63,
   64, 65, 129, 256, 300} (the partial first tile at each length), 705
   (the dK/dV kernel's q/dO tiles stream through its ring), B x H = 1, Dh
   32 and 128; o within 2e-3 of max(1, max|ref|)
   beyond one bf16 step of each element (each version rounds its f32 result
   to bf16 once), lse within 1e-4, dq/dk/dv within 1e-2 of max(1, max|ref|) (at T = 1
   dq and dk are 0 up to rounding), the dQ kernel's di = sum(o dO) within
   1e-5 of max(1, max|ref|) of the plain ``_di`` (f32 sums in another
   order); an f32
   input must be refused. Device times at the path shape, all by CUDA-graph
   replay: the kernels, K4's whole backward (dq, which writes di, then dkv),
   the plain versions, and as ``library_ms`` PyTorch's causal flash
   attention (SDPA pinned to its FLASH_ATTENTION backend): its forward, and
   its backward alone (the aten flash backward on residuals made outside
   the graph); ``sdpa_fwd_bwd_ms`` both together.
13. ``ar_train``: ``ARAlgorithm`` from configs/llamagen/c2i_medium_imagenet_ddp.py
   with ``transformer.flash=True`` through the port's config loader and
   registry (Llama-medium, bf16 over f32 params, full per-block remat, fused
   CE, AdamW with the config's warm-up schedule, weight decay 0.05, grad
   clip 1.0), weights made from ``--seed`` (non-zero lm head), the tokenizer
   of phase 7: 3 steps on 64 random 256 px images (K1 -> pack -> K4 -> fused
   CE -> AdamW), then 5 on a batch of 128 code grids (median step time,
   tokens/s, model FLOPs from the config over 989 TFLOP/s). Losses finite,
   every transformer parameter changed and no tokenizer parameter, launches
   per step K4-fwd 48 (24 + 24 remat re-runs), dkv 24, dq 24, K1 once per
   image step, no plain version on the card.
14. ``ar_flash_vs_einsum``: one step's loss and gradients on 64 rows of the
   codes batch with the same weights through flash and through the einsum
   attention (``flash=False``): loss within 1e-2 relative, every
   parameter's gradient within 5e-2 relative L2 (bf16 attention rounds P at
   other places in the two: before and after normalising). Then the train
   step on those 64 rows with each attention (einsum is what the shipped
   configs/ar/transformers/llama.py runs), median of 3 steps on the host
   clock after a warm-up.
15. ``ar_generate``: class -> image through ``ARAlgorithm.generate_step``
   on phase 13's model and state (CFG as the config sets it, alpha 1.75,
   its top-k 600 / top-p 0.92 sampler), 8 classes, then phase 10's VQGAN
   decoder: images (8, 256, 256, 3), finite; seconds per image.
16. ``decode_profile``: the decode step of phase 4 on the host clock and,
   under torch.profiler, its device time; their ratio gives the device's
   idle share (run last: the profiler slows later host dispatch).
17. ``generate_profile``: one decode step of phase 8 at its midpoint (a
   129-column INT8 cache) on the host clock and under torch.profiler:
   device ms, idle share, K2's share.
18. ``tokenizer_profile``: one encode + decode of the 64 images of phase 7
   under torch.profiler: device time by kernel and the idle share.
19. ``ar_train_profile``: one codes train step under torch.profiler:
   device time by kernel and the idle share.
20. ``kernels``: per kernel, launches in its path's run (phase 5 for the
   server's: K2's kernels that the serving shapes' plans name, and K3;
   phase 10 for the lookup, phase 13 for the three flash kernels; K2's
   rows also give their launches in phases 7 and 8, and phase 6's times
   at the dense path's shapes), device time per call, the bound, the plain
   version's and the yardstick's time.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # float32 outside the tensor cores
CSRC = "vector_quantization_tpu_torch/csrc"  # the kernels' sources, from the repo's root

# Llama-medium C2I (configs/ar/transformers/llama.py, bench.py serving recipe)
NUM_CATEGORIES, CODEBOOK = 1000, 16384
MEDIUM = dict(hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=2816)
VOCAB = NUM_CATEGORIES + 1 + CODEBOOK
SLOTS, IMAGE_TOKENS, STEPS_PER_SYNC, PAGE_SIZE = 64, 256, 64, 64
P_SLOT = -(-(IMAGE_TOKENS + STEPS_PER_SYNC) // PAGE_SIZE)  # 5 pages per row
# the dense server's recipe (bench.py serving_bench): 128 steps a sync in chunks of 64
DENSE_STEPS_PER_SYNC, SYNC_CHUNK = 128, 64
MEDIUM_MAX_LENGTH = 1 + IMAGE_TOKENS + DENSE_STEPS_PER_SYNC
SAMPLER = {"temperature": 1.0, "top_k": 600, "top_p": 0.92}
# generate() as bench.py's ar section runs it: Llama-medium INT8, unfused, B = 64
GEN_BATCH, GEN_SEGMENT = 64, 32
GEN_K2_PER_FORWARD = 7 * MEDIUM["num_layers"] + 1  # q, k, v, o, gate, up, down per layer + head
# the LlamaGen VQGAN tokenizer: f16 at 256 px, 16384 x 8 codebook
VQGAN_CONFIG = "configs/llamagen/vqgan_imagenet_ddp.py"
VQGAN_PARAMS, IMAGE_SIZE, GRID, TOKENIZER_BATCH = 69_593_227, 256, 16, 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0 (before a path's run)."""
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention
    from vector_quantization_tpu_torch.ops.vq_lookup import nearest_codes

    int8_matmul.launches = paged_decode_attention.launches = nearest_codes.launches = 0
    int8_matmul.design_launches = dict.fromkeys(int8_matmul.design_launches, 0)
    fa.flash_attention_fwd.launches = fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0


def read_launches() -> tuple[dict, int]:
    """Every kernel's launch count (``int8_matmul`` is K2's split-K kernel,
    ``int8_matmul_wide`` its wide kernel, both behind one wrapper), and the
    number of times any plain version ran on a CUDA tensor so far."""
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops.int8_matmul import (
        DESIGNS, int8_matmul, int8_matmul_reference,
    )
    from vector_quantization_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
    )
    from vector_quantization_tpu_torch.ops.vq_lookup import nearest_codes, nearest_codes_reference

    launches = {**{source: int8_matmul.design_launches[design]
                   for design, (source, _) in DESIGNS.items()},
                "paged_decode_attention": paged_decode_attention.launches,
                "nearest_codes": nearest_codes.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches}
    plain = (int8_matmul_reference.cuda_calls + paged_decode_attention_reference.cuda_calls
             + nearest_codes_reference.cuda_calls + fa.flash_attention_reference.cuda_calls
             + fa.flash_attention_bwd_reference.cuda_calls)
    return launches, plain


def graph_ms(calls, replays: int = 10) -> float:
    """Device milliseconds per call: ``calls`` (a list of thunks) captured
    once into a CUDA graph, replayed ``replays`` times between CUDA
    events. Host overhead of the Python wrappers is out of the number."""
    for c in calls:  # eager warm-up: builds, allocations
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (replays * len(calls))


def phase_device() -> tuple[str, dict]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    return smi, {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": torch.cuda.device_count()}


_MANGLED_TYPES = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}


def ptxas_entries(log: str, kernel: str, params: tuple[str, ...] = ("dh",)) -> dict:
    """Registers, static shared memory and spill bytes that ``nvcc -Xptxas -v``
    reports for each instantiation of ``kernel``, keyed by its template
    arguments named by ``params`` ("dh64" for the flash kernels' head dim;
    "qbf16_kvint8_dh64" for the paged attention's query type, pool type and
    head dim; the kernel's own name when ``params`` is empty, for a kernel
    that is not a template)."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(kernel + r"I(.*?)EEv", m.group(1))
            key = kernel if kernel in m.group(1) and not params else None
            if k and params:
                vals = []  # a repeated type is a back-reference (S_, S0_, ...) to the last one
                for n, t, _ in re.findall(r"L[ib](\d+)E|(13__nv_bfloat16|[fa])(?=L|13|S|[fa]|E)|(S\d*_)",
                                            k.group(1) + "E"):
                    vals.append(n or (_MANGLED_TYPES[t] if t else vals[-1]))
                key = "_".join(f"{p}{v}" for p, v in zip(params, vals))
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(key, {}).update(registers=int(m.group(1)),
                                           static_smem=int(smem.group(1)) if smem else 0)
    return out


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Resident blocks per SM of an H100 for a kernel's registers per thread,
    threads per block and shared memory per block (65,536 registers
    allocated 256 to a warp, 2,048 threads, 32 blocks, 233,472 bytes of
    shared memory with 1,024 reserved per block)."""
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = 65536 // warp_regs // (threads // 32)
    return min(32, 2048 // threads, by_regs, 233472 // (smem + 1024))


def phase_build() -> None:
    from vector_quantization_tpu_torch.ops import _build
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops import int8_matmul as im
    from vector_quantization_tpu_torch.ops import paged_attention as pa
    from vector_quantization_tpu_torch.ops import vq_lookup as vqk

    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {
        name: sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln})
        for name, log in logs.items()
    }
    fwd = ptxas_entries(logs["flash_attention"], "flash_fwd_kernel")
    for dh, entry in fwd.items():
        entry.update(fa.flash_fwd_plan(SEQ, int(dh[2:])))
    dkv = ptxas_entries(logs["flash_attention"], "flash_bwd_dkv_kernel")
    for dh, entry in dkv.items():
        entry.update(fa.flash_bwd_dkv_plan(SEQ, int(dh[2:])))
    dq = ptxas_entries(logs["flash_attention"], "flash_bwd_dq_kernel")
    for dh, entry in dq.items():
        entry.update(fa.flash_bwd_dq_plan(SEQ, int(dh[2:])))
    paged = ptxas_entries(logs["paged_attention"], "paged_split_kernel", ("q", "kv", "dh"))
    plan = pa.decode_plan(SLOTS, MEDIUM["num_heads"], 64, P_SLOT, PAGE_SIZE, torch.int8,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    paged_path = {**paged.get("qbf16_kvint8_dh64", {}), **plan._asdict(),
                  "blocks_per_sm": pa.decode_occupancy(plan, torch.bfloat16, torch.int8, 64)}
    mm = {kernel: entry for source, kernel in im.DESIGNS.values()
          for entry in ptxas_entries(logs[source], kernel, ()).values()}
    vq = ptxas_entries(logs["vq_lookup"], "nearest_tc_kernel", ("x", "e", "reg"))
    vq_prep = ptxas_entries(logs["vq_lookup"], "prep_kernel", ("x", "e"))
    gpu = im.card(torch.device("cuda", 0))
    for key, entry in vq.items():  # the plan and resident blocks at the path shape, this key's types
        x_bf16, e_bf16, reg = key.startswith("xbf16"), "_ebf16" in key, key.endswith("reg1")
        d = 8 if reg else 256
        p = vqk.plan(TOKENIZER_BATCH * GRID * GRID, CODEBOOK, d, x_bf16, e_bf16, gpu)
        entry.update(at_d=d, smem_bytes=p.smem_bytes, blocks_per_sm=vqk.blocks_per_sm(p, x_bf16, e_bf16))
    if "w8a16_kernel" in mm:
        split = mm["w8a16_kernel"]
        split["blocks_per_sm"] = blocks_per_sm(split["registers"], 256, split["static_smem"])
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(logs), "ptxas": regs, "flash_fwd_at_t257": fwd,
          "flash_bwd_dkv_at_t257": dkv, "flash_bwd_dq_at_t257": dq, "paged_attention": paged,
          "paged_attention_at_path": paged_path, "int8_matmul": mm,
          "vq_lookup": vq, "vq_lookup_prologue": vq_prep})
    if (not fwd or not dkv or not dq or "registers" not in paged_path or len(vq) != 8
            or len(vq_prep) != 4
            or {kernel for _, kernel in im.DESIGNS.values()} - set(mm)):
        raise SystemExit("build: a kernel's entry is missing from the ptxas log")


def serving_matmuls() -> list[tuple[str, int, int, int, int]]:
    """The decode step's INT8 matmuls: (name, B, D, F, launches per step)."""
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    return [("qkv", SLOTS, d, 3 * d, 24), ("o", SLOTS, d, d, 24),
            ("gateup", SLOTS, d, 2 * f, 24), ("down", SLOTS, f, d, 24),
            ("lm_head", SLOTS, d, VOCAB, 1)]


def phase_int8_matmul(dev, gen) -> list[dict]:
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    d = MEDIUM["hidden_size"]
    extra = [("b1_qkv", 1, d, 3 * d, 0), ("b7_lm_head", 7, d, VOCAB, 0),
             ("ragged", 5, 1000, 777, 0)]
    rows = []
    for name, b, dd, ff, per_step in serving_matmuls() + extra:
        x = torch.randn((b, dd), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (dd, ff), generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((ff,), generator=gen, device=dev) * 0.02 + 1e-3
        p = im.plan_for(x, w)
        got = im.int8_matmul(x, w, s)
        want = im.int8_matmul_reference(x, w, s)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        row = {"phase": "int8_matmul", "shape": name, "B": b, "D": dd, "F": ff,
               "plan": p._asdict(), "source": f"{CSRC}/{p.source}.cu",
               **(im.occupancy(p, b, dd, ff) if p.design == "wide" else {}),
               "max_abs_err": abs_err, "max_rel_err": rel_err, "limit": 1e-3}
        if rel_err > 1e-3 or not torch.isfinite(got).all():
            emit(row)
            raise SystemExit(f"int8_matmul {name}: max_rel_err {rel_err} > 1e-3")
        if per_step:
            copies = -(-150_000_000 // (dd * ff))  # > 50 MB L2 per rotation
            ws = [w] + [torch.randint(-127, 128, (dd, ff), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(copies - 1)]
            wb = [wi.to(torch.bfloat16) for wi in ws]
            byts = dd * ff + b * dd * 2 + ff * 4 + b * ff * 4
            ops = 2 * b * dd * ff
            row.update({
                "launches_per_step": per_step, "weight_copies": copies,
                "ms": graph_ms([lambda wi=wi: im.int8_matmul(x, wi, s) for wi in ws]),
                "plain_ms": graph_ms([lambda wi=wi: im.int8_matmul_reference(x, wi, s)
                                      for wi in ws]),
                "library_ms": graph_ms([lambda wi=wi: torch.matmul(x, wi) * s for wi in wb]),
                "bytes": byts, "ops": ops,
                "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / BF16_FLOPS),
            })
            rows.append(row)
            del ws, wb
        emit(row)

    def per_launch(rs, key):
        return sum(r[key] * r["launches_per_step"] for r in rs) / sum(
            r["launches_per_step"] for r in rs)

    # K2 as a whole: one decode step's 97 launches, each shape under its plan
    emit({"phase": "int8_matmul", "shape": "decode_step_mean",
          "launches_per_step": sum(r["launches_per_step"] for r in rows),
          **{k: per_launch(rows, k) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}})
    kernels = []
    for design, (source, _) in im.DESIGNS.items():
        mine = [r for r in rows if r["plan"]["design"] == design]
        if not mine:
            continue
        kernels.append({
            "name": source, "design": design, "route": "cuda", "source": f"{CSRC}/{source}.cu",
            "replaces": "vector_quantization_tpu/ops/int8_matmul.py:54",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_launch(mine, "ms"), "plain_ms": per_launch(mine, "plain_ms"),
            "bound_ms": per_launch(mine, "bound_ms"), "bound_by": "bytes",
            "library_ms": per_launch(mine, "library_ms"),
            "note": "mean per launch over the decode step's launches of this kernel: "
                    + ", ".join(f"{r['launches_per_step']}x {r['shape']}" for r in mine),
        })
    return kernels


def phase_paged_attention(dev, gen) -> dict:
    import torch.nn.functional as F

    from vector_quantization_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
    )
    from vector_quantization_tpu_torch.ops.paged_kv import PagedKVCache, paged_gather

    b, h, dh, ps, n_layers = SLOTS, MEDIUM["num_heads"], 64, PAGE_SIZE, MEDIUM["num_layers"]
    p_slot = P_SLOT
    num_pages = 1 + b * p_slot
    rng = np.random.default_rng(0)
    table_np = np.resize(rng.permutation(np.arange(1, num_pages)), (b, p_slot + 1)).astype(np.int32)
    len_np = rng.integers(0, p_slot * ps + 1, b).astype(np.int32)
    len_np[:4] = [0, 1, ps, ps + 1]
    table = torch.from_numpy(table_np).to(dev)[:, :p_slot]  # sliced: rows strided
    lengths = torch.from_numpy(len_np).to(dev)
    live = int(np.minimum(len_np, p_slot * ps).sum())
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    shape = (n_layers, num_pages, ps, h, dh)
    kernel_row = None
    for pool in ("int8", "bf16"):
        if pool == "int8":
            k = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            ksc = torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3
            vsc = torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3
            tol, elt = 1e-4, 1
        else:
            k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            ksc = vsc = None
            tol, elt = 2e-3, 2
        kw = dict(k_scale_pool=ksc, v_scale_pool=vsc)
        err = 0.0
        for layer in (0, 13, n_layers - 1):
            got = paged_decode_attention(q, k, v, table, lengths, layer, **kw)
            want = paged_decode_attention_reference(q, k, v, table, lengths, layer, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or bool((got[0] != 0).any()):
                raise SystemExit(f"paged_decode_attention {pool}: non-finite or length-0 row not 0")
            err = max(err, float((got - want).abs().max()) / max(1.0, float(want.abs().max())))
        row = {"phase": "paged_decode_attention", "pool": pool, "B": b, "H": h, "Dh": dh,
               "ps": ps, "L": n_layers, "P": num_pages, "P_cap": p_slot,
               "mean_length": float(len_np.mean()), "max_err": err, "limit": tol}
        if err > tol:
            emit(row)
            raise SystemExit(f"paged_decode_attention {pool}: max_err {err} > {tol}")
        layers = range(n_layers)
        byts = live * h * (2 * dh * elt + (8 if pool == "int8" else 0)) \
            + b * h * dh * (2 + 4) + table.numel() * 4 + b * 4
        ops = live * h * 4 * dh
        # yardstick: SDPA over an already gathered, dequantised dense cache
        dense = []
        for layer in range(4):
            kg, vg, ks, vs = paged_gather(PagedKVCache(k, v, table, ksc, vsc), layer)
            kg, vg = kg.float(), vg.float()
            if ks is not None:
                kg, vg = kg * ks[..., None], vg * vs[..., None]
            dense.append((kg.to(torch.bfloat16).transpose(1, 2).contiguous(),
                          vg.to(torch.bfloat16).transpose(1, 2).contiguous()))
        mask = (torch.arange(p_slot * ps, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        # the decode step's own lengths (phase decode_step: positions + 1)
        step_len = torch.from_numpy(decode_positions()[1] + 1).to(dev)
        step_live = int(step_len.sum())
        step_bytes = byts + (step_live - live) * h * (2 * dh * elt + (8 if pool == "int8" else 0))
        row.update({
            "ms": graph_ms([lambda i=i: paged_decode_attention(q, k, v, table, lengths, i, **kw)
                            for i in layers]),
            "decode_lengths_mean": step_live / b,
            "decode_lengths_ms": graph_ms([lambda i=i: paged_decode_attention(
                q, k, v, table, step_len, i, **kw) for i in layers]),
            "decode_lengths_bound_ms": 1e3 * max(step_bytes / HBM_BYTES_PER_S,
                                                 step_live * h * 4 * dh / F32_FLOPS),
            "plain_ms": graph_ms([lambda i=i: paged_decode_attention_reference(
                q, k, v, table, lengths, i, **kw) for i in layers], replays=3),
            "library_ms": graph_ms([lambda kv=kv: F.scaled_dot_product_attention(
                q4, kv[0], kv[1], attn_mask=mask) for kv in dense]),
            "bytes": byts, "ops": ops,
            "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / F32_FLOPS),
        })
        emit(row)
        if pool == "int8":
            kernel_row = row
        del k, v, ksc, vsc, dense
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": f"{CSRC}/paged_attention.cu",
        "replaces": "vector_quantization_tpu/ops/paged_attention.py:110",
        "max_abs_err": kernel_row["max_err"], "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"], "bound_ms": kernel_row["bound_ms"],
        "bound_by": "bytes", "library_ms": kernel_row["library_ms"],
        "note": f"int8 pool, B=64, mean live length {kernel_row['mean_length']}",
    }


def medium_flax_params(seed: int) -> dict:
    """Float Llama-medium params in the flax layout, made from ``seed`` with
    numpy: N(0, 0.02) embedding, projections and (non-zero) lm head; norm
    scales 1."""
    rng = np.random.default_rng(seed)
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    params = {"embedding": normal(VOCAB, d), "final_norm": {"scale": np.ones(d, np.float32)},
              "lm_head": normal(d, VOCAB)}
    for i in range(MEDIUM["num_layers"]):
        params[f"layer{i}"] = {
            "input_norm": {"scale": np.ones(d, np.float32)},
            "post_norm": {"scale": np.ones(d, np.float32)},
            **{p: {"kernel": normal(d, d)} for p in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "gate_proj": {"kernel": normal(d, f)}, "up_proj": {"kernel": normal(d, f)},
            "down_proj": {"kernel": normal(f, d)},
        }
    return params


@functools.lru_cache(maxsize=None)
def medium_int8_params(seed: int) -> dict:
    """:func:`medium_flax_params` with INT8 projections and head, unfused."""
    from vector_quantization_tpu_torch.models.transformers.llama import quantize_params_int8

    return quantize_params_int8(medium_flax_params(seed))


def make_medium(seed: int, dev, fused: bool = True, max_length: int = MEDIUM_MAX_LENGTH):
    """Llama-medium bf16 with INT8 weights (fused projections unless
    ``fused=False``), weights made from ``seed`` with numpy in the flax
    layout and loaded via the bridge."""
    from vector_quantization_tpu_torch.models.transformers.llama import (
        LlamaTransformer, fuse_llama_params,
    )
    from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

    params = medium_int8_params(seed)
    if fused:
        params = fuse_llama_params(params)
    model = LlamaTransformer(vocabulary_size=VOCAB, max_length=max_length, dtype="bfloat16",
                             quantize=True, fused_qkv=fused, **MEDIUM)
    model.load_state_dict(llama_params_from_flax(params))
    return model.to(dev).eval()


def step_wall(model, tokens, cache, positions, steps: int = 3) -> float:
    """Seconds per eager decode step on the host clock, each ending in a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model(tokens, cache, slot_positions=positions)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def step_device(model, tokens, cache, positions, steps: int = 3) -> float:
    """Device seconds per decode step: the sum of the kernels' device time
    that torch.profiler records over ``steps`` steps. Run last: the
    profiler's tracing slows later host dispatch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model(tokens, cache, slot_positions=positions)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    if device_us <= 0:
        raise SystemExit("decode_profile: the profiler recorded no device time")
    return device_us / steps / 1e6


def decode_positions() -> tuple[np.random.Generator, np.ndarray]:
    """The decode step's slot positions (rows 0 and 1 at position 0), and
    the generator that goes on to make its page table and tokens."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, IMAGE_TOKENS, SLOTS).astype(np.int32)
    pos[:2] = 0
    return rng, pos


def phase_decode_step(model, dev, gen):
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul_reference
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention_reference

    b, ps, p_slot = SLOTS, PAGE_SIZE, P_SLOT
    num_pages = 1 + b * p_slot
    cache = model.init_paged_cache(b, num_pages, ps, p_slot, dtype=torch.int8, device=dev)
    rng, pos_np = decode_positions()
    table = np.zeros((b, p_slot), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for r in range(b):
        for p in range(pos_np[r] // ps + 1):
            table[r, p] = free.pop()
    cache.page_table.copy_(torch.from_numpy(table))
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02)
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (b, 1)).astype(np.int32)).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)

    def clone():
        return cache._replace(**{f: getattr(cache, f).clone()
                                 for f in ("k", "v", "k_scale", "v_scale")})

    blocks = model.blocks()
    ins, outs = [], []
    hooks = [blk.register_forward_pre_hook(lambda m, a: ins.append(a[0].clone()))
             for blk in blocks]
    hooks += [blk.register_forward_hook(lambda m, a, o: outs.append(o.clone()))
              for blk in blocks]
    with torch.inference_mode():
        got, _ = model(tokens, clone(), slot_positions=positions)
        for hk in hooks:
            hk.remove()
        step_s = step_wall(model, tokens, clone(), positions)
        saved = llama_mod.int8_matmul, llama_mod.paged_decode_attention
        llama_mod.int8_matmul = int8_matmul_reference
        llama_mod.paged_decode_attention = paged_decode_attention_reference
        try:
            want, _ = model(tokens, clone(), slot_positions=positions)
            # each block alone on the kernel path's own input: no cascade
            c = clone()
            layer_err = max(
                float((blk(ins[i], positions[:, None], c, i, positions) - outs[i]).abs().max())
                / float(outs[i].abs().max())
                for i, blk in enumerate(blocks)
            )
        finally:
            llama_mod.int8_matmul, llama_mod.paged_decode_attention = saved
        torch.cuda.synchronize()
    err = float((got - want).abs().max()) / float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    row = {"phase": "decode_step", "B": b, "vocab": VOCAB, **MEDIUM, "dtype": "bfloat16",
           "logits_shape": list(got.shape), "max_abs_err_over_max_ref": err, "limit": 5e-2,
           "mean_abs_diff": float((got - want).abs().mean()),
           "mean_abs_ref": float(want.abs().mean()), "argmax_agree_frac": agree,
           "per_block_max_err_over_max_ref": layer_err, "per_block_limit": 1e-2,
           "eager_step_ms_host_clock": 1e3 * step_s}
    emit(row)
    if (got.shape != (b, 1, VOCAB) or not torch.isfinite(got).all() or err > 5e-2
            or layer_err > 1e-2 or agree < 0.9):
        raise SystemExit("decode_step: kernel and plain paths disagree (see the decode_step line)")

    def profile_step() -> None:
        with torch.inference_mode():
            wall = step_wall(model, tokens, clone(), positions)
            device = step_device(model, tokens, clone(), positions)
        emit({"phase": "decode_profile", "eager_step_ms_host_clock": 1e3 * wall,
              "device_ms_per_step_profiler": 1e3 * device,
              "device_idle_frac": 1.0 - device / wall})

    return profile_step


def phase_serving(model, dev, seed: int, n_requests: int,
                  k2_kernels: list[str]) -> tuple[dict, dict]:
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    server = ARServer(
        model, None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK),
        image_tokens=IMAGE_TOKENS, batch_slots=SLOTS,
        sampler={"temperature": 1.0, "top_k": 600, "top_p": 0.92},
        cfg_alpha=1.75, uncond_token=NUM_CATEGORIES, steps_per_sync=STEPS_PER_SYNC,
        cache_dtype=torch.int8, paged=True, page_size=PAGE_SIZE, seed=seed, device=dev,
    )
    rids = [server.submit(category=i % NUM_CATEGORIES) for i in range(n_requests)]
    zero_launches()
    _, plain0 = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = dict(server.run_until_drained())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_launches()
    plain_runs = plain - plain0
    rep = server.efficiency_report()
    row = {"phase": "serving", "requests": n_requests, "finished": len(done),
           "image_tokens": IMAGE_TOKENS, "batch_slots": SLOTS, "steps_per_sync": STEPS_PER_SYNC,
           "wall_s": wall, "effective_tokens_per_s": n_requests * IMAGE_TOKENS / wall,
           "images_per_min": n_requests / wall * 60.0, "launches": launches,
           "plain_runs_on_cuda": plain_runs,
           "pages_free": len(server._free_pages), "pages_total": server._total_pages,
           "efficiency_report": rep}
    emit(row)
    ok = (sorted(done) == rids
          and all(c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all()
                  for c in done.values())
          and len(server._free_pages) == server._total_pages and server._pages_reserved == 0
          and all(launches[k] > 0 for k in k2_kernels)
          and launches["paged_decode_attention"] > 0
          and plain_runs == 0)
    if not ok:
        raise SystemExit("serving: a check failed (see the serving line)")
    return launches, done


def k2_launches(launches: dict) -> int:
    """K2's launches over both of its kernels."""
    from vector_quantization_tpu_torch.ops.int8_matmul import DESIGNS

    return sum(launches[source] for source, _ in DESIGNS.values())


def int8_matmul_row(dev, gen, name: str, b: int, d: int, f: int) -> dict:
    """K2 through ``int8_matmul`` (the plan's kernel) against its plain
    version at one shape, and the three device times of phase
    ``int8_matmul`` (weights rotated past the L2)."""
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    ws = [torch.randint(-127, 128, (d, f), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(-(-150_000_000 // (d * f)))]
    s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
    got, want = im.int8_matmul(x, ws[0], s), im.int8_matmul_reference(x, ws[0], s)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    p = im.plan_for(x, ws[0])
    byts, ops = d * f + b * d * 2 + f * 4 + b * f * 4, 2 * b * d * f
    row = {"phase": "int8_matmul", "shape": name, "B": b, "D": d, "F": f, "plan": p._asdict(),
           "source": f"{CSRC}/{p.source}.cu", "max_abs_err": abs_err,
           "max_rel_err": abs_err / float(want.abs().max()), "limit": 1e-3,
           "weight_copies": len(ws), "bytes": byts, "ops": ops,
           "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / BF16_FLOPS),
           "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= ops / BF16_FLOPS else "operations"}
    if row["max_rel_err"] > 1e-3 or not torch.isfinite(got).all():
        emit(row)
        raise SystemExit(f"int8_matmul {name}: max_rel_err {row['max_rel_err']} > 1e-3")
    wb = [w.to(torch.bfloat16) for w in ws]
    row.update({
        "ms": graph_ms([lambda w=w: im.int8_matmul(x, w, s) for w in ws]),
        "plain_ms": graph_ms([lambda w=w: im.int8_matmul_reference(x, w, s) for w in ws], replays=3),
        "library_ms": graph_ms([lambda w=w: torch.matmul(x, w) * s for w in wb], replays=3),
    })
    emit(row)
    return row


def phase_dense_vs_paged(model, dev, gen, seed: int) -> list[dict]:
    """One decode step at full width (the fused INT8 model) over the dense
    INT8 cache (einsum attention) and over the paged INT8 pool (K3), both
    filled by the same 127 prior steps of the same tokens; then K2 at the
    dense path's new shapes."""
    b, n = SLOTS, 128
    p_slot = -(-n // PAGE_SIZE)
    toks = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, VOCAB, (n, b, 1)).astype(np.int32)).to(dev)
    dense = model.init_cache(b, dtype=torch.int8, rows=n)
    paged = model.init_paged_cache(b, 1 + b * p_slot, PAGE_SIZE, p_slot, dtype=torch.int8,
                                   device=dev)
    paged.page_table.copy_(torch.arange(1, 1 + b * p_slot, device=dev).reshape(b, p_slot))
    zero_launches()
    _, plain0 = read_launches()
    with torch.inference_mode():
        for i in range(n):
            got, dense = model(toks[i], dense)
            want, paged = model(toks[i], paged, slot_positions=torch.full(
                (b,), i, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    launches, plain = read_launches()
    err = float((got - want).abs().max()) / float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    row = {"phase": "dense_vs_paged", "B": b, "steps": n, "vocab": VOCAB, **MEDIUM,
           "dense_cache_columns": dense.window, "paged_pages_per_row": p_slot,
           "max_abs_err_over_max_ref": err, "limit": 5e-2, "argmax_agree_frac": agree,
           "argmax_limit": 0.9, "ref": "paged pool through K3", "launches": launches,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if (got.shape != (b, 1, VOCAB) or not torch.isfinite(got).all() or err > 5e-2 or agree < 0.9
            or plain != plain0 or launches["paged_decode_attention"] != n * MEDIUM["num_layers"]):
        raise SystemExit("dense_vs_paged: the dense and paged decode disagree (see its line)")
    del dense, paged
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    return [int8_matmul_row(dev, gen, "generate_gate_up", GEN_BATCH, d, f),
            int8_matmul_row(dev, gen, "int8_prefill_gate_up", GEN_BATCH * 129, d, f)]


def phase_serving_dense(model, dev, seed: int, n_requests: int, k2_kernels: list[str]):
    """``ARServer()`` with its default engine (dense, shared column) at the
    bench recipe; two arrival patterns on one server: aligned (every
    request up front) and staggered (16 up front, 16 more after each
    sync)."""
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    server = ARServer(
        model, None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK), image_tokens=IMAGE_TOKENS,
        batch_slots=SLOTS, sampler=SAMPLER, cfg_alpha=1.75, uncond_token=NUM_CATEGORIES,
        steps_per_sync=DENSE_STEPS_PER_SYNC, sync_chunk=SYNC_CHUNK, cache_dtype=torch.int8,
        seed=seed, device=dev,
    )
    max_col = 0

    def serve(staggered: bool):
        nonlocal max_col
        submitted = 0
        for _ in range(min(16, n_requests) if staggered else n_requests):
            server.submit(category=submitted % NUM_CATEGORIES)
            submitted += 1
        done = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while server.pending or submitted < n_requests:
            done.extend(server.step())
            max_col = max(max_col, server.col)
            for _ in range(min(16, n_requests - submitted) if staggered else 0):
                server.submit(category=submitted % NUM_CATEGORIES)
                submitted += 1
        torch.cuda.synchronize()
        return dict(done), time.perf_counter() - t0

    zero_launches()
    _, plain0 = read_launches()
    rows, ok = {}, server._shared_col
    for pattern in ("aligned", "staggered"):
        for key in server.stats:  # count each pattern's run alone
            server.stats[key] = 0 if isinstance(server.stats[key], int) else 0.0
        first = server._next_id
        done, wall = serve(pattern == "staggered")
        rows[pattern] = {"requests": n_requests, "finished": len(done), "wall_s": wall,
                         "effective_tokens_per_s": n_requests * IMAGE_TOKENS / wall,
                         "images_per_min": n_requests / wall * 60.0,
                         "efficiency_report": server.efficiency_report()}
        ok = ok and sorted(done) == list(range(first, first + n_requests)) and all(
            c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all()
            for c in done.values())
    launches, plain = read_launches()
    row = {"phase": "serving_dense", "engine": "shared_column" if server._shared_col else "scatter",
           "image_tokens": IMAGE_TOKENS, "batch_slots": SLOTS,
           "steps_per_sync": DENSE_STEPS_PER_SYNC, "sync_chunk": SYNC_CHUNK, **rows,
           "staggered_over_aligned": rows["staggered"]["effective_tokens_per_s"]
           / rows["aligned"]["effective_tokens_per_s"],
           "max_col": max_col, "sc_cap": server._sc_cap, "launches": launches,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if not (ok and max_col <= server._sc_cap and all(launches[k] > 0 for k in k2_kernels)
            and plain == plain0):
        raise SystemExit("serving_dense: a check failed (see the serving_dense line)")
    return launches


def phase_generate(dev, seed: int):
    """``generate()`` as bench.py's ar section runs it, through the port:
    Llama-medium INT8 unfused, B = 64 rows of class 0, 256 tokens, INT8
    dense cache grown 32 columns a segment, top-k 600 / top-p 0.92."""
    from vector_quantization_tpu_torch.ops.int8_matmul import DESIGNS
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook, generate

    model = make_medium(seed, dev, fused=False, max_length=1 + IMAGE_TOKENS)
    codebook = TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK)
    prefix = torch.zeros((GEN_BATCH, 1), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run():
        return generate(model, prefix, IMAGE_TOKENS, codebook, gen, sampler=SAMPLER,
                        cache_dtype=torch.int8, kv_segment=GEN_SEGMENT)

    zero_launches()
    _, plain0 = read_launches()
    codes, first_s = _timed(run)
    launches, plain = read_launches()
    times = [_timed(run)[1] for _ in range(3)]
    wall = float(np.median(times))
    want_k2 = (1 + IMAGE_TOKENS) * GEN_K2_PER_FORWARD
    row = {"phase": "generate", "B": GEN_BATCH, "tokens": IMAGE_TOKENS, "kv_segment": GEN_SEGMENT,
           "cache": "int8", "weights": "int8, unfused", **MEDIUM, "sampler": SAMPLER,
           "codes_shape": list(codes.shape), "first_call_s": first_s, "timed_calls_s": times,
           "tokens_per_s": GEN_BATCH * IMAGE_TOKENS / wall,
           "ms_per_token": 1e3 * wall / IMAGE_TOKENS, "launches": launches,
           "k2_launches": k2_launches(launches), "k2_launches_expected": want_k2,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if (codes.shape != (GEN_BATCH, IMAGE_TOKENS) or codes.dtype != torch.int32
            or bool((codes < 0).any()) or bool((codes >= CODEBOOK).any())
            or row["k2_launches"] != want_k2 or plain != plain0):
        raise SystemExit("generate: a check failed (see the generate line)")

    def profile_generate_step() -> None:
        """One decode step of generate() at its midpoint (token 128: the
        cache of 129 columns, the segment that holds it), on the host clock
        and under torch.profiler: device ms, idle share, K2's share."""
        from torch.profiler import ProfilerActivity, profile

        rows, length = 1 + 128, 128
        cache = model.init_cache(GEN_BATCH, dtype=torch.int8, rows=rows)
        g = torch.Generator(device=dev).manual_seed(seed)
        for t in (*cache.k, *cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev, dtype=torch.int8))
        for t in (*cache.k_scale, *cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device=dev) * 0.02)
        cache = cache._replace(length=length)
        tok = torch.randint(0, VOCAB, (GEN_BATCH, 1), generator=g, device=dev, dtype=torch.int32)
        with torch.inference_mode():
            model(tok, cache)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                model(tok, cache)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / 3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    model(tok, cache)
                torch.cuda.synchronize()
        events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events) / 3
        if device_us <= 0:
            raise SystemExit("generate_profile: the profiler recorded no device time")
        k2_us = sum(e.self_device_time_total for e in events
                    if any(kernel in e.key for _, kernel in DESIGNS.values())) / 3
        emit({"phase": "generate_profile", "B": GEN_BATCH, "cache_columns": rows,
              "step_ms_host_clock": 1e3 * host, "device_ms_per_step_profiler": device_us / 1e3,
              "device_idle_frac": 1.0 - device_us / 1e6 / host, "k2_device_ms": k2_us / 1e3,
              "k2_share_of_device": k2_us / device_us,
              "top_kernels": [{"name": e.key[:90], "calls": e.count / 3,
                               "ms_per_step": e.self_device_time_total / 3e3}
                              for e in events[:10]]})

    return launches, profile_generate_step


def phase_ar_generate(algo, state, dev, seed: int) -> None:
    """Class -> image through ``ARAlgorithm.generate_step``: the LlamaGen
    C2I model of phase ``ar_train`` with CFG as its config sets it, 8
    classes, the VQGAN decoder of phase ``tokenizer``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    category = torch.arange(0, NUM_CATEGORIES, NUM_CATEGORIES // 8, device=dev)[:8]
    zero_launches()
    images, wall = _timed(lambda: algo.generate_step(state, category, gen))
    launches, _ = read_launches()
    row = {"phase": "ar_generate", "classes": int(category.numel()), "cfg": algo.cfg,
           "cfg_alpha": algo.cfg_alpha, "sampler": algo.sampler,
           "transformer_dtype": str(algo.model.dtype).removeprefix("torch."),
           "images_shape": list(images.shape), "wall_s": wall,
           "s_per_image": wall / category.numel(), "launches": launches}
    emit(row)
    if images.shape != (8, IMAGE_SIZE, IMAGE_SIZE, 3) or not torch.isfinite(images).all():
        raise SystemExit("ar_generate: the generated images are not (8, 256, 256, 3) and finite")


TF32_FLOPS = 495e12  # dense tensor-core TF32


def lookup_bounds(n: int, k: int, d: int, x_dtype, e_dtype) -> dict:
    """K1's two bounds in ms. ``bound_ms``: this design's, the largest of the
    bytes (x and the codebook read once, the codes written once) over the
    card's memory rate, the TF32 passes (3 for f32 x f32, 2 for a mixed pair,
    1 for bf16 x bf16) x 2NKD over the tensor cores' TF32 rate, and one
    compare per score (NK) at the f32 rate. ``bound_f32_cuda_cores_ms``: the
    products and compares (2NKD + 2NK) at the f32 rate outside the tensor
    cores."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    byts = n * d * size[x_dtype] + k * d * size[e_dtype] + n * 4
    passes = 1 + (x_dtype == torch.float32) + (e_dtype == torch.float32)
    terms = {"bytes": byts / HBM_BYTES_PER_S, "tensor_core_passes": passes * 2 * n * k * d / TF32_FLOPS,
             "compares": n * k / F32_FLOPS}
    return {"bytes": byts, "tf32_passes": passes, "bound_ms": 1e3 * max(terms.values()),
            "bound_term": max(terms, key=terms.get),
            "bound_f32_cuda_cores_ms": 1e3 * (2 * n * k * d + 2 * n * k) / F32_FLOPS}


def kernels_per_call(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:60] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_vq_lookup(dev, gen) -> dict:
    from vector_quantization_tpu_torch.ops.device import card
    from vector_quantization_tpu_torch.ops.vq_lookup import (
        NEAR_TIE_REL_TOL, compare_codes, nearest_codes, nearest_codes_reference, plan,
    )

    n_path = TOKENIZER_BATCH * GRID * GRID
    cases = [  # (name, N, K, D, dtype, metric, rows, timed)
        ("path_f32", n_path, CODEBOOK, 8, torch.float32, "l2", "gaussian", True),
        ("path_bf16", n_path, CODEBOOK, 8, torch.bfloat16, "l2", "gaussian", True),
        ("path_normalized", n_path, CODEBOOK, 8, torch.float32, "l2", "unit", True),
        ("flagship_d256", 16384, 16384, 256, torch.float32, "l2", "gaussian", True),
        ("ragged_cosine", 1000, 777, 40, torch.float32, "cosine", "gaussian", False),
        ("n1", 1, CODEBOOK, 8, torch.float32, "l2", "gaussian", False),
        ("planted_ties", 4096, 1000, 8, torch.float32, "l2", "ties", False),
        ("planted_ties_bf16", 4096, 1000, 8, torch.bfloat16, "l2", "ties", False),
    ]
    kernel_row = None
    for name, n, k, d, dtype, metric, rows, timed in cases:
        x = torch.randn((n, d), generator=gen, device=dev)
        e = torch.randn((k, d), generator=gen, device=dev)
        if rows == "unit":  # the LlamaGen quantizer looks up l2-normalised rows
            x, e = x / x.norm(dim=1, keepdim=True), e / e.norm(dim=1, keepdim=True)
        if rows == "ties":  # odd codes repeat the even ones; every third row sits on one
            e[1::2] = e[0::2][: k // 2]
            x[::3] = e[torch.randint(0, k // 2, (x[::3].shape[0],), generator=gen, device=dev) * 2]
        x, e = x.to(dtype), e.to(dtype)
        got = nearest_codes(x, e, metric)
        want = nearest_codes_reference(x, e, metric)
        torch.cuda.synchronize()
        rep = compare_codes(x, e, got, want, metric)
        row = {"phase": "vq_lookup", "shape": name, "N": n, "K": k, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "metric": metric, "rows": rows,
               "plan": plan(n, k, d, dtype == torch.bfloat16, dtype == torch.bfloat16, card(dev))._asdict(),
               "rows_differing": rep["differ"], "rows_excused_as_near_ties": rep["excused"],
               "near_tie_rows": rep["near_tie_rows"], "near_tie_abs_tol": rep["tol"],
               "near_tie_rel_tol": NEAR_TIE_REL_TOL, "max_score_gap": rep["max_score_gap"]}
        ok = rep["ok"] and got.dtype == torch.int32 and got.shape == (n,)
        if rows == "ties":
            planted = torch.arange(0, n, 3, device=dev)
            row["planted_ties_exact"] = bool(torch.equal(got[planted], want[planted])
                                             and (got[planted] % 2 == 0).all())
            ok = ok and row["planted_ties_exact"]
        if not ok:
            emit(row)
            raise SystemExit(f"vq_lookup {name}: kernel and plain codes disagree beyond near-ties")
        if timed:
            xf, ef = x.float(), e.float()
            esq_half = 0.5 * (ef * ef).sum(dim=1)
            launched = kernels_per_call(lambda: nearest_codes(x, e))
            row.update({
                "ms": graph_ms([lambda: nearest_codes(x, e)]),
                "plain_ms": graph_ms([lambda: nearest_codes_reference(x, e)], replays=3),
                "library_ms": graph_ms([lambda: torch.argmin(
                    torch.addmm(esq_half, xf, ef.T, alpha=-1), dim=1)], replays=3),
                "launches_per_call": len(launched), "kernels_per_call": launched,
                **lookup_bounds(n, k, d, dtype, dtype),
            })
            if name == "path_f32":
                kernel_row = row
            del xf, ef, esq_half
        emit(row)
        del x, e, got, want
    return {
        "name": "nearest_codes", "route": "cuda",
        "source": f"{CSRC}/vq_lookup.cu",
        "replaces": "vector_quantization_tpu/ops/vq_lookup.py:94",
        "max_abs_err": kernel_row["max_score_gap"], "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"], "bound_ms": kernel_row["bound_ms"],
        "bound_by": "operations", "library_ms": kernel_row["library_ms"],
        "bound_f32_cuda_cores_ms": kernel_row["bound_f32_cuda_cores_ms"],
        "note": (f"N = K = 16384, D = 8, f32; bound_ms is the tensor-core bound (3 TF32 passes); "
                 f"max_abs_err is the largest plain-score gap "
                 f"between the kernel's code and the row's best ({kernel_row['rows_differing']} "
                 f"rows differ, all near-ties); library_ms writes the N x K matrix"),
    }


def make_vqgan(seed: int, dev):
    """The LlamaGen VQGAN through the port's config loader and registry,
    weights made from ``seed`` with numpy in the flax layout (conv and
    Dense kernels N(0, 1/fan_in), GroupNorm scale 1 and bias 0, the
    codebook uniform(-1/K, 1/K)) and loaded through the bridge."""
    from vector_quantization_tpu_torch.registries import ModelRegistry
    from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes, state_dict_from_flax
    from vector_quantization_tpu_torch.utils.config import Config

    path = Path(__file__).resolve().parent / VQGAN_CONFIG
    cfg = Config.load(str(path))["trainer"]["algorithm"]["model"]
    model = ModelRegistry.build(cfg, device=dev)
    rng = np.random.default_rng(seed)

    def make(tree, leaf=None):
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        if leaf == "kernel":
            fan_in = int(np.prod(tree[:-1]))
            return rng.standard_normal(tree, dtype=np.float32) / np.float32(np.sqrt(fan_in))
        if leaf == "codebook":
            return rng.uniform(-1.0 / tree[0], 1.0 / tree[0], tree).astype(np.float32)
        return (np.ones if leaf == "scale" else np.zeros)(tree, np.float32)

    model.load_state_dict(state_dict_from_flax(model, make(flax_param_shapes(model))))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VQGAN_PARAMS:
        raise SystemExit(f"tokenizer: {n_params} parameters, the config gives {VQGAN_PARAMS}")
    return model.eval(), cfg


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def conv_linear_flops(model, fn) -> int:
    """2 x the multiply-adds of every Conv2d and Linear that ``fn`` runs
    (the attention block's two matmuls, the norms and the lookup are not
    counted)."""
    total = 0

    def count(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            total += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total


def phase_tokenizer(model, cfg, dev, seed: int):
    from vector_quantization_tpu_torch.data.base import pixel_encode
    from vector_quantization_tpu_torch.ops import vq_lookup
    from vector_quantization_tpu_torch.ops.distances import normalize

    rng = np.random.default_rng(seed + 1)
    u8 = rng.integers(0, 256, (TOKENIZER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    x = pixel_encode(torch.from_numpy(u8).to(dev))
    with torch.inference_mode():
        enc_flops = conv_linear_flops(model, lambda: model.encode_to_quant(x[:1]))
        dec_flops = conv_linear_flops(model, lambda: model.decode_from_quant(
            torch.zeros((1, GRID, GRID), dtype=torch.int32, device=dev)))
        model.decode_from_quant(model.encode_to_quant(x))  # warm-up: cuDNN plans, allocator
        zero_launches()
        _, plain0 = read_launches()
        codes, enc_s = _timed(lambda: model.encode_to_quant(x))
        pixels, dec_s = _timed(lambda: model.decode_from_quant(codes))
        launches, plain = read_launches()
        plain_runs = plain - plain0
        # the same features through the plain lookup, swapped in
        feat = model.encode(x).reshape(-1, cfg["quantizer"]["embedding_dim"])
        saved = vq_lookup.nearest_codes
        vq_lookup.nearest_codes = vq_lookup.nearest_codes_reference
        try:
            plain_codes = model.quantizer.encode(feat)
        finally:
            vq_lookup.nearest_codes = saved
        rep = vq_lookup.compare_codes(normalize(feat), model.quantizer.effective_codebook(),
                                      codes, plain_codes)
        out = model(x[:8])
    torch.cuda.synchronize()
    q = out["quantizer"]
    row = {"phase": "tokenizer", "config": VQGAN_CONFIG,
           "params": sum(p.numel() for p in model.parameters()), "dtype": "float32",
           "images": TOKENIZER_BATCH, "image_size": IMAGE_SIZE, "codes_shape": list(codes.shape),
           "pixels_shape": list(pixels.shape), "encode_s": enc_s, "decode_s": dec_s,
           "encode_images_per_s": TOKENIZER_BATCH / enc_s,
           "decode_images_per_s": TOKENIZER_BATCH / dec_s,
           "encode_gflop_per_image": enc_flops / 1e9, "decode_gflop_per_image": dec_flops / 1e9,
           "encode_tflop_per_s": enc_flops * TOKENIZER_BATCH / enc_s / 1e12,
           "decode_tflop_per_s": dec_flops * TOKENIZER_BATCH / dec_s / 1e12,
           "launches": launches, "plain_runs_on_cuda": plain_runs,
           "codes_vs_plain": {k: rep[k] for k in ("differ", "excused", "near_tie_rows", "tol")},
           "distinct_codes": int(torch.unique(codes).numel()),
           "forward_loss_vqgan": float(q.losses["loss_vqgan"]),
           "forward_codes_equal_encode_to_quant": bool(torch.equal(q.codes, codes[:8]))}
    emit(row)
    ok = (codes.shape == (TOKENIZER_BATCH, GRID, GRID) and bool((codes >= 0).all())
          and bool((codes < CODEBOOK).all()) and rep["ok"]
          and pixels.shape == (TOKENIZER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
          and bool(torch.isfinite(pixels).all()) and launches["nearest_codes"] > 0
          and plain_runs == 0
          and out["pred"].shape == (8, IMAGE_SIZE, IMAGE_SIZE, 3)
          and bool(torch.isfinite(out["pred"]).all()) and bool(torch.isfinite(q.loss))
          and row["forward_codes_equal_encode_to_quant"])
    if not ok:
        raise SystemExit("tokenizer: a check failed (see the tokenizer line)")

    def profile_tokenizer() -> None:
        """Device time of one encode + decode of the batch by kernel, and
        the device's idle share against the host clock (under the
        profiler, so the host side is slower than in the timed run)."""
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(lambda: model.decode_from_quant(model.encode_to_quant(x)))
        events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events)
        if device_us <= 0:
            raise SystemExit("tokenizer_profile: the profiler recorded no device time")
        emit({"phase": "tokenizer_profile", "images": TOKENIZER_BATCH,
              "host_ms": 1e3 * wall, "device_ms": device_us / 1e3,
              "device_idle_frac": 1.0 - device_us / 1e6 / wall,
              "top_kernels": [{"name": e.key[:90], "calls": e.count,
                               "ms": e.self_device_time_total / 1e3,
                               "share": e.self_device_time_total / device_us}
                              for e in events[:8]]})

    return launches, profile_tokenizer


def phase_class_to_image(model, done: dict, dev) -> None:
    from vector_quantization_tpu_torch.data.base import pixel_decode

    grids = torch.stack([torch.as_tensor(done[r]).reshape(GRID, GRID) for r in sorted(done)]).to(dev)
    zero_launches()
    with torch.inference_mode():
        images, wall = _timed(lambda: pixel_decode(model.decode_from_quant(grids)))
    launches, _ = read_launches()  # decode runs the gather and convolutions: no ported kernel
    row = {"phase": "class_to_image", "requests": len(done), "images_shape": list(images.shape),
           "launches": launches,
           "dtype": str(images.dtype).removeprefix("torch."), "decode_s": wall,
           "decode_images_per_s": len(done) / wall}
    emit(row)
    if images.dtype != torch.uint8 or images.shape != (len(done), IMAGE_SIZE, IMAGE_SIZE, 3):
        raise SystemExit("class_to_image: the served codes did not become uint8 images")


# AR training (configs/llamagen/c2i_medium_imagenet_ddp.py with flash on)
AR_CONFIG = "configs/llamagen/c2i_medium_imagenet_ddp.py"
SEQ = 1 + IMAGE_TOKENS  # [class | 256 codes]
AR_IMAGE_BATCH, AR_CODES_BATCH, AR_IMAGE_STEPS, AR_CODES_STEPS = 64, 128, 3, 5
FLASH_O_LIMIT, FLASH_GRAD_LIMIT, FLASH_LSE_LIMIT, FLASH_DI_LIMIT = 2e-3, 1e-2, 1e-4, 1e-5
EINSUM_LOSS_LIMIT, EINSUM_GRAD_LIMIT = 1e-2, 5e-2


def sdpa_flash_ms(q, k, v, do) -> dict:
    """The yardstick of K4: PyTorch's causal flash attention (SDPA pinned to
    its FLASH_ATTENTION backend) on K4's inputs, (B, T, H, Dh) viewed as
    SDPA's (B, H, T, Dh), each part timed by CUDA-graph replay as the
    kernels are: the forward; the backward alone (the aten flash backward
    on residuals that one forward call made outside the graph); forward and
    backward together."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt, dot = [x.transpose(1, 2) for x in (q, k, v, do)]
    fwd_op = torch.ops.aten._scaled_dot_product_flash_attention
    bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward

    def backward(res):
        # res: (out, logsumexp, cum_seq_q, cum_seq_k, max_q, max_k, rng_state, unused, ...)
        return bwd_op(dot, qt, kt, vt, res[0], res[1], res[2], res[3], res[4], res[5],
                      0.0, True, res[6], res[7])

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd_ms = graph_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)])
    res = fwd_op(qt, kt, vt, 0.0, True)
    return {"backend": "FLASH_ATTENTION", "fwd_ms": fwd_ms,
            "bwd_ms": graph_ms([lambda: backward(res)]),
            "fwd_bwd_ms": graph_ms([lambda: backward(fwd_op(qt, kt, vt, 0.0, True))]),
            "bwd_schema": str(bwd_op.default._schema)}


def flash_cost(b: int, t: int, h: int, dh: int) -> dict:
    """Bytes (each input read once, each output written once) and tensor-core
    operations of the three kernels at (B, T, H, Dh), causal."""
    pairs = b * h * t * (t + 1) // 2  # (query, key) pairs at or below the diagonal
    x, row = b * t * h * dh * 2, b * h * t * 4  # one bf16 (B, T, H, Dh); one f32 (B, H, T)
    return {"fwd": (3 * x + x + row, 4 * dh * pairs),       # q, k, v -> o, lse
            "dkv": (4 * x + 2 * row + 2 * x, 8 * dh * pairs),  # q, k, v, dO, lse, di -> dk, dv
            "dq": (5 * x + row + x + row, 6 * dh * pairs)}    # q, k, v, o, dO, lse -> dq, di


def phase_flash_attention(dev, gen) -> list[dict]:
    from vector_quantization_tpu_torch.ops import flash_attention as fa

    path = (AR_IMAGE_BATCH, SEQ, MEDIUM["num_heads"], 64)
    cases = [("path", path), ("t1", (4, 1, 8, 64)), ("t63", (4, 63, 8, 64)),
             ("t64", (4, 64, 8, 64)), ("t65", (4, 65, 8, 64)), ("t129", (4, 129, 8, 64)),
             ("t256", (4, 256, 8, 64)), ("t300", (4, 300, 8, 64)), ("t705", (2, 705, 4, 64)),
             ("bh1", (1, SEQ, 1, 64)),
             ("dh32", (4, 200, 8, 32)), ("dh128", (4, 200, 8, 128))]
    timing = None
    for name, shape in cases:
        q, k, v, do = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4)]
        o, lse = fa.flash_attention_fwd(q, k, v)
        ro, rl = fa.flash_attention_reference(q, k, v)
        # both backward versions take the same residuals (the kernel's o, lse)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
        _, di = fa.flash_bwd_dq(q, k, v, o, do, lse)  # the di the backward's dkv took
        rdi = fa._di(o, do)
        torch.cuda.synchronize()
        # over max(1, max|ref|): at T = 1 dq and dk are 0 up to rounding
        grad_err = {n: float((g.float() - r.float()).abs().max())
                    / max(1.0, float(r.float().abs().max()))
                    for n, g, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        row = {"phase": "flash_attention", "case": name, "B": shape[0], "T": shape[1],
               "H": shape[2], "Dh": shape[3], "dtype": "bfloat16",
               "o_max_abs_err": float((o.float() - ro.float()).abs().max()),
               "o_err_beyond_one_bf16_step": fa.excess_over_bf16_step(o, ro), "o_limit": FLASH_O_LIMIT,
               "lse_max_abs_err": float((lse - rl).abs().max()), "lse_limit": FLASH_LSE_LIMIT,
               "grad_max_err_over_max_ref": grad_err, "grad_limit": FLASH_GRAD_LIMIT,
               "di_max_err_over_max_ref": float((di - rdi).abs().max())
               / max(1.0, float(rdi.abs().max())), "di_limit": FLASH_DI_LIMIT}
        finite = all(bool(torch.isfinite(x).all()) for x in (o, lse, dq, dk, dv, di))
        if (not finite or row["o_err_beyond_one_bf16_step"] > FLASH_O_LIMIT
                or row["lse_max_abs_err"] > FLASH_LSE_LIMIT
                or max(grad_err.values()) > FLASH_GRAD_LIMIT
                or row["di_max_err_over_max_ref"] > FLASH_DI_LIMIT):
            emit(row)
            raise SystemExit(f"flash_attention {name}: kernels and plain versions disagree")
        if name == "path":
            sdpa = sdpa_flash_ms(q, k, v, do)
            plain_bwd = graph_ms([lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do)],
                                 replays=3)
            timing = {
                "fwd": (graph_ms([lambda: fa.flash_attention_fwd(q, k, v)]),
                        graph_ms([lambda: fa.flash_attention_reference(q, k, v)], replays=3),
                        sdpa["fwd_ms"]),
                "dkv": (graph_ms([lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di)]), plain_bwd,
                        sdpa["bwd_ms"]),
                "dq": (graph_ms([lambda: fa.flash_bwd_dq(q, k, v, o, do, lse)]), plain_bwd,
                       sdpa["bwd_ms"]),
                # K4's whole backward: dq (which writes di), then dkv
                "bwd": (graph_ms([lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)]), plain_bwd,
                        sdpa["bwd_ms"]),
            }
            row.update({f"{k}_{m}": val for k, (ms, plain, lib) in timing.items()
                        for m, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib))})
            row.update({"sdpa_backend": sdpa["backend"], "sdpa_fwd_bwd_ms": sdpa["fwd_bwd_ms"],
                        "sdpa_bwd_schema": sdpa["bwd_schema"],
                        "bwd_faster": "K4" if timing["bwd"][0] < sdpa["bwd_ms"] else "SDPA"})
            errs = (row["o_err_beyond_one_bf16_step"], grad_err)
        emit(row)
        del q, k, v, do, o, lse, ro, rl, dq, dk, dv, rq, rk, rv, di, rdi
    # f32 is refused on the card, never cast
    x = torch.zeros((1, 4, 2, 64), device=dev)
    try:
        fa.flash_attention_fwd(x, x, x)
    except ValueError as e:
        if "float32" not in str(e):
            raise
    else:
        raise SystemExit("flash_attention: an f32 CUDA input was not refused")
    cost = flash_cost(*path)
    entries = []
    for key, name, line, err in (
        ("fwd", "flash_attention_fwd", "flash_attention.py:758 (kernel :331)", errs[0]),
        ("dkv", "flash_bwd_dkv", "flash_attention.py:1121 (kernel :796)",
         max(errs[1]["dk"], errs[1]["dv"])),
        ("dq", "flash_bwd_dq", "flash_attention.py:1456 (kernel :1146)", errs[1]["dq"]),
    ):
        byts, ops = cost[key]
        ms, plain, lib = timing[key]
        bound_bytes, bound_ops = byts / HBM_BYTES_PER_S, ops / BF16_FLOPS
        entries.append({
            "name": name, "route": "cuda",
            "source": f"{CSRC}/flash_attention.cu",
            "replaces": ("vector_quantization_tpu/models/transformers/llama.py:232 -> "
                         "jax/experimental/pallas/ops/tpu/" + line),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": 1e3 * max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": lib, "bytes": byts, "ops": ops,
            "note": (f"(B, T, H, Dh) = {path} bf16; max_abs_err: "
                     + ("o beyond one bf16 step over max(1, max|ref|)" if key == "fwd"
                        else "max|diff| over max(1, max|ref|)")
                     + ("; library_ms = SDPA(is_causal) forward, FLASH_ATTENTION backend"
                        if key == "fwd" else
                        "; plain_ms = the whole plain backward (dq, dk, dv); library_ms = "
                        "the whole SDPA flash backward (dq, dk, dv), graph-timed")
                     + ("; the dq kernel also writes di = sum(o dO) for dkv" if key == "dq"
                        else "")),
        })
    return entries


def make_ar_algorithm(seed: int, dev, vqgan):
    """ARAlgorithm from the LlamaGen C2I medium config with flash on,
    through the port's config loader and registry; Llama-medium weights
    made from ``seed`` (non-zero lm head) and loaded through the bridge;
    the tokenizer is phase ``tokenizer``'s VQGAN."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / AR_CONFIG))["trainer"]["algorithm"]
    cfg["transformer"]["flash"] = True
    cfg["ir"] = vqgan
    algo = AlgorithmRegistry.build(cfg, device=dev)
    load_ar_from_flax(algo, medium_flax_params(seed + 2))
    return algo, cfg


def ar_model_flops(cfg: dict, batch: int) -> tuple[float, float]:
    """(model FLOPs of one train step, FLOPs with the full-remat re-run of
    the blocks' forward), from the config's widths: the projections
    (6 x tokens x weights), causal attention (4 x Dh per (query, key) pair
    and head, x3 for forward and backward) and the head over B x (T-1)
    positions (6 x D x V)."""
    t = cfg["transformer"]
    d, f, n_layers, h = t["hidden_size"], t["ffn_dim"], t["num_layers"], t["num_heads"]
    tokens, pairs = batch * SEQ, batch * h * SEQ * (SEQ + 1) // 2
    proj = 2 * tokens * n_layers * (4 * d * d + 3 * d * f)
    attn = 4 * (d // h) * pairs * n_layers
    head = 2 * batch * (SEQ - 1) * d * VOCAB
    return 3 * (proj + attn + head), 3 * (proj + attn + head) + proj + attn


def phase_ar_train(algo, cfg, dev, seed: int):
    from vector_quantization_tpu_torch.data.base import pixel_encode

    model = algo.model
    n_layers = cfg["transformer"]["num_layers"]
    rng = np.random.default_rng(seed + 3)
    u8 = rng.integers(0, 256, (AR_IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    image_batch = {"image": pixel_encode(torch.from_numpy(u8).to(dev)),
                   "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_IMAGE_BATCH)).to(dev)}
    codes_batch = {"codes": torch.from_numpy(rng.integers(0, CODEBOOK, (AR_CODES_BATCH, GRID, GRID))).to(dev),
                   "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_CODES_BATCH)).to(dev)}
    n_params = sum(p.numel() for p in model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    ir_before = [p.detach().clone() for p in algo.ir_model.parameters()]
    state = algo.init_state(seed)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    losses, times, lrs = [], [], []
    for i in range(AR_IMAGE_STEPS + AR_CODES_STEPS):
        batch = image_batch if i < AR_IMAGE_STEPS else codes_batch
        lrs.append(algo.tx().schedule(state.opt_state["count"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = algo.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
    launches, plain = read_launches()
    plain_runs = plain - plain0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    changed = [not torch.equal(p, b) for p, b in zip(model.parameters(), before)]
    ir_same = all(torch.equal(p, b) for p, b in zip(algo.ir_model.parameters(), ir_before))
    del before, ir_before
    steps = AR_IMAGE_STEPS + AR_CODES_STEPS
    step_s = float(np.median(times[AR_IMAGE_STEPS:]))
    model_flops, remat_flops = ar_model_flops(cfg, AR_CODES_BATCH)
    want = {"flash_attention_fwd": 2 * n_layers * steps, "flash_bwd_dkv": n_layers * steps,
            "flash_bwd_dq": n_layers * steps, "nearest_codes": AR_IMAGE_STEPS}
    row = {"phase": "ar_train", "config": AR_CONFIG, "flash": True, "params": n_params,
           "dtype": str(model.dtype).removeprefix("torch."), "remat": model.remat,
           "image_batch": AR_IMAGE_BATCH, "image_steps": AR_IMAGE_STEPS,
           "codes_batch": AR_CODES_BATCH, "codes_steps": AR_CODES_STEPS, "seq": SEQ,
           "losses": losses, "lr_per_step": lrs, "step_s_host_clock": times,
           "codes_step_ms_median": 1e3 * step_s,
           "codes_tokens_per_s": AR_CODES_BATCH * SEQ / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "with_remat_tflop_per_step": remat_flops / 1e12,
           "mfu_vs_989_tflops": model_flops / step_s / BF16_FLOPS,
           "peak_memory_gib": peak_gb, "launches": launches, "expected_launches": want,
           "plain_runs_on_cuda": plain_runs,
           "params_changed": int(sum(changed)), "param_tensors": len(changed),
           "tokenizer_unchanged": ir_same}
    emit(row)
    ok = (all(np.isfinite(losses)) and all(changed) and ir_same and plain_runs == 0
          and all(launches[k] == v for k, v in want.items()))
    if not ok:
        raise SystemExit("ar_train: a check failed (see the ar_train line)")
    return launches, state, codes_batch


def set_flash(model, flash: bool) -> None:
    for blk in model.blocks():
        blk.flash = flash


def phase_ar_flash_vs_einsum(algo, state, batch) -> None:
    """One step's loss and gradients, same weights and tokens (the first
    64 rows of the codes batch), through the flash kernels and through the
    einsum attention (flash=False, what the shipped config runs); then the
    train step on those 64 rows with each, timed on the host clock (median
    of 3 after one warm-up)."""
    from vector_quantization_tpu_torch.tasks.sequence_modeling import pack_c2i_tokens

    model = algo.model
    tokens = pack_c2i_tokens(batch["category"][:AR_IMAGE_BATCH], batch["codes"][:AR_IMAGE_BATCH],
                             algo.image_codebook)
    params = list(model.parameters())
    out = {}
    for flash in (True, False):
        set_flash(model, flash)
        loss = model(tokens, fused_ce_targets=tokens)
        out[flash] = (float(loss.detach()), torch.autograd.grad(loss, params))
    del loss
    sub = {k: x[:AR_IMAGE_BATCH] for k, x in batch.items()}
    step_ms = {}
    for flash in (True, False):
        set_flash(model, flash)
        times = []
        for _ in range(4):  # a warm-up, then 3 timed steps (train_step updates state in place)
            _, seconds = _timed(lambda: algo.train_step(state, sub))
            times.append(1e3 * seconds)
        step_ms["flash" if flash else "einsum"] = float(np.median(times[1:]))
    set_flash(model, True)
    (lf, gf), (le, ge) = out[True], out[False]
    loss_rel = abs(lf - le) / abs(le)
    grad_rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))
                for a, b in zip(gf, ge)]
    names = [n for n, _ in model.named_parameters()]
    worst = int(np.argmax(grad_rel))
    row = {"phase": "ar_flash_vs_einsum", "batch": AR_IMAGE_BATCH, "loss_flash": lf,
           "loss_einsum": le, "loss_rel_diff": loss_rel, "loss_limit": EINSUM_LOSS_LIMIT,
           "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_max_param": names[worst],
           "grad_rel_l2_median": float(np.median(grad_rel)), "grad_limit": EINSUM_GRAD_LIMIT,
           "train_step_ms_host_clock_median_of_3": step_ms,
           "einsum_over_flash_step": step_ms["einsum"] / step_ms["flash"]}
    emit(row)
    if loss_rel > EINSUM_LOSS_LIMIT or grad_rel[worst] > EINSUM_GRAD_LIMIT:
        raise SystemExit("ar_flash_vs_einsum: the flash and einsum steps disagree")


def profile_ar_step(algo, state, batch) -> None:
    """One codes step under torch.profiler: device time by kernel and the
    device's idle share against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: algo.train_step(state, batch))
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise SystemExit("ar_train_profile: the profiler recorded no device time")
    groups = {"flash_attention_kernels": ("flash_",), "matmul_library": ("nvjet", "gemm", "cutlass")}
    by_group = {g: sum(e.self_device_time_total for e in events
                       if any(m in e.key for m in marks)) / 1e3 for g, marks in groups.items()}
    by_group["other"] = device_us / 1e3 - sum(by_group.values())
    emit({"phase": "ar_train_profile", "batch": AR_CODES_BATCH, "host_ms": 1e3 * wall,
          "device_ms": device_us / 1e3, "device_idle_frac": 1.0 - device_us / 1e6 / wall,
          "device_ms_by_group": by_group,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share": e.self_device_time_total / device_us}
                          for e in events[:12]]})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=48)
    args = p.parse_args()
    import vector_quantization_tpu_torch  # noqa: F401  (the port must sit beside this script)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi, device = phase_device()
    phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k_int8 = phase_int8_matmul(dev, gen)
    k_attn = phase_paged_attention(dev, gen)
    torch.cuda.empty_cache()
    model = make_medium(args.seed, dev)
    profile_step = phase_decode_step(model, dev, gen)
    k2_kernels = [k["name"] for k in k_int8]
    launches, done = phase_serving(model, dev, args.seed, args.requests, k2_kernels)
    k2_dense_rows = phase_dense_vs_paged(model, dev, gen, args.seed)
    dense_launches = phase_serving_dense(model, dev, args.seed, args.requests, k2_kernels)
    del model
    torch.cuda.empty_cache()
    gen_launches, profile_generate = phase_generate(dev, args.seed)
    k_vq = phase_vq_lookup(dev, gen)
    torch.cuda.empty_cache()
    vqgan, vqgan_cfg = make_vqgan(args.seed, dev)
    tok_launches, profile_tokenizer = phase_tokenizer(vqgan, vqgan_cfg, dev, args.seed)
    phase_class_to_image(vqgan, done, dev)
    k_flash = phase_flash_attention(dev, gen)
    torch.cuda.empty_cache()
    algo, ar_cfg = make_ar_algorithm(args.seed, dev, vqgan)
    ar_launches, ar_state, codes_batch = phase_ar_train(algo, ar_cfg, dev, args.seed)
    phase_ar_flash_vs_einsum(algo, ar_state, codes_batch)
    phase_ar_generate(algo, ar_state, dev, args.seed)
    profile_step()
    profile_generate()
    profile_tokenizer()
    profile_ar_step(algo, ar_state, codes_batch)
    for k in k_int8:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {"serving": launches[k["name"]],
                                 "generate": gen_launches[k["name"]],
                                 "serving_dense": dense_launches[k["name"]]}
        k["dense_path_shapes"] = [{key: r[key] for key in ("shape", "B", "D", "F", "ms", "plain_ms",
                                                           "library_ms", "bound_ms", "max_abs_err")}
                                  for r in k2_dense_rows if r["plan"]["design"] == k["design"]]
    k_attn["launches"] = launches[k_attn["name"]]
    k_vq["launches"] = tok_launches["nearest_codes"]
    for k in k_flash:
        k["launches"] = ar_launches[k["name"]]
    emit({"kernels": [*k_int8, k_attn, k_vq, *k_flash]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
