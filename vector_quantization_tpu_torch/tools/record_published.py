"""Record (or check) the repo's published quality numbers (port of
``tools/record_published.py``).

The reference records a metric dict per released checkpoint and
regression-tests conversions against it. Upstream checkpoints are not in
the repository, so the recorded numbers carry explicit provenance instead:

1. ``synthetic_taming_vqgan``: a fixed-seed synthetic torch checkpoint in
   the taming layout (``tools/_taming.py``, the state dict of the repo's
   taming fixture under ``torch.manual_seed(0)``) run through the full
   golden pipeline (convert → graft → validate). Anchors the converter and
   validator stack.
2. ``self_trained_smoke``: ``configs/regression/smoke_anchor.py``'s VQGAN,
   20 iterations from the runner's seed on synthetic data, validated with
   the full metric set. Anchors the training stack.
3. ``self_trained_2k``: ``configs/regression/train_anchor.py``, 2000
   iterations (PSNR >= 15).
4. ``self_trained_ar``: ``configs/regression/ar_anchor.py``'s tiny C2I
   Llama, 800 iterations; teacher-forced CE and accuracy, and
   ``decode_hash``, crc32 of the greedy CFG decode of classes 0-3 (int32
   stream) mod 1e6, with ``decode_mean``.

    python -m vector_quantization_tpu_torch.tools.record_published --check \\
        [--families synthetic_taming_vqgan ...] [--work-dir DIR] [--device cpu]

``--check`` runs the families and exits 1 if any metric drifted from
``BASELINE.json["published"]`` beyond ``CHECK_TOL`` (read only). Each
metric is printed beside its recorded value, its delta and its tolerance.
Unlike the JAX tool, a check recorded on another platform is gated all
the same: the port's numbers are held to the JAX package's record.
``--record`` writes the metric dicts with provenance and platform to
``<work_dir>/published_torch.json`` (other families' entries kept), never
into ``BASELINE.json``.

The self-trained anchors draw their weights from the port's generator
(``build_runner``: seed 3407), not from JAX's ``PRNGKey(3407)``, and the
AR anchor's frozen tokenizer and CFG drops likewise: the port reproduces
the training run's numbers within ``CHECK_TOL`` where they depend on the
recipe and not on the draw.
"""

from __future__ import annotations

import argparse
import json
import os
import platform as _platform
import zlib
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import init_distributed
from ..tasks.image_tokenization import model_device
from ..tasks.sequence_modeling import generate
from ..training.runner import build_runner
from ..utils.config import load_config
from . import golden_eval
from ._taming import synthetic_checkpoint

__all__ = ["CHECK_TOL", "PROVENANCE", "RUNNERS", "check", "main", "platform_tag"]

REPO = Path(__file__).resolve().parents[2]
REGRESSION = REPO / "configs" / "regression"

# loose tolerances: smoke-scale GAN training amplifies numeric noise across
# platforms/compiler versions; these bound "still the same training run"
CHECK_TOL = {
    "codebook_usage": 0.1,
    "codebook_ppl": 1.0,
    "l1": 0.05,
    "mse": 0.05,
    "psnr": 1.0,
    "ssim": 0.1,
    "loss": 0.2,  # smoke-scale CE; same-platform reruns are bit-stable
    "accuracy": 0.05,
    "decode_hash": 0.5,  # integers: any drift in the greedy token stream
    # (decode scan / KV cache / CFG / sampler) fails exactly
    "decode_mean": 1.0,  # diagnostic companion when the hash trips
}


def synthetic_golden(work_dir: str, device=None) -> dict:
    """Convert→graft→validate a fixed-seed synthetic taming checkpoint."""
    ckpt = synthetic_checkpoint(os.path.join(work_dir, "synthetic_taming.pth"))
    config = load_config(str(REGRESSION / "golden_synthetic.py"))
    validator = build_runner(config, "validator", device=device, work_dir=os.path.join(work_dir, "golden"))
    converted = golden_eval.convert(
        "taming_vqgan",
        ckpt,
        {"width": 32, "enc_width_mults": (1, 2), "enc_depth": 2,
         "dec_depth": 3},
    )
    validator.init_state()
    golden_eval.graft(validator, converted)
    results = validator.run()
    return {k: float(v) for k, v in results.items()}


def _train(work_dir: str, config_name: str, tag: str, device=None):
    """A regression-anchor config trained from scratch (seed 3407), then
    validated: (trainer, state, metrics)."""
    config = load_config(str(REGRESSION / config_name))
    trainer = build_runner(config, "trainer", device=device, work_dir=os.path.join(work_dir, f"{tag}_train"))
    trainer.init_state()
    state = trainer.run()
    validator = build_runner(config, "validator", device=device, work_dir=os.path.join(work_dir, f"{tag}_val"))
    validator.init_state()
    results = validator.run(state)
    return trainer, state, {k: float(v) for k, v in results.items()}


def self_trained_smoke(work_dir: str, device=None) -> dict:
    return _train(work_dir, "smoke_anchor.py", "anchor", device)[2]


def self_trained_2k(work_dir: str, device=None) -> dict:
    """2k-iter anchor: reaches non-trivial reconstruction (PSNR >= 15), so
    drift checks have signal beyond 20-iter noise."""
    return _train(work_dir, "train_anchor.py", "anchor2k", device)[2]


def greedy_decode(algo) -> np.ndarray:
    """The anchor's greedy CFG decode of classes 0-3 (top-k 1, key 1234):
    (4, h·w) int32 codes."""
    device = next(algo.model.parameters()).device
    cond = torch.arange(4, dtype=torch.int32, device=device)
    if algo.cfg is not None:
        cond = torch.cat([torch.full_like(cond, algo.uncondition_token), cond])
    with torch.no_grad():
        codes = generate(
            algo.model,
            cond[:, None],
            algo.image_hw * algo.image_hw,
            algo.image_codebook,
            torch.Generator(device=device).manual_seed(1234),
            sampler={"temperature": 1.0, "top_k": 1},  # greedy: bit-stable
            cfg_alpha=algo.cfg_alpha if algo.cfg is not None else None,
        )
    return codes.cpu().numpy().astype(np.int32)


def decode_metrics(arr: np.ndarray) -> dict:
    return {"decode_hash": float(zlib.crc32(arr.tobytes()) % 10**6), "decode_mean": float(arr.mean())}


def self_trained_ar(work_dir: str, device=None) -> dict:
    """Stage-2 anchor: tiny C2I Llama on a frozen-random-tokenizer corpus.
    Teacher-forced CE + accuracy gate training drift; a greedy-decode
    token-stream hash gates the decode path (KV cache, CFG mixing,
    sampler)."""
    trainer, _, results = _train(work_dir, "ar_anchor.py", "anchor_ar", device)
    results.update(decode_metrics(greedy_decode(trainer.algorithm)))
    return results


RUNNERS = {
    "synthetic_taming_vqgan": synthetic_golden,
    "self_trained_smoke": self_trained_smoke,
    "self_trained_2k": self_trained_2k,
    "self_trained_ar": self_trained_ar,
}

PROVENANCE = {
    "synthetic_taming_vqgan": (
        "synthetic: fixed-seed (torch.manual_seed(0)) random checkpoint in "
        "the taming layout, through convert→graft→validate "
        "(tools/golden_eval.py). Real upstream checkpoints unreachable: "
        "no network in the build environment."
    ),
    "self_trained_smoke": (
        "self-trained: configs/regression/smoke_anchor.py, 20 iters, "
        "seed 3407, synthetic data; metric dict is the cross-round "
        "regression anchor."
    ),
    "self_trained_2k": (
        "self-trained: configs/regression/train_anchor.py, 2000 iters, "
        "seed 3407, synthetic sinusoid corpus; reaches non-trivial "
        "reconstruction (PSNR >= 15) so the drift gate has signal beyond "
        "smoke-run noise."
    ),
    "self_trained_ar": (
        "self-trained: configs/regression/ar_anchor.py, 800 iters, seed "
        "3407, tiny C2I Llama on a frozen-random-tokenizer corpus; "
        "teacher-forced CE/accuracy gate training drift, decode_hash "
        "(crc32 of the greedy-decode token stream, fixed key) gates the "
        "jitted decode scan / KV cache / CFG / sampler."
    ),
}


def platform_tag(device=None) -> str:
    dev = model_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return f"{dev.type}:{kind} ({_platform.machine()})"


def check(measured: dict, published: dict, tag: str) -> tuple[int, list[dict]]:
    """Each measured family against its recorded entry: (rc, one row per
    recorded metric with its value, the measured one, delta, tolerance and
    verdict)."""
    rc, rows = 0, []
    for family, metrics in measured.items():
        entry = published.get(family, {})
        want = entry.get("metrics")
        if want is None:
            print(f"[check] {family}: no recorded entry — run --record")
            rc = 1
            continue
        recorded_platform = entry.get("platform")
        if recorded_platform and recorded_platform != tag:
            print(f"[check] {family}: recorded on {recorded_platform!r}, running on {tag!r}: gated all the same")
        for key, val in want.items():
            got = metrics.get(key)
            tol = CHECK_TOL.get(key.rsplit("/", 1)[-1], 0.05)
            delta = None if got is None else got - val
            ok = delta is not None and abs(delta) <= tol
            rows.append({"family": family, "metric": key, "recorded": val, "measured": got,
                         "delta": delta, "tol": tol, "ok": ok})
            shown = "missing" if got is None else f"{got:.5f} delta {delta:+.5f}"
            print(f"[check] {family}.{key}: recorded {val:.5f} measured {shown} (tol {tol}) "
                  f"{'ok' if ok else 'FAIL'}")
            rc |= 0 if ok else 1
    return rc, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--record", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--work-dir", default=os.path.join("work_dirs", "published_torch"))
    p.add_argument(
        "--families", nargs="*", default=None,
        help="subset of anchor families to run (default: all); other "
        "recorded families are left untouched by --record",
    )
    p.add_argument("--device", default=None, help="default: cuda (cpu runs the plain versions)")
    args = p.parse_args(argv)
    if not (args.record or args.check):
        p.error("pass --record and/or --check")

    import vector_quantization_tpu_torch  # noqa: F401  (registers the built-in classes)

    init_distributed(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    runners = dict(RUNNERS)
    if args.families:
        unknown = set(args.families) - set(runners)
        if unknown:
            p.error(f"unknown families: {sorted(unknown)}")
        runners = {k: v for k, v in runners.items() if k in args.families}
    measured = {k: fn(args.work_dir, args.device) for k, fn in runners.items()}
    print(json.dumps(measured, indent=2))

    rc = 0
    tag = platform_tag(args.device)
    if args.check:
        with open(REPO / "BASELINE.json") as f:
            published = json.load(f).get("published", {})
        rc = check(measured, published, tag)[0]

    if args.record:
        artifact = os.path.join(args.work_dir, "published_torch.json")
        merged = {}
        if os.path.exists(artifact):  # --families runs a subset: keep the
            with open(artifact) as f:  # other families' recorded values
                merged = json.load(f)
        for family, metrics in measured.items():
            merged[family] = {"metrics": metrics, "provenance": PROVENANCE[family], "platform": tag}
        with open(artifact, "w") as f:
            json.dump(merged, f, indent=2)
        print(f"recorded published metrics → {artifact}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
