"""Golden-number regression harness: converted checkpoint → val → Δ vs golden
(port of ``tools/golden_eval.py``).

The reference's de-facto regression suite is "convert an upstream
checkpoint, run ``vq.test``, compare against the recorded metric dict".
This tool is that workflow end to end, with the comparison made explicit
and machine-checkable:

    python -m vector_quantization_tpu_torch.tools.golden_eval taming_vqgan --checkpoint last.ckpt \\
        --config configs/vqgan/16384_imagenet_ddp.py \\
        [--config-options k=v ...] [--tol '{"fid": 0.1}'] [--publish] [--device cpu]

    python -m vector_quantization_tpu_torch.tools.golden_eval beit_vqkd --checkpoint vqkd.pth \\
        --config configs/vqkd/clip_8192_imagenet_ddp.py

Steps:

1. load the torch checkpoint and run the matching weight converter
   (``utils/converters.py``; ``--converter-options`` ``enc_width_mults``,
   ``enc_depth``, ``dec_depth``; ``width`` is checked against the
   checkpoint's first conv, since the port's converter reads the width off
   the tensors);
2. build the config's ``validator`` and graft the converted weights onto
   the freshly-initialised state (strict=False merge: keys the model lacks
   are ignored with a message, shapes must match; under FSDP/TP each rank
   keeps its shard);
3. run validation, print the metric dict as JSON;
4. diff against the golden values (the built-in table below = the
   reference's published numbers, overridable with ``--golden JSON``,
   a file or inline), print a table and exit 1 if any metric is outside
   tolerance or missing (a missing metric shows as NaN);
5. with ``--publish``, write the measured numbers with provenance to
   ``<work_dir>/published.json`` (``{"published": {family: entry}}``, the
   entry as the JAX tool writes it into ``BASELINE.json``, which this tool
   never writes).
"""

from __future__ import annotations

import argparse
import json
import os

from ..cli.common import parse_kv, prepare
from ..parallel.mesh import init_distributed
from ..training.checkpoints import merge_params
from ..training.runner import build_runner
from ..utils import converters as C
from ..utils.bridge import flax_param_paths

__all__ = ["DEFAULT_TOL", "GOLDEN", "compare", "convert", "graft", "main", "publish"]

# Golden metric dicts for converted upstream checkpoints, keyed by family:
# taming VQGAN f16 16384 on ImageNet-1k val 256px, and BEiT-v2 VQ-KD
# CLIP-B/16 8192 (the reference's docs/pretrained_models.md).
GOLDEN = {
    "taming_vqgan": {
        "fid": 4.9808,
        "lpips": 0.28323,
        "l1": 0.06812,
        "mse": 0.013180,
        "psnr": 19.9704,
        "ssim": 0.50234,
        "codebook_usage": 0.059326,
        "codebook_ppl": 6.8124,
    },
    "beit_vqkd": {
        "r_loss": 0.16431,
        "codebook_usage": 1.0,
        "codebook_ppl": 8.9482,
    },
}

# Per-metric absolute tolerances. FID gets the north star's 0.1 budget;
# bounded [0,1]-ish metrics get 5e-3; PSNR (dB) 0.05; PPL 0.05.
DEFAULT_TOL = {
    "fid": 0.1,
    "lpips": 5e-3,
    "l1": 2e-3,
    "mse": 5e-4,
    "psnr": 0.05,
    "ssim": 5e-3,
    "codebook_usage": 5e-3,
    "codebook_ppl": 0.05,
    "r_loss": 2e-3,
}


def _check_width(sd: dict, width) -> None:
    have = sd["encoder.conv_in.weight"].shape[0]
    if int(width) != have:
        raise SystemExit(f"--converter-options width={width}: the checkpoint's encoder.conv_in has "
                         f"{have} output channels")


def convert(family: str, checkpoint: str, options: dict) -> dict:
    """The checkpoint as a state dict of the port's model (``taming_vqgan``:
    under ``"generator"``)."""
    sd = C.load_torch_state_dict(checkpoint)
    if family == "taming_vqgan":
        if "width" in options:
            _check_width(sd, options["width"])
        kwargs = {
            k: options[k]
            for k in ("enc_width_mults", "enc_depth", "dec_depth")
            if k in options
        }
        return {"generator": C.convert_taming_vqgan(sd, **kwargs)}
    if family == "beit_vqkd":
        return C.convert_beit_vqkd(sd)
    raise SystemExit(f"unknown family {family!r}")


def _nest(module, sd: dict) -> dict:
    """A state dict nested by the module's flax paths; names the module
    does not have stay top-level keys, for the merge to report."""
    paths = flax_param_paths(module)
    tree: dict = {}
    for name, value in sd.items():
        if name not in paths:
            tree[name] = value
            continue
        *parents, leaf = paths[name].split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def graft(runner, converted: dict):
    """strict=False merge of the converted weights over the runner's state,
    in place (and the state returned); under FSDP/TP each rank keeps its
    shard of the merged tensors. A ``"generator"`` entry goes to the
    generator of a GAN state, and is the whole model's otherwise."""
    state, algorithm = runner.state, runner.algorithm
    tree = _nest(state.model, converted.get("generator", converted))
    with runner.strategy.full_state(algorithm, state):
        params = algorithm.param_tree(state)
        if "generator" in params and "generator" in converted:
            tree = {"generator": tree}
        merge_params(params, tree)
    return state


def compare(
    results: dict, golden: dict, tols: dict
) -> list[tuple[str, float, float, float, bool]]:
    rows = []
    for key, want in golden.items():
        got = None
        for rkey, rval in results.items():
            # metric names come out namespaced ("l1/l1", "fid") — match on
            # the trailing path component
            if rkey == key or rkey.rsplit("/", 1)[-1] == key:
                got = float(rval)
                break
        if got is None:
            rows.append((key, want, float("nan"), float("nan"), False))
            continue
        tol = tols.get(key, 0.01)
        rows.append((key, want, got, got - want, abs(got - want) <= tol))
    return rows


def publish(family: str, results: dict, args, work_dir: str) -> str:
    """The entry, as the JAX tool writes it into ``BASELINE.json``, into
    ``<work_dir>/published.json`` (other families' entries kept)."""
    path = os.path.join(work_dir, "published.json")
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.setdefault("published", {})[family] = {
        "checkpoint": os.path.basename(args.checkpoint),
        "config": args.config,
        "metrics": {k: float(v) for k, v in results.items()},
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(f"published {family} metrics to {path}")
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("family", choices=sorted(GOLDEN))
    p.add_argument("--checkpoint", required=True, help="torch .pth/.ckpt")
    p.add_argument("--config", required=True, help="config with a validator")
    p.add_argument("--config-options", nargs="*", default=[])
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument(
        "--golden", default=None,
        help="JSON file or inline JSON overriding the built-in golden table",
    )
    p.add_argument(
        "--tol", default=None,
        help="JSON mapping metric→abs tolerance (merged over defaults)",
    )
    p.add_argument("--work-dir", default=None)
    p.add_argument("--publish", action="store_true", help="write <work_dir>/published.json")
    p.add_argument(
        "--converter-options", nargs="*", default=[],
        help="k=v options forwarded to the weight converter (width, ...)",
    )
    p.add_argument("--device", default=None, help="default: cuda (cpu runs the plain versions)")
    args = p.parse_args(argv)

    init_distributed(args.device)
    ns = argparse.Namespace(
        name=f"golden_{args.family}",
        config=args.config,
        config_options=args.config_options,
        override=args.override,
    )
    config = prepare(ns)
    validator = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)

    converted = convert(
        args.family, args.checkpoint, parse_kv(args.converter_options)
    )
    validator.init_state()
    graft(validator, converted)

    results = validator.run()
    print(json.dumps({k: float(v) for k, v in results.items()}, indent=2))

    golden = dict(GOLDEN[args.family])
    if args.golden:
        if os.path.exists(args.golden):
            with open(args.golden) as f:
                golden = json.load(f)
        else:
            golden = json.loads(args.golden)
    tols = dict(DEFAULT_TOL)
    if args.tol:
        tols.update(json.loads(args.tol))

    rows = compare(results, golden, tols)
    ok = True
    print(f"{'metric':<16}{'golden':>12}{'measured':>12}{'delta':>12}  ok")
    for key, want, got, delta, good in rows:
        ok &= good
        print(f"{key:<16}{want:>12.5f}{got:>12.5f}{delta:>+12.5f}  "
              f"{'PASS' if good else 'FAIL'}")
    if args.publish:
        publish(args.family, results, args, validator.work_dir)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
