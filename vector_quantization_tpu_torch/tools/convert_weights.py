"""Convert reference/pretrained torch checkpoints into state dicts of the
port's modules (port of ``tools/convert_weights.py``).

    python -m vector_quantization_tpu_torch.tools.convert_weights vgg16_lpips --src vgg16.pth \\
        --lin vgg.pth --out pretrained/lpips
    python -m vector_quantization_tpu_torch.tools.convert_weights pt_inception --src pt_inception.pth \\
        --out pretrained/inception
    python -m vector_quantization_tpu_torch.tools.convert_weights taming_vqgan --src last.ckpt \\
        --out pretrained/vqgan_f16_16384 [--check CONFIG]
    python -m vector_quantization_tpu_torch.tools.convert_weights clip_visual --src ViT-B-16.pt --out ...
    python -m vector_quantization_tpu_torch.tools.convert_weights gpt2 --src pytorch_model.bin --out ...
    python -m vector_quantization_tpu_torch.tools.convert_weights hf_llama --src consolidated.pth --out ...

Writes ``<out>/<kind>.pth``, a state dict for the port's module
(``load_state_dict(strict=True)``). ``pt_inception`` keeps pytorch-fid's
names (``fc.*``/``AuxLogits.*`` dropped) and is checked to load strictly
into ``InceptionV3Features``; ``vgg16_lpips`` with ``--lin`` into ``LPIPS``
(training reads LPIPS from ``$PRETRAINED/lpips``'s upstream files instead,
converting them as it loads).
``--check CONFIG`` builds the config's module on the meta device (the
trainer algorithm's ``model`` for taming_vqgan, its
``transformer`` for gpt2 and hf_llama, its ``teacher`` for clip_visual) and
requires a strict load: any missing, unexpected or mis-shaped key is
listed and the tool exits 1 without writing.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..models.losses.lpips import LPIPS
from ..models.metrics.inception import InceptionV3Features, pt_inception_state_dict
from ..registries import ModelRegistry, TeacherRegistry, TransformerRegistry
from ..utils.config import load_config
from ..utils.converters import (
    convert_clip_visual,
    convert_gpt2,
    convert_hf_llama,
    convert_taming_vqgan,
    convert_vgg16_lpips,
    load_torch_state_dict,
)

__all__ = ["KINDS", "check_against_config", "check_strict", "convert", "main"]

# kind -> (the trainer algorithm's key for --check, its registry)
KINDS = {
    "vgg16_lpips": None,
    "pt_inception": None,
    "taming_vqgan": ("model", ModelRegistry),
    "clip_visual": ("teacher", TeacherRegistry),
    "gpt2": ("transformer", TransformerRegistry),
    "hf_llama": ("transformer", TransformerRegistry),
}


def check_strict(module: torch.nn.Module, sd: dict) -> bool:
    """Print the keys ``sd`` misses, has extra and mis-shapes against
    ``module``'s state dict (the JAX tool's report); True where there are
    none, and then ``sd`` is loaded strictly (``assign``, so a module on
    the meta device takes the tensors)."""
    def shapes(tensors):  # BatchNorm's counter has no weight in it: either side may lack it
        return {k: tuple(v.shape) for k, v in tensors.items() if not k.endswith("num_batches_tracked")}

    want, got = shapes(module.state_dict()), shapes(sd)
    missing = sorted(set(want) - set(got))
    extra_keys = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing:
        print(f"MISSING ({len(missing)}):", *missing[:20], sep="\n  ")
    if extra_keys:
        print(f"EXTRA ({len(extra_keys)}):", *extra_keys[:20], sep="\n  ")
    if mismatched:
        print(f"SHAPE MISMATCH ({len(mismatched)}):")
        for k in mismatched[:20]:
            print(f"  {k}: model {want[k]} vs converted {got[k]}")
    if missing or extra_keys or mismatched:
        return False
    module.load_state_dict(sd, strict=False, assign=True)  # num_batches_tracked may be absent
    return True


def _build_meta(registry, cfg):
    with torch.device("meta"):
        try:
            return registry.build(cfg, device="meta")
        except TypeError:
            return registry.build(cfg)


def check_against_config(kind: str, sd: dict, config_path: str) -> bool:
    key, registry = KINDS[kind]
    algo = load_config(config_path)["trainer"]["algorithm"]
    if key not in algo:
        raise SystemExit(f"--check {config_path}: trainer.algorithm has no {key!r} for {kind}")
    return check_strict(_build_meta(registry, algo[key]), sd)


def convert(kind: str, src: str, lin: str | None = None) -> dict[str, torch.Tensor]:
    if kind == "pt_inception":
        return pt_inception_state_dict(src)
    sd = load_torch_state_dict(src)
    if kind == "vgg16_lpips":
        return convert_vgg16_lpips(sd, load_torch_state_dict(lin) if lin else None)
    return {"taming_vqgan": convert_taming_vqgan, "clip_visual": convert_clip_visual, "gpt2": convert_gpt2,
            "hf_llama": convert_hf_llama}[kind](sd)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=list(KINDS))
    p.add_argument("--src", required=True)
    p.add_argument("--lin", default=None, help="LPIPS lin weights (.pth)")
    p.add_argument("--out", required=True)
    p.add_argument("--check", default=None, help="config to verify against")
    args = p.parse_args(argv)

    sd = convert(args.kind, args.src, args.lin)
    ok = True
    if args.kind == "pt_inception":
        ok = check_strict(InceptionV3Features(), sd)
    elif args.kind == "vgg16_lpips" and args.lin:
        ok = check_strict(LPIPS(), sd)
    if ok and args.check:
        if KINDS[args.kind] is None:
            print(f"--check: {args.kind} loads into its own module, checked above")
        else:
            ok = check_against_config(args.kind, sd, args.check)
    if not ok:
        raise SystemExit(1)
    print("check OK: converted tree matches the model")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.kind}.pth")
    torch.save({k: v.contiguous() for k, v in sd.items()}, path)
    print(f"saved converted params to {path}")
    return path


if __name__ == "__main__":
    main()
