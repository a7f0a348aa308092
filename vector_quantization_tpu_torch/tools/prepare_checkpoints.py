"""Pretrained-dependency manifest and converter (port of
``tools/prepare_checkpoints.py``).

The reference downloads these files. This tool downloads nothing: it (a)
lists what to fetch and where to put it, and (b) converts everything it
finds under ``--src-dir`` through ``tools.convert_weights`` (one
``python -m`` per file).

    python -m vector_quantization_tpu_torch.tools.prepare_checkpoints [--src-dir downloads] \\
        [--out-dir pretrained]

Expected files under --src-dir:
  pt_inception-2015-12-05-6726825d.pth     (pytorch-fid inception)
  vgg16-397923af.pth                       (torchvision VGG16)
  vgg.pth / vgg.pth.converted              (LPIPS lin weights)
  vqgan_imagenet_f16_16384/last.ckpt       (taming-transformers VQGAN)
  ViT-B-16.pt                              (OpenAI CLIP)
  dino_vitbase16_pretrain.pth              (DINO ViT-B/16)
  mae_pretrain_vit_base.pth                (MAE ViT-B/16)
  gpt2/pytorch_model.bin                   (HF GPT-2)
  vqkd_encoder_base_...beit_v2.pth         (BEiT-v2 VQ-KD)
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

__all__ = ["KNOWN", "main"]

KNOWN = {
    "pt_inception-2015-12-05-6726825d.pth": ("pt_inception", "inception"),
    "vgg16-397923af.pth": ("vgg16_lpips", "lpips"),
    "ViT-B-16.pt": ("clip_visual", "clip_b16"),
    "pytorch_model.bin": ("gpt2", "gpt2"),
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src-dir", default="downloads")
    p.add_argument("--out-dir", default="pretrained")
    args = p.parse_args(argv)

    if not os.path.isdir(args.src_dir):
        print(__doc__)
        print(f"(source dir {args.src_dir!r} not found — nothing converted)")
        return

    # the package importable from the child wherever this runs from
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [package_root, os.environ.get("PYTHONPATH")]))}
    for root, _, files in os.walk(args.src_dir):
        for f in files:
            if f not in KNOWN:
                continue
            kind, out_name = KNOWN[f]
            cmd = [
                sys.executable,
                "-m",
                "vector_quantization_tpu_torch.tools.convert_weights",
                kind,
                "--src",
                os.path.join(root, f),
                "--out",
                os.path.join(args.out_dir, out_name),
            ]
            if kind == "vgg16_lpips":
                lin = os.path.join(args.src_dir, "vgg.pth.converted")
                if os.path.exists(lin):
                    cmd += ["--lin", lin]
            print("+", " ".join(cmd))
            subprocess.run(cmd, check=True, env=env)


if __name__ == "__main__":
    main()
