"""Extract the EMA shadow weights from a checkpoint into a weights-only
checkpoint (port of ``tools/model_ema.py``).

    python -m vector_quantization_tpu_torch.tools.model_ema work_dirs/x/checkpoints/iter_100000 out_dir

Reads ``<checkpoint>/state.pt``'s ``extra["ema_params"]`` and writes
``<out_dir>/state.pt`` holding ``{"params": ema}``, which
``--load-model-from out_dir`` merges over a state's weights. The shadow is
the trained model's tree; where the checkpoint's ``params`` split into
``generator`` and ``discriminator`` (a GAN algorithm) it is written under
``generator``, so it loads into the generator of the same algorithm. A
checkpoint without EMA exits with ``checkpoint has no extra/ema_params``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..training.checkpoints import checkpoint_file

__all__ = ["main"]


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint")
    p.add_argument("out")
    args = p.parse_args(argv)

    state = torch.load(checkpoint_file(args.checkpoint), map_location="cpu", weights_only=True)
    ema = state.get("extra", {}).get("ema_params")
    if ema is None:
        raise SystemExit("checkpoint has no extra/ema_params")
    if "generator" in state.get("params", {}):
        ema = {"generator": ema}
    out = checkpoint_file(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"params": ema}, out + ".tmp")
    os.replace(out + ".tmp", out)
    print(f"saved EMA params to {args.out}")
    return out


if __name__ == "__main__":
    main()
