"""``python -m vector_quantization_tpu_torch.cli.train NAME CONFIG [...]``

Trains the config's ``trainer`` (on CUDA unless ``--device cpu``): writes
``<work_dir>/config.json`` and ``run.log``, logs ``Iter [i/N] ...`` lines,
saves ``<work_dir>/checkpoints/iter_N`` at the checkpoint callback's
interval. ``--load-model-from A [B ...]`` merges weights first;
``--load-from CKPT`` resumes from a checkpoint, ``--auto-resume`` from the
work dir's newest one.
"""

from __future__ import annotations

from ..parallel.mesh import init_distributed
from ..training.runner import build_runner
from .common import build_parser, log_run, prepare


def main(argv=None):
    args = build_parser(__doc__).parse_args(argv)
    init_distributed(args.device)
    config = prepare(args)
    trainer = build_runner(config, "trainer", device=args.device, work_dir=args.work_dir)
    log_run(trainer.work_dir, config)
    trainer.init_state()
    if args.load_model_from:
        trainer.load_model_from(args.load_model_from)
    if args.load_from or args.auto_resume:
        trainer.resume(args.load_from, auto=args.auto_resume)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
