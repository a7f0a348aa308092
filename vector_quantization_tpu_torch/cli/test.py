"""``python -m vector_quantization_tpu_torch.cli.test NAME CONFIG --load-model-from CKPT``

Validates one checkpoint with the config's ``validator`` and prints the
metric dict as JSON. ``--visual REGEX`` dumps the matching memo images
(``pred``, ``generated_image``, ``half_generated``) to
``<work_dir>/visuals``.
"""

from __future__ import annotations

import json

from ..parallel.mesh import init_distributed
from ..training.runner import build_runner
from .common import build_parser, log_run, prepare


def main(argv=None) -> dict[str, float]:
    parser = build_parser(__doc__)
    parser.add_argument("--visual", default=None, help="regex over memo keys to dump as images")
    args = parser.parse_args(argv)
    init_distributed()
    config = prepare(args)
    validator = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)
    if args.visual:
        validator.visual = {"pattern": args.visual, "keys": ["pred", "generated_image", "half_generated"],
                            **(validator.visual or {})}
    log_run(validator.work_dir, config)
    validator.init_state()
    if args.load_model_from:
        validator.load_model_from(args.load_model_from)
    results = validator.run()
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
