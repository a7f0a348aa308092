"""``python -m vector_quantization_tpu_torch.cli.val NAME CONFIG``

The validation daemon: watches the trainer's ``<work_dir>/checkpoints/``
and validates each new checkpoint, oldest first, with a fresh state of the
config's ``validator`` (``init_state``, then a full ``resume`` from the
checkpoint, then ``run``), writing each metric to TensorBoard as
``val/<metric>`` at the checkpoint's step (``iter_N`` -> N). TensorBoard
missing, it logs a warning and writes nothing. When a scan finds nothing
new it sleeps 600 s (10 s under ``DRY_RUN``); ``--max-idle-rounds N`` stops
it after N empty scans (1 by default under ``DRY_RUN``). ``--load-from
iter_A,iter_B`` validates only those and stops once they are done;
``--visual REGEX`` dumps the matching memo images to ``<work_dir>/visuals``.
"""

from __future__ import annotations

import logging
import os
import time

from ..parallel.mesh import init_distributed, process_index
from ..training.checkpoints import checkpoint_file
from ..training.runner import build_runner
from ..utils.flags import Store
from .common import build_parser, prepare

logger = logging.getLogger("vector_quantization_tpu_torch")


class CheckpointMonitor:
    """Yields each new checkpoint's path: a scan lists the directory's
    entries that hold a whole checkpoint (a save in progress does not yet),
    passes the whitelist and blacklist, drops those already yielded and
    yields the rest oldest first (``getctime``)."""

    def __init__(self, checkpoint_dir: str, whitelist: list[str] | None = None,
                 blacklist: list[str] | None = None, sleep_s: float | None = None,
                 max_idle_rounds: int | None = None) -> None:
        self.checkpoint_dir = checkpoint_dir
        self.whitelist = whitelist
        self.blacklist = set(blacklist or [])
        self.sleep_s = sleep_s if sleep_s is not None else 10 if Store.DRY_RUN else 600
        self.max_idle_rounds = max_idle_rounds
        self.seen: set[str] = set()

    def _scan(self) -> list[str]:
        if not os.path.isdir(self.checkpoint_dir):
            return []
        fresh = [os.path.join(self.checkpoint_dir, name) for name in os.listdir(self.checkpoint_dir)
                 if name not in self.blacklist and (self.whitelist is None or name in self.whitelist)]
        fresh = [p for p in fresh if p not in self.seen and os.path.exists(checkpoint_file(p))]
        return sorted(fresh, key=os.path.getctime)

    def __iter__(self):
        idle = 0
        while True:
            fresh = self._scan()
            if not fresh:
                idle += 1
                if self.max_idle_rounds is not None and idle >= self.max_idle_rounds:
                    return
                logger.info("no new checkpoints; sleeping %ss", self.sleep_s)
                time.sleep(self.sleep_s)
                continue
            idle = 0
            for path in fresh:
                self.seen.add(path)
                yield path


def _writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger.warning("tensorboard unavailable; val/<metric> scalars are not written")
        return None
    return SummaryWriter(log_dir)


def main(argv=None) -> dict[str, dict[str, float]]:
    """Returns each validated checkpoint's metrics by its name."""
    parser = build_parser(__doc__)
    parser.add_argument("--max-idle-rounds", type=int, default=None)
    parser.add_argument("--visual", default=None, help="regex over memo keys to dump as images")
    args = parser.parse_args(argv)
    init_distributed(args.device)
    config = prepare(args)
    validator = build_runner(config, "validator", device=args.device, work_dir=args.work_dir)
    if args.visual:
        validator.visual = {"pattern": args.visual, "keys": ["pred", "generated_image", "half_generated"],
                            **(validator.visual or {})}
    writer = _writer(os.path.join(validator.work_dir, "tensorboard")) if process_index() == 0 else None
    monitor = CheckpointMonitor(os.path.join(validator.work_dir, "checkpoints"),
                                max_idle_rounds=args.max_idle_rounds or (1 if Store.DRY_RUN else None))
    whitelist = set(args.load_from.split(",")) if args.load_from else None
    done: dict[str, dict[str, float]] = {}
    for path in monitor:
        tag = os.path.basename(path)
        if whitelist is not None:
            if tag not in whitelist:
                continue
            whitelist.discard(tag)
        logger.info("validating %s", tag)
        validator.init_state()
        validator.resume(path)
        done[tag] = results = validator.run()
        if writer is not None:
            step = int(tag.split("_")[-1]) if "_" in tag else 0
            for k, v in results.items():
                writer.add_scalar(f"val/{k}", v, step)
            writer.flush()
        if whitelist is not None and not whitelist:
            break
    if writer is not None:
        writer.close()
    return done


if __name__ == "__main__":
    main()
