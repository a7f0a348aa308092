"""Shared CLI plumbing (port of ``vector_quantization_tpu/cli/common.py``).

Every command takes ``NAME CONFIG [--config-options K=V ...] [--override
PATH=VALUE ...] [--load-model-from CKPT ...] [--load-from CKPT]
[--auto-resume] [--work-dir DIR] [--device DEVICE]``: values are parsed as
Python literals where they can be; ``--override`` patches dotted/indexed
config paths; ``--device`` defaults to CUDA (``cpu`` runs the kernels' plain
versions). The config's ``custom_imports`` are imported before a runner is
built.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import logging
import os
import sys
from typing import Any

from ..utils.config import Config, load_config

__all__ = ["build_parser", "parse_kv", "prepare", "log_run"]

logger = logging.getLogger("vector_quantization_tpu_torch")
_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def parse_kv(pairs: list[str]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("name")
    p.add_argument("config")
    p.add_argument("--config-options", nargs="*", default=[])
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--load-model-from", nargs="*", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", default=None, help="default: cuda (cpu runs the plain versions)")
    return p


def prepare(args: argparse.Namespace) -> Config:
    """The package logger at INFO on stderr, then the config: loaded with
    ``--config-options``, patched by ``--override``, ``name`` defaulted."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    config = load_config(args.config, **parse_kv(args.config_options))
    config.override(parse_kv(args.override))
    config.setdefault("name", args.name)
    for mod in config.get("custom_imports", []) or []:
        importlib.import_module(mod)
    importlib.import_module("vector_quantization_tpu_torch")  # registers the built-in classes
    return config


def log_run(work_dir: str, config: Config) -> None:
    """The command line into ``work_dir/run.log``, the config into
    ``work_dir/config.json``, and every later log line into ``run.log``."""
    os.makedirs(work_dir, exist_ok=True)
    log_file = os.path.join(work_dir, "run.log")
    with open(log_file, "a") as f:
        f.write(" ".join(sys.argv) + "\n")
    config.dump(os.path.join(work_dir, "config.json"))
    if not any(isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == log_file
               for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
