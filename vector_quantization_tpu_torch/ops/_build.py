"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``, Hopper),
placed in ``_kernels_build/<hash>/lib<name>.so`` beside the package (a
directory ``.gitignore`` lists). The hash covers the source and the flags,
so an edited source rebuilds and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits for
them; :func:`load` builds a single source on first use. A failed build
raises with the compiler's output.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), where the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_all", "load", "sources"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_kernels_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME/bin): the CUDA kernels "
            "are built on a machine with the CUDA toolkit"
        )
    return found


def _target(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (out.parent / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` in parallel; returns {name: nvcc log}
    (the saved log for sources already built). Raises if any build fails."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        logs, errors = {}, []
        for name, job in jobs.items():
            if job is None:
                saved = _target(name).parent / f"{name}.log"
                logs[name] = saved.read_text() if saved.exists() else ""
                continue
            try:
                logs[name] = _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
