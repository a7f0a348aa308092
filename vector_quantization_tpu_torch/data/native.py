"""ctypes binding to the native data plane (the port's copy of
``vector_quantization_tpu/data/native.py``; the library is the repo's
``native/libvqtdata.so``, built from ``native/dataplane.cpp`` by ``make -C
native`` the first time a decoder is asked for).

One ``decode_batch`` call JPEG-decodes and transforms a whole batch on a
persistent native thread pool, without the GIL, into a numpy buffer. Where
the library cannot be built or loaded (no compiler or libjpeg), ``get_decoder``
returns None and the loader decodes with PIL; the loader logs which of the
two it uses.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["AUGMENT_CODES", "NativeDecoder", "get_decoder", "native_available"]

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvqtdata.so")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False

AUGMENT_CODES = {"none": 0, "default": 1}


def _load_lib():
    """The native library (built if missing), or None."""
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_attempted:
            _build_attempted = True
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.vqt_create.restype = ctypes.c_void_p
        lib.vqt_create.argtypes = [ctypes.c_int]
        lib.vqt_destroy.restype = None
        lib.vqt_destroy.argtypes = [ctypes.c_void_p]
        lib.vqt_version.restype = ctypes.c_int
        lib.vqt_version.argtypes = []
        lib.vqt_decode_batch.restype = ctypes.c_int64
        lib.vqt_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeDecoder:
    """A persistent native thread pool decoding batches of JPEG paths."""

    def __init__(self, num_threads: int | None = None) -> None:
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native data plane unavailable")
        self._lib = lib
        self.num_threads = num_threads or min(os.cpu_count() or 8, 16)
        self._handle = lib.vqt_create(int(self.num_threads))

    def __del__(self):  # pragma: no cover - interpreter teardown order
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.vqt_destroy(handle)
            self._handle = None

    def decode_batch(self, paths: list[str], image_size: int, augmentation: str,
                     seeds) -> tuple[np.ndarray, np.ndarray]:
        """``paths`` -> (uint8 (n, S, S, 3), ok bool (n,)); an item with
        ``ok=False`` (not a baseline RGB JPEG, truncated) is left for the
        caller's Python path."""
        n, s = len(paths), int(image_size)
        out = np.empty((n, s, s, 3), np.uint8)
        ok = np.empty((n,), np.uint8)
        seeds_arr = np.ascontiguousarray(seeds, dtype=np.uint64)
        if seeds_arr.shape != (n,):
            raise ValueError(f"{seeds_arr.shape[0]} seeds for {n} paths")
        c_paths = (ctypes.c_char_p * n)(*[p.encode("utf-8") for p in paths])
        self._lib.vqt_decode_batch(
            self._handle, c_paths, n, s, AUGMENT_CODES[augmentation],
            seeds_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, ok.astype(bool)


_decoder: NativeDecoder | None = None
_decoder_lock = threading.Lock()


def get_decoder(num_threads: int | None = None) -> NativeDecoder | None:
    """The process-wide decoder, or None where the native plane is out."""
    global _decoder
    with _decoder_lock:
        if _decoder is None and native_available():
            _decoder = NativeDecoder(num_threads)
        return _decoder
