"""The measured window, shared by the drivers.

The window starts once set-up has synchronised the device and reset its
memory peak. It calls ``work()`` back to back until ``seconds`` have
passed on the host clock, then synchronises: its length is the host time
from its start to that synchronise, so a rate over it counts all the work
the window enqueued and all the time the device took for it. With
``--trace 1`` it runs under the profiler, inside the ``window`` range and
with the metrics' entry ranges in place.
"""

from __future__ import annotations

import gc
import time

import torch

from .trace import profiled


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start(cell) -> float:
    """Ends set-up: synchronise, reset the memory peak; returns ``setup_s``."""
    sync(cell.device)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    return time.perf_counter() - cell.t_start


_ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def allocator(device) -> dict:
    """The caching allocator's counts of retries and of device mallocs and
    frees (each a device synchronisation)."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in _ALLOC}


def window(cell, work) -> tuple[list, float, object]:
    """(what each call of ``work`` returned, the window's seconds, the trace).
    Notes on standard error what the allocator did inside the window."""
    done = []
    before = allocator(cell.device)
    with profiled(cell.trace, cell.device.type == "cuda") as holder:
        with cell.entry_ranges(), cell.range("window"):
            t0 = time.perf_counter()
            while True:
                done.append(work())
                if time.perf_counter() - t0 >= cell.seconds:
                    break
            sync(cell.device)
            seconds = time.perf_counter() - t0
    after = allocator(cell.device)
    if after:
        cell.notes["allocator in the window"] = ", ".join(f"{k} {after[k] - before[k]}" for k in _ALLOC)
    return done, seconds, holder.trace


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Return the freed program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
