"""Batched, prefetching data loader (port of
``vector_quantization_tpu/data/loader.py``), host-side numpy.

The batch order is the JAX loader's exactly: ``batch_size_in_total`` is the
global batch, split evenly over the processes (``parallel.mesh``
``process_count``/``process_index`` unless given); with ``shuffle`` each
epoch permutes the indices with ``np.random.default_rng(seed + epoch)``;
with ``drop_last=False`` the last global batch is padded by wrapping to the
epoch's first indices (static shapes). ``_item_seed`` gives the native
decoder's per-item augmentation seeds, the same integers as JAX's.

Items are decoded by the native data plane (``data/native.py``) where the
dataset is file-backed JPEG and the augmentation is one it implements, else
in Python (PIL) on a thread pool; the first iteration logs which. ``pipeline``:
"thread" loads batches on a producer thread ahead of the consumer,
"inline" loads them in the consumer's thread, "auto" times both on the
first four batches of an epoch and keeps the faster. Every choice yields
the same batches.

``seek(epoch, batch)`` makes the next iteration start at that epoch's
``batch``-th batch: the trainer resumes there.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from ..parallel import mesh
from .base import BaseDataset, Item, pixel_encode
from .datasets import Batch, collate
from .native import AUGMENT_CODES, get_decoder

__all__ = ["Batch", "DataLoader"]

logger = logging.getLogger("vector_quantization_tpu_torch")


class DataLoader:
    def __init__(
        self,
        dataset: BaseDataset,
        *,
        batch_size_in_total: int | None = None,
        batch_size: int | None = None,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        num_processes: int | None = None,
        process_index: int | None = None,
        native: bool = True,
        pipeline: str = "auto",
    ) -> None:
        self.dataset = dataset
        self.num_processes = mesh.process_count() if num_processes is None else num_processes
        self.process_index = mesh.process_index() if process_index is None else process_index
        if batch_size_in_total is not None:
            if batch_size_in_total % self.num_processes:
                raise ValueError(
                    f"global batch {batch_size_in_total} not divisible by {self.num_processes} processes")
            self.batch_size = batch_size_in_total // self.num_processes
        elif batch_size is not None:
            self.batch_size = batch_size
        else:
            raise ValueError("need batch_size or batch_size_in_total")
        self.global_batch_size = self.batch_size * self.num_processes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.native = native
        if pipeline not in ("auto", "thread", "inline"):
            raise ValueError(f"unknown pipeline mode {pipeline!r}")
        self.pipeline = pipeline
        self._pipeline_choice: str | None = None  # what "auto" measured
        self.epoch = 0
        self._skip = 0
        self._logged_decoder = False

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch_size
        if not self.drop_last and len(self.dataset) % self.global_batch_size:
            n += 1
        return n

    def seek(self, epoch: int, batch: int = 0) -> None:
        self.epoch, self._skip = epoch, batch

    def _local_indices(self) -> list[list[int]]:
        """This process's index list of each batch of the epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = []
        for start in range(0, n, self.global_batch_size):
            chunk = order[start: start + self.global_batch_size]
            if len(chunk) < self.global_batch_size:
                if self.drop_last:
                    break
                chunk = np.concatenate([chunk, order[: self.global_batch_size - len(chunk)]])
            lo = self.process_index * self.batch_size
            batches.append(chunk[lo: lo + self.batch_size].tolist())
        return batches

    def _item_seed(self, epoch: int, index: int) -> int:
        """A stable per-(seed, epoch, item) augmentation seed (splitmix-style)."""
        z = (self.seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9 + index * 0x94D049BB133111EB
             + 0xD6E8FEB86659FD93) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        return (z ^ (z >> 31)) & 0xFFFFFFFFFFFFFFFF

    def _load_batch_native(self, idxs: list[int], epoch: int, decoder) -> Batch:
        """The native decoder for file-backed JPEG items; Python for the rest
        and for any item the decoder refused."""
        ds = self.dataset
        records = [ds.native_record(i) for i in idxs]
        nat = [j for j, r in enumerate(records) if r is not None]
        items: list[Item | None] = [None] * len(idxs)
        if nat:
            imgs, ok = decoder.decode_batch([records[j][0] for j in nat], ds.image_size,
                                            ds.transform.augmentation,
                                            [self._item_seed(epoch, idxs[j]) for j in nat])
            for k, j in enumerate(nat):
                if ok[k]:
                    _, id_, category = records[j]
                    items[j] = Item(id_=id_, original_image=imgs[k], image=pixel_encode(imgs[k]),
                                    category=category)
        return collate([ds[idxs[j]] if it is None else it for j, it in enumerate(items)])

    def _decoder(self):
        """The native decoder where it applies, else None (the first
        iteration logs which decoder runs)."""
        ds = self.dataset
        decoder = None
        if self.native and ds.transform.augmentation in AUGMENT_CODES and len(ds) \
                and ds.native_record(0) is not None:
            decoder = get_decoder(self.num_workers or None)
        if not self._logged_decoder:
            self._logged_decoder = True
            if decoder is not None:
                logger.info("data: native decode plane active (%d threads)", decoder.num_threads)
            else:
                logger.info("data: Python decode (%s)", type(ds).__name__)
        return decoder

    def __iter__(self) -> Iterator[Batch]:
        batches = self._local_indices()[self._skip:]
        self._skip = 0
        epoch = self.epoch
        self.epoch += 1
        decoder = self._decoder()
        choice = "inline" if self.num_workers <= 0 else (
            self.pipeline if self.pipeline != "auto" else self._pipeline_choice or "auto")
        start = 0
        if choice == "auto":
            if len(batches) >= 4:
                yield from self._calibrate(batches[:4], epoch, decoder)
                start = 4
            choice = self._pipeline_choice or "thread"
        if choice == "inline":
            pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 and decoder is None else None
            try:
                for idxs in batches[start:]:
                    yield self._load(idxs, epoch, decoder, pool)
            finally:
                if pool is not None:
                    pool.shutdown()
            return
        yield from self._threaded(batches[start:], epoch, decoder)

    def _threaded(self, batches: list[list[int]], epoch: int, decoder) -> Iterator[Batch]:
        """Batches loaded by a producer thread up to ``prefetch`` ahead; the
        thread ends when the consumer stops early."""
        q: queue.Queue[Any] = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if not put(self._load(idxs, epoch, decoder, pool)):
                            return
            except Exception as e:  # handed to the consumer, which re-raises it
                put(e)
                return
            put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=60)

    def _load(self, idxs: list[int], epoch: int, decoder, pool=None) -> Batch:
        if decoder is not None:
            return self._load_batch_native(idxs, epoch, decoder)
        if pool is not None:
            return collate(list(pool.map(self.dataset.__getitem__, idxs)))
        return collate([self.dataset[i] for i in idxs])

    def _calibrate(self, batches: list[list[int]], epoch: int, decoder) -> list[Batch]:
        """Two batches inline and two through a producer thread, timed; the
        winner goes to ``_pipeline_choice`` (kept across epochs). The thread
        wins unless it is more than 15% slower: in a trainer it also
        overlaps the device's work, which this timing cannot see."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(self.num_workers) as pool:
            out = [self._load(idxs, epoch, decoder, pool) for idxs in batches[:2]]
        t_inline = max(time.perf_counter() - t0, 1e-9)
        t0 = time.perf_counter()
        out.extend(self._threaded(batches[2:], epoch, decoder))
        t_thread = max(time.perf_counter() - t0, 1e-9)
        self._pipeline_choice = "thread" if t_thread <= 1.15 * t_inline else "inline"
        n = 2 * self.batch_size
        logger.info("data: pipeline auto-calibration inline %.1f img/s vs thread %.1f img/s -> %s",
                    n / t_inline, n / t_thread, self._pipeline_choice)
        return out
