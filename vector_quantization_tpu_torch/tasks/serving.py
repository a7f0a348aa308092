"""Continuous-batching AR serving engine (port of
``vector_quantization_tpu/tasks/serving.py``).

A slot-based decode loop: new requests prefill (class token) in the same
step in which other slots are mid-image.

- **CFG serving**: each request occupies a PAIR of adjacent rows (even =
  unconditional token, odd = class token); the step mixes the pair's
  logits ``(1-alpha)*u + alpha*c``, samples once and feeds the same token to
  both lanes.
- **Multi-step decode between host syncs** (``steps_per_sync``): each sync
  runs that many decode steps as a Python loop of device work and reads the
  sampled tokens back once.
- **Shared-column staggered decode** (the dense default, ``paged=False``):
  every row writes its KV at ONE shared cache column (a slice write); a row
  admitted mid-stream starts at the current column, with a per-row lower
  bound on its attention mask and RoPE rotated by the shared column
  (rotary attention depends only on the q-k column distance, so every
  row's logits are kept). Arrivals and completions are deterministic in
  step counts, so the host schedules them at ``sync_chunk`` boundaries
  inside a sync with no readback; a compaction shift, carried by the next
  chunk, keeps the column space bounded; a sync's tokens are read back
  only after the next sync's steps are queued.
- **Per-row scatter** (``aligned=False`` on the dense cache, or
  ``paged=True``): each row writes its KV at its own position. The dense
  window grows in 64-column buckets between ``sync_chunk`` chunks; the
  paged pool (page 0 a scratch page idle rows write into) allocates pages
  as positions grow and admits a request only when the pool can hold all
  of its pages.

Tensor-parallel serving (``strategy=``) is a later slice and raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from ..models.transformers.llama import resize_rows
from ..models.transformers.sampling import sample_tokens
from .sequence_modeling import TokenCodebook

__all__ = ["ARServer"]


@dataclasses.dataclass
class _Slot:
    request_id: int | None = None
    category: int = 0
    tokens: list[int] = dataclasses.field(default_factory=list)
    # shared-column engine: the cache column where this request's stream
    # began, and where it was replaced (None while live)
    start_col: int = 0
    end_col: int | None = None


class ARServer:
    """Class-conditional image-token server.

    >>> server = ARServer(transformer, state_dict, codebook, image_tokens=256)
    >>> server.submit(category=3)
    >>> finished = server.run_until_drained()

    ``params`` is a state dict for ``transformer`` (``utils/bridge.py``
    makes one from flax params) or None to serve the module's own weights;
    the module is moved to ``device``. ``device=None`` means ``"cuda"``;
    without a GPU that raises. Pass ``device="cpu"`` to run the kernels'
    plain versions on the CPU.

    With ``cfg_alpha`` set (requires ``uncond_token``, normally
    ``num_categories``), requests occupy slot *pairs* and are sampled from
    CFG-mixed logits.

    ``paged=False`` (the default) serves from the dense cache: the
    shared-column engine for transformers with relative positions
    (``supports_shared_column``), unless ``aligned=False`` forces the
    per-row scatter. ``sync_chunk`` splits each sync's steps into chunks of
    that many (the dense window regrows, or slots turn over, between
    chunks); None = one chunk per sync. It does nothing for the paged pool.
    """

    def __init__(
        self,
        transformer: Any,
        params: Mapping[str, torch.Tensor] | None,
        image_codebook: TokenCodebook,
        *,
        image_tokens: int,
        batch_slots: int = 16,
        sampler: Mapping[str, Any] | None = None,
        seed: int = 0,
        cache_dtype: torch.dtype = torch.int8,
        cfg_alpha: float | None = None,
        uncond_token: int | None = None,
        steps_per_sync: int = 1,
        sync_chunk: int | None = 64,
        paged: bool = False,
        page_size: int = 64,
        num_pages: int | None = None,
        strategy: Any | None = None,
        aligned: bool | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        if strategy is not None:
            raise NotImplementedError(
                "strategy= (tensor-parallel serving): ROADMAP.md queue A: Parallelism"
            )
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ARServer runs on CUDA by default and no GPU is available; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        if cfg_alpha is not None:
            if uncond_token is None:
                raise ValueError("cfg_alpha requires uncond_token")
            if batch_slots % 2:
                raise ValueError("cfg_alpha requires an even batch_slots")
        if steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        if sync_chunk is not None and sync_chunk < 1:
            # 0 would silently disable chunking; a negative chunk would
            # never advance the sync's step loop
            raise ValueError("sync_chunk must be None or >= 1")
        # overshoot room: a slot finishing mid-sync keeps decoding until the
        # next host sync (class token + image tokens + (k-1) overshoot)
        needed = 1 + image_tokens + steps_per_sync - 1
        self._needed = needed
        if not paged and transformer.max_length < needed:
            raise ValueError(
                f"transformer.max_length {transformer.max_length} < "
                f"{needed} (1 + image_tokens + steps_per_sync - 1)"
            )
        if params is not None:
            transformer.load_state_dict(params)
        self.transformer = transformer.to(device).eval()
        self.device = device
        self.codebook = image_codebook
        self.image_tokens = image_tokens
        self.batch_slots = batch_slots
        self.sampler = dict(sampler or {})
        self.cfg_alpha = cfg_alpha
        self.uncond_token = uncond_token
        self.steps_per_sync = steps_per_sync
        self.sync_chunk = min(sync_chunk, steps_per_sync) if sync_chunk else steps_per_sync
        self.lanes = 2 if cfg_alpha is not None else 1
        self.num_requests_slots = batch_slots // self.lanes
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.queue: deque[tuple[int, int]] = deque()  # (request_id, category)
        self.slots = [_Slot() for _ in range(self.num_requests_slots)]
        self._next_id = 0
        self.paged = paged
        if paged:
            self.page_size = page_size
            self.pages_per_slot = -(-needed // page_size)
            if num_pages is None:
                num_pages = 1 + batch_slots * self.pages_per_slot
            min_rows = self.lanes  # one request's rows must fit or deadlock
            if num_pages < 1 + min_rows * self.pages_per_slot:
                raise ValueError(
                    f"num_pages {num_pages} cannot hold even one request "
                    f"(needs 1 + {min_rows}*{self.pages_per_slot})"
                )
            self.cache = self.transformer.init_paged_cache(
                batch_slots, num_pages, page_size, self.pages_per_slot,
                dtype=cache_dtype, device=device,
            )
            self._free_pages = list(range(num_pages - 1, 0, -1))
            self._total_pages = num_pages - 1  # page 0 reserved scratch
            self._pages_reserved = 0
            self._page_table = np.zeros((batch_slots, self.pages_per_slot), np.int32)
            self._row_pages: list[list[int]] = [[] for _ in range(batch_slots)]
        else:
            # length-aware window: the dense cache holds the current
            # 64-column bucket and grows between chunks, so attention reads
            # follow the live positions instead of the full capacity
            self._window = min(64 * -(-steps_per_sync // 64), needed)
            self.cache = self.transformer.init_cache(
                batch_slots, dtype=cache_dtype, device=device, rows=self._window)

        # host mirrors: current token + position per BATCH ROW (inactive
        # rows idle at position 0 with token 0)
        self.tokens = np.zeros(batch_slots, np.int32)
        self.positions = np.zeros(batch_slots, np.int32)
        self.active = np.zeros(self.num_requests_slots, bool)

        # shared-column engine: dense cache and relative positions (RoPE);
        # aligned=False forces the per-row scatter
        self._shared_col = (aligned is not False and not paged
                            and getattr(transformer, "supports_shared_column", False))
        self._sc_pending: tuple | None = None
        if self._shared_col:
            self.col = 0  # next cache column to be written
            # starts live on the host; each chunk uploads them with its steps
            self.starts = np.zeros(batch_slots, np.int32)
            self._tokens_dev: torch.Tensor | None = None
            self._finished_slots: list[_Slot] = []
            # turnover and compaction consumed by the NEXT chunk dispatch
            self._reset_mask = np.zeros(batch_slots, bool)
            self._reset_tokens = np.zeros(batch_slots, np.int32)
            self._pending_shift = 0
            # window ceiling: after a sync-start compaction the live span is
            # <= image_tokens + sync_chunk - 1 (completions are replaced at
            # chunk boundaries) + 63 rounding; within a sync the column
            # advances steps_per_sync more
            self._sc_cap = 64 + 64 * -(
                -(1 + image_tokens + self.sync_chunk + 62 + steps_per_sync) // 64
            )

        # decode-step accounting: row_steps = batch rows x steps executed,
        # split active/idle; delivered = image tokens kept. device_s =
        # dispatch -> readback wall; host_s = bookkeeping.
        self.stats = {
            "syncs": 0,
            "row_steps_active": 0,
            "row_steps_idle": 0,
            "tokens_delivered": 0,
            "device_s": 0.0,
            "host_s": 0.0,
        }

    # -- public api ----------------------------------------------------------

    def submit(self, category: int) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, int(category)))
        return rid

    @property
    def pending(self) -> int:
        n = len(self.queue) + int(self.active.sum())
        if self._sc_pending is not None:
            n += 1  # a dispatched sync awaiting extraction
        return n

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the server's device, without waiting for
        the device (a copy from pageable memory is staged at once)."""
        return torch.from_numpy(np.array(a)).to(self.device, non_blocking=True)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        cb, s = self.codebook, self.sampler
        kw = dict(
            temperature=s.get("temperature", 1.0),
            top_k=s.get("top_k", 0),
            top_p=s.get("top_p", 1.0),
        )
        if self.cfg_alpha is not None:
            a = self.cfg_alpha
            # interleaved pairs: even rows uncond, odd rows cond
            mixed = (1.0 - a) * logits[0::2] + a * logits[1::2]
            tok = sample_tokens(self.generator, mixed, cb.start, cb.end, **kw)
            return torch.repeat_interleave(tok, self.lanes)
        return sample_tokens(self.generator, logits, cb.start, cb.end, **kw)

    @torch.inference_mode()
    def step(self) -> list[tuple[int, np.ndarray]]:
        """Advance every slot ``steps_per_sync`` tokens (one host sync) and
        return the finished (request_id, codes)."""
        if self._shared_col:
            return self._step_shared()
        return self._step_scatter()

    def _step_scatter(self) -> list[tuple[int, np.ndarray]]:
        """Per-row scatter engine: each row writes its KV at its own
        position, in the page pool or the dense window."""
        t_host0 = time.perf_counter()
        self._fill_slots()
        if not self.active.any():
            return []
        active_rows = np.repeat(self.active, self.lanes)
        max_pos = int(self.positions[active_rows].max())
        k = self.steps_per_sync
        if self.paged:
            self._allocate_pages()
            # length-aware reads: slice the page table to the pages the
            # furthest-along slot can touch this sync, in 64-position buckets
            need = (max_pos + k - 1) // self.page_size + 1
            r = max(1, 64 // self.page_size)
            p_cap = min(self.pages_per_slot, -(-need // r) * r)
        chunk = k if self.paged else self.sync_chunk
        t_dev0 = time.perf_counter()
        if self.paged:
            cache = self.cache._replace(page_table=self._upload(self._page_table[:, :p_cap]))
        tokens = self._upload(self.tokens)
        positions = self._upload(self.positions)
        toks_dev = []
        done = 0
        while done < k:
            kk = min(chunk, k - done)
            if not self.paged:
                # rows needed by the end of this chunk: every row advances
                # one position per step, so the regrow needs no readback
                self._resize_window(min(64 * -(-(max_pos + done + kk) // 64), self._needed))
                cache = self.cache
            for _ in range(kk):
                logits, cache = self.transformer(tokens[:, None], cache, slot_positions=positions)
                tokens = self._sample(logits[:, -1])
                positions = positions + 1
                toks_dev.append(tokens)
            if not self.paged:
                self.cache = cache
            done += kk
        toks = torch.stack(toks_dev).cpu().numpy()  # (k, B): the sync's one readback
        self.tokens = toks[-1].copy()
        self.positions = self.positions + k
        t_dev1 = time.perf_counter()

        n_active = int(self.active.sum()) * self.lanes
        self.stats["syncs"] += 1
        self.stats["row_steps_active"] += n_active * k
        self.stats["row_steps_idle"] += (self.batch_slots - n_active) * k
        self.stats["device_s"] += t_dev1 - t_dev0

        finished: list[tuple[int, np.ndarray]] = []
        for i, slot in enumerate(self.slots):
            rows = slice(i * self.lanes, (i + 1) * self.lanes)
            if not self.active[i]:
                # idle rows decoded garbage; reset their mirrors
                self.tokens[rows] = 0
                self.positions[rows] = 0
                self._free_slot_pages(i)
                continue
            row = i * self.lanes + (self.lanes - 1)  # cond lane
            for s in range(k):
                if len(slot.tokens) >= self.image_tokens:
                    break  # overshoot tokens: discard
                slot.tokens.append(int(toks[s, row]))
                self.stats["tokens_delivered"] += 1
            if len(slot.tokens) >= self.image_tokens:
                codes = self.codebook.debias(
                    np.asarray(slot.tokens[: self.image_tokens], np.int32)
                )
                finished.append((slot.request_id, codes))
                self.active[i] = False
                self.slots[i] = _Slot()
                self.tokens[rows] = 0
                self.positions[rows] = 0
                self._free_slot_pages(i)
        self.stats["host_s"] += (time.perf_counter() - t_host0) - (t_dev1 - t_dev0)
        return finished

    # -- shared-column engine ------------------------------------------------

    def _decode_sc(self, w_out: int, shift: int, reset_mask: np.ndarray,
                   reset_tokens: np.ndarray, steps: int) -> torch.Tensor:
        """One chunk of the shared-column engine: apply the pending
        admissions (``reset_mask``/``reset_tokens``), shift the cache left by
        ``shift`` columns and re-window it to ``w_out`` (columns past the old
        window read as zeros), then ``steps`` decode steps, every row
        writing at the shared column ``self.col + step`` and reading from
        its own start. Returns the chunk's tokens (steps, B) on the device;
        nothing waits for the device."""
        # the JAX engine pads one 64-column block before its clamped
        # dynamic slice; here the shifted window must fit that padding
        if shift + w_out > max(w_out, self.cache.window) + 64:
            raise AssertionError((shift, w_out, self.cache.window))
        tokens = self._tokens_dev
        if reset_mask.any():
            tokens = torch.where(self._upload(reset_mask), self._upload(reset_tokens), tokens)
        cache = self.cache.map(lambda a: resize_rows(a, w_out, shift))
        cache = cache._replace(length=self.col)
        starts = self._upload(self.starts)
        toks = []
        for _ in range(steps):
            logits, cache = self.transformer(tokens[:, None], cache, row_starts=starts)
            tokens = self._sample(logits[:, -1])
            toks.append(tokens)
        self.cache, self._tokens_dev = cache, tokens
        return torch.stack(toks)

    def _step_shared(self) -> list[tuple[int, np.ndarray]]:
        """One host sync of the shared-column engine: slot turnover is
        scheduled at chunk boundaries (completions and admissions are
        deterministic in step counts), every row decodes through the
        scalar-offset cache form, and the PREVIOUS sync's tokens are read
        back only after this sync's steps are queued, so host bookkeeping
        overlaps device decode (results lag one ``step()`` call)."""
        t_host0 = time.perf_counter()
        dev_s = 0.0
        if self._tokens_dev is None:
            self._tokens_dev = self._upload(self.tokens)
        k = self.steps_per_sync
        chunk = self.sync_chunk
        self._sc_boundary()
        pending = None
        if self.active.any():
            self._sc_compact()
            col0 = self.col
            # occupancy timeline per request slot for this sync
            occupants: list[list[_Slot]] = [
                [self.slots[i]] if self.active[i] else []
                for i in range(self.num_requests_slots)
            ]
            t_dev0 = time.perf_counter()
            toks_parts = []
            done = 0
            while done < k:
                kk = min(chunk, k - done)
                if done:
                    for i in self._sc_boundary():
                        occupants[i].append(self.slots[i])
                w_out = 64 * -(-(self.col + kk) // 64)
                if w_out > self._sc_cap:
                    raise AssertionError((w_out, self._sc_cap))
                mask, new_toks = self._reset_mask, self._reset_tokens
                self._reset_mask = np.zeros(self.batch_slots, bool)
                self._reset_tokens = np.zeros(self.batch_slots, np.int32)
                shift, self._pending_shift = self._pending_shift, 0
                toks_parts.append(self._decode_sc(w_out, shift, mask, new_toks, kk))
                self.col += kk
                done += kk
            dev_s += time.perf_counter() - t_dev0
            # extraction descriptors, computed now (no compaction happens
            # mid-sync, so step indices are stable; slot.start_col may shift
            # before the delayed extraction)
            descs: list[tuple[_Slot, int, int, int]] = []
            active_steps = 0
            for i, occ in enumerate(occupants):
                row = i * self.lanes + (self.lanes - 1)  # cond lane
                for slot in occ:
                    s = slot.start_col
                    lo = max(s - col0, 0)  # first step occupied
                    hi = min(slot.end_col - col0, k) if slot.end_col is not None else k
                    active_steps += (hi - lo) * self.lanes
                    # image token #(c - s + 1) is sampled at column c:
                    # productive columns are s .. s + image_tokens - 1
                    j1 = min(s + self.image_tokens - col0, hi)
                    if j1 > lo:
                        descs.append((slot, row, lo, j1))
                        self.stats["tokens_delivered"] += j1 - lo
            self.stats["syncs"] += 1
            self.stats["row_steps_active"] += active_steps
            self.stats["row_steps_idle"] += k * self.batch_slots - active_steps
            pending = (toks_parts, descs)
        prev, self._sc_pending = self._sc_pending, pending
        if prev is not None:
            dev_s += self._sc_extract(prev)
        finished = self._sc_emit_finished()
        self.stats["device_s"] += dev_s
        self.stats["host_s"] += (time.perf_counter() - t_host0) - dev_s
        return finished

    def _sc_extract(self, prev) -> float:
        """Read back a dispatched sync's tokens and append them to their
        streams; returns the seconds spent waiting on the device."""
        toks_parts, descs = prev
        t0 = time.perf_counter()
        toks = torch.cat(toks_parts).cpu().numpy()  # (k, B)
        dt = time.perf_counter() - t0
        for slot, row, lo, j1 in descs:
            slot.tokens.extend(toks[lo:j1, row].tolist())
        return dt

    def _sc_boundary(self) -> list[int]:
        """Slot turnover at the current column: completions free their
        slots, queued requests are admitted, and freed lanes are re-anchored
        at the current column so stale starts never widen attention masks
        or block compaction. Host bookkeeping only: the token resets ride
        the next chunk. Returns the slot indices with NEW occupants."""
        col = self.col
        newly: list[int] = []
        for i in range(self.num_requests_slots):
            slot = self.slots[i]
            rows = slice(i * self.lanes, (i + 1) * self.lanes)
            if self.active[i] and col >= slot.start_col + self.image_tokens:
                slot.end_col = col
                self._finished_slots.append(slot)
                self.active[i] = False
                self.slots[i] = _Slot(start_col=col)
                self._reset_mask[rows] = True
                self._reset_tokens[rows] = 0
                self.starts[rows] = col
            if not self.active[i] and self.queue:
                rid, category = self.queue.popleft()
                self.slots[i] = _Slot(request_id=rid, category=category, start_col=col)
                self.active[i] = True
                newly.append(i)
                self._reset_mask[rows] = True
                self.starts[rows] = col
                base = i * self.lanes
                if self.lanes == 2:
                    self._reset_tokens[base] = self.uncond_token
                    self._reset_tokens[base + 1] = category
                else:
                    self._reset_tokens[base] = category
        return newly

    def _sc_emit_finished(self) -> list[tuple[int, np.ndarray]]:
        out: list[tuple[int, np.ndarray]] = []
        rest: list[_Slot] = []
        for slot in self._finished_slots:
            if len(slot.tokens) >= self.image_tokens:
                codes = self.codebook.debias(
                    np.asarray(slot.tokens[: self.image_tokens], np.int32)
                )
                out.append((slot.request_id, codes))
            else:  # completion known, tail tokens not yet read back
                rest.append(slot)
        self._finished_slots = rest
        return out

    def _sc_compact(self) -> None:
        """Shift the column space left past columns no live stream can read
        (in 64-column steps), bounding it. Host bookkeeping only: the cache
        shift rides the next chunk (``_pending_shift``)."""
        active_rows = np.repeat(self.active, self.lanes)
        m = int(self.starts[active_rows].min()) if active_rows.any() else self.col
        shift = 64 * (m // 64)
        if shift <= 0:
            return
        self._pending_shift += shift
        self.col -= shift
        # idle rows may be anchored before the shift point (they re-anchor
        # only at their own boundaries): clamp at 0, which only widens an
        # idle lane's mask
        self.starts = np.maximum(self.starts - shift, 0)
        # host bookkeeping lives in the same column space
        for slot in self.slots:
            slot.start_col = max(slot.start_col - shift, 0)
        for slot in self._finished_slots:
            slot.start_col -= shift
            if slot.end_col is not None:
                slot.end_col -= shift

    def efficiency_report(self) -> dict:
        """Decode-step waste breakdown: fractions of all row-steps that were
        idle lanes, overshoot past ``image_tokens``, or useful (CFG pairs:
        the uncond lane counts as useful)."""
        s = self.stats
        total = s["row_steps_active"] + s["row_steps_idle"]
        if total == 0:
            return dict(s)
        useful = s["tokens_delivered"] * self.lanes
        overshoot = s["row_steps_active"] - useful
        wall = s["device_s"] + s["host_s"]
        return {
            **{key: round(val, 4) for key, val in s.items()},
            "idle_lane_frac": round(s["row_steps_idle"] / total, 4),
            "overshoot_frac": round(overshoot / total, 4),
            "useful_frac": round(useful / total, 4),
            "host_frac": round(s["host_s"] / wall, 4) if wall else None,
        }

    def run_until_drained(self, max_steps: int | None = None):
        out = []
        steps = 0
        while self.pending:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    # -- internals -----------------------------------------------------------

    def _resize_window(self, w: int) -> None:
        """Grow (zero columns) or shrink the dense window to ``w`` columns."""
        if w != self.cache.window:
            self.cache = self.cache.map(lambda a: resize_rows(a, w))

    def _allocate_pages(self) -> None:
        """Grow each active row's page list to cover this sync's writes.
        Admission control reserves a full request's pages up front, so lazy
        growth never starves."""
        k = self.steps_per_sync
        for row in range(self.batch_slots):
            if not self.active[row // self.lanes]:
                continue
            need = (int(self.positions[row]) + k - 1) // self.page_size + 1
            pages = self._row_pages[row]
            while len(pages) < min(need, self.pages_per_slot):
                pid = self._free_pages.pop()
                self._page_table[row, len(pages)] = pid
                pages.append(pid)

    def _free_slot_pages(self, slot_idx: int) -> None:
        if not self.paged:
            return
        freed = False
        for row in range(slot_idx * self.lanes, (slot_idx + 1) * self.lanes):
            pages = self._row_pages[row]
            if pages:
                self._free_pages.extend(pages)
                self._row_pages[row] = []
                self._page_table[row, :] = 0
                freed = True
        if freed:
            self._pages_reserved -= self.lanes * self.pages_per_slot

    def _fill_slots(self) -> None:
        for i in range(self.num_requests_slots):
            if self.active[i] or not self.queue:
                continue
            if self.paged:
                request_pages = self.lanes * self.pages_per_slot
                if self._pages_reserved + request_pages > self._total_pages:
                    continue  # wait for pages to free up
                self._pages_reserved += request_pages
            rid, category = self.queue.popleft()
            self.slots[i] = _Slot(request_id=rid, category=category)
            self.active[i] = True
            # prefill: condition tokens enter at position 0 on this sync
            base = i * self.lanes
            if self.lanes == 2:
                self.tokens[base] = self.uncond_token
                self.tokens[base + 1] = category
                self.positions[base : base + 2] = 0
            else:
                self.tokens[base] = category
                self.positions[base] = 0
