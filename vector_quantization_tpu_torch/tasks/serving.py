"""Continuous-batching AR serving engine over a paged KV pool (port of
``vector_quantization_tpu/tasks/serving.py`` with ``paged=True``).

A slot-based decode loop: new requests prefill (class token at position 0)
in the same step in which other slots are mid-image.

- **CFG serving**: each request occupies a PAIR of adjacent rows (even =
  unconditional token, odd = class token); the step mixes the pair's
  logits ``(1-alpha)*u + alpha*c``, samples once and feeds the same token to
  both lanes.
- **Multi-step decode between host syncs** (``steps_per_sync``): each sync
  runs that many decode steps as a Python loop of device work and reads the
  sampled tokens back once.
- **Paged pool**: page 0 is a scratch page that idle rows write into; each
  active row's pages are allocated as its positions grow, and a request is
  admitted only when the pool can hold all of its pages.

The dense shared-column engine (``paged=False``) and tensor-parallel
serving (``strategy=``) are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from ..models.transformers.sampling import sample_tokens
from .sequence_modeling import TokenCodebook

__all__ = ["ARServer"]


@dataclasses.dataclass
class _Slot:
    request_id: int | None = None
    category: int = 0
    tokens: list[int] = dataclasses.field(default_factory=list)


class ARServer:
    """Class-conditional image-token server.

    >>> server = ARServer(transformer, state_dict, codebook, image_tokens=256, paged=True)
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
        paged: bool = False,
        page_size: int = 64,
        num_pages: int | None = None,
        strategy: Any | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        if not paged:
            raise NotImplementedError(
                "paged=False (the dense shared-column engine): ROADMAP.md "
                "queue A, the dense shared-column engine and generate()"
            )
        if strategy is not None:
            raise NotImplementedError(
                "strategy= (tensor-parallel serving): ROADMAP.md queue A #10, parallelism"
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
        # overshoot room: a slot finishing mid-sync keeps decoding until the
        # next host sync (class token + image tokens + (k-1) overshoot)
        needed = 1 + image_tokens + steps_per_sync - 1
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
        self.lanes = 2 if cfg_alpha is not None else 1
        self.num_requests_slots = batch_slots // self.lanes
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.queue: deque[tuple[int, int]] = deque()  # (request_id, category)
        self.slots = [_Slot() for _ in range(self.num_requests_slots)]
        self._next_id = 0

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

        # host mirrors: current token + position per BATCH ROW (inactive
        # rows idle at position 0 with token 0)
        self.tokens = np.zeros(batch_slots, np.int32)
        self.positions = np.zeros(batch_slots, np.int32)
        self.active = np.zeros(self.num_requests_slots, bool)

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
        return len(self.queue) + int(self.active.sum())

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
        return the finished (request_id, codes). Each row writes its KV at
        its own position in the page pool."""
        t_host0 = time.perf_counter()
        self._fill_slots()
        if not self.active.any():
            return []
        self._allocate_pages()
        # length-aware reads: slice the page table to the pages the
        # furthest-along slot can touch this sync, in 64-position buckets
        active_rows = np.repeat(self.active, self.lanes)
        max_pos = int(self.positions[active_rows].max())
        k = self.steps_per_sync
        need = (max_pos + k - 1) // self.page_size + 1
        r = max(1, 64 // self.page_size)
        p_cap = min(self.pages_per_slot, -(-need // r) * r)
        t_dev0 = time.perf_counter()
        cache = self.cache._replace(
            page_table=torch.from_numpy(self._page_table[:, :p_cap].copy()).to(self.device)
        )
        tokens = torch.from_numpy(self.tokens).to(self.device)
        positions = torch.from_numpy(self.positions).to(self.device)
        toks_dev = []
        for _ in range(k):
            logits, cache = self.transformer(tokens[:, None], cache, slot_positions=positions)
            tokens = self._sample(logits[:, -1])
            positions = positions + 1
            toks_dev.append(tokens)
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
