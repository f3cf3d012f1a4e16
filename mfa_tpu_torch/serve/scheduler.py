"""Continuous-batching scheduler (counterpart of mfa_tpu/serve/scheduler.py).

FIFO admission with page-budget control (a request is admitted only when
a sequence slot AND pages for its prompt plus one decode page are free),
per-step page mapping, preemption of the youngest request under page
pressure, slot/page recycling. Host-side and deterministic. The prefix
cache is not ported yet. `admit_counts` is this package's own copy of the
Python admission rule of mfa_tpu/utils/native.py.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from mfa_tpu_torch.cache.paged_cache import PageAllocator


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    # finish when the generation ends with any of these token-id lists
    stop: Optional[List[List[int]]] = None
    # filled during execution
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        if (self.generated and self.eos_token is not None
                and self.generated[-1] == self.eos_token):
            return True
        if self.stop:
            g = self.generated
            for seq in self.stop:
                if seq and len(g) >= len(seq) and g[-len(seq):] == list(seq):
                    return True
        return False

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)


def admit_counts(prompt_lens: Sequence[int], free_slots: int,
                 free_pages: int, page_size: int):
    """-> (n_admitted, pages_needed list): admit in FIFO order while a slot
    is free and the pages of the prompt plus one decode page fit."""
    admitted, budget = 0, free_pages
    needed = []
    for ln in prompt_lens:
        np_pages = max(1, -(-int(ln) // page_size))
        if admitted >= free_slots or budget < np_pages + 1:
            break
        needed.append(np_pages)
        budget -= np_pages
        admitted += 1
    return admitted, needed


class Scheduler:
    """Admission + page bookkeeping for one model replica."""

    def __init__(self, max_seqs: int, pages_per_seq: int, page_size: int,
                 num_pages: int):
        self.max_seqs = max_seqs
        self.pages_per_seq = pages_per_seq
        self.page_size = page_size
        self.allocator = PageAllocator(num_pages)
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self._free_slots = list(range(max_seqs - 1, -1, -1))

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.pages_per_seq * self.page_size:
            raise ValueError(
                f"request {req.uid} longer than pages_per_seq*page_size")
        self.waiting.append(req)

    def admit(self) -> List[Request]:
        """Admit waiting requests while slots + prompt pages are available.
        Returns the newly admitted requests (the caller prefills them)."""
        if not self.waiting or not self._free_slots:
            return []
        # total_len covers resumed requests (prompt + tokens generated
        # before a preemption's re-prefill)
        _, pages_needed = admit_counts(
            [r.total_len for r in self.waiting], len(self._free_slots),
            self.allocator.free_pages, self.page_size)
        admitted = []
        for n_pages in pages_needed:
            req = self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.pages = self.allocator.alloc(n_pages)
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def ensure_decode_pages(self, req: Request, n: int):
        """Map enough pages for the next n decode positions. Returns
        [(page_index, page_id), ...] for newly mapped pages. All-or-nothing:
        a MemoryError leaves the request unchanged."""
        last_pos = req.total_len + n - 1
        need = min(last_pos // self.page_size + 1, self.pages_per_seq)
        missing = need - len(req.pages)
        if missing <= 0:
            return []
        new_pages = self.allocator.alloc(missing)
        base = len(req.pages)
        req.pages.extend(new_pages)
        return [(base + i, p) for i, p in enumerate(new_pages)]

    def preempt(self, req: Request) -> None:
        """Evict an ACTIVE request under page pressure: free its pages and
        slot and requeue it at the FRONT of the waiting queue; it resumes by
        re-prefilling prompt + all but the newest generated token."""
        self.finish(req)
        self.waiting.appendleft(req)

    def finish(self, req: Request) -> None:
        self.allocator.free(req.pages)
        req.pages = []
        self.active.pop(req.slot, None)
        self._free_slots.append(req.slot)
        req.slot = -1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)
