"""Continuous-batching scheduler (counterpart of mfa_tpu/serve/scheduler.py).

FIFO admission with page-budget control (a request is admitted only when
a sequence slot AND pages for its prompt plus one decode page are free),
per-step page mapping, preemption of the youngest request under page
pressure, slot/page recycling, and the optional prefix cache (shared prompt
pages). Host-side and deterministic. `admit_counts` is this package's own
copy of the Python admission rule of mfa_tpu/utils/native.py.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from mfa_tpu_torch.cache.paged_cache import PageAllocator


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    # finish when the generation ends with any of these token-id lists
    stop: Optional[List[List[int]]] = None
    # multimodal: [n_images, 3, H, W] pixels whose projected features fill
    # the prompt's <image> placeholder runs (Gemma3; the engine's vision=)
    images: Optional[object] = None
    # filled during execution
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    # prefix caching: tokens covered by shared pages (page-aligned), and
    # the cache keys this request holds references on
    cached_len: int = 0
    prefix_keys: List[int] = dataclasses.field(default_factory=list)
    # decode tokens dispatched in bursts whose results the host has not
    # read back yet (the engine's pipelined loop)
    inflight: int = 0

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


class PrefixCache:
    """Page-granular shared prompt prefixes: a hit aliases the pages of an
    earlier prompt through the block table, and nothing in the kernels
    changes (decode appends always land in pages the request owns).

    Keys are hash-chained per full prompt page, so a key identifies the
    WHOLE prefix up to that page. Entries hold a refcount; at zero they
    move to an idle LRU and their pages are reclaimed only under
    allocation pressure (evict())."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.pages: Dict[int, int] = {}  # key -> page_id
        self.tokens: Dict[int, tuple] = {}  # key -> this page's token tuple
        self.refs: Dict[int, int] = {}  # key -> refcount
        self.idle: "OrderedDict[int, None]" = OrderedDict()  # LRU, refs==0

    def _keys(self, prompt: Sequence[int]):
        # cap at (len-1)//page so at least one prompt token is always
        # prefilled (the engine needs last-token logits)
        n = max(0, (len(prompt) - 1) // self.page_size)
        h = 0
        for i in range(n):
            page_toks = tuple(prompt[i * self.page_size:(i + 1) * self.page_size])
            h = hash((h, page_toks))
            yield h, page_toks

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Longest cached prefix -> (keys, page_ids), acquiring a reference
        on every returned key. A hash hit is confirmed against the stored
        tokens: a collision would alias another prompt's KV."""
        keys, page_ids = [], []
        for h, page_toks in self._keys(prompt):
            if h not in self.pages or self.tokens[h] != page_toks:
                break
            keys.append(h)
            page_ids.append(self.pages[h])
        for k in keys:
            self.refs[k] += 1
            self.idle.pop(k, None)
        return keys, page_ids

    def register(self, req: Request) -> None:
        """Called when a request's prefill COMPLETES (its pages are fully
        written only then; registering earlier would let a concurrent
        request alias half-written pages): make its full prompt pages
        shareable. The request keeps a reference on each key it holds;
        finish() releases them."""
        n_matched = len(req.prefix_keys)
        for i, (h, page_toks) in enumerate(self._keys(req.prompt)):
            if i < n_matched:
                continue
            if h not in self.pages:
                self.pages[h] = req.pages[i]
                self.tokens[h] = page_toks
                self.refs[h] = 0
            self.refs[h] += 1
            self.idle.pop(h, None)
            req.prefix_keys.append(h)

    def release(self, keys: Sequence[int]) -> None:
        # Idle entries go in REVERSE chain order, so oldest-first eviction
        # reclaims a chain from its tail and the surviving prefix stays
        # matchable.
        for k in reversed(list(keys)):
            self.refs[k] -= 1
            if self.refs[k] == 0:
                self.idle[k] = None

    def shared_page_ids(self) -> set:
        return set(self.pages.values())

    def evict(self, n_pages: int, allocator) -> int:
        """Free up to n_pages pages from idle (LRU-first) entries."""
        freed = 0
        while freed < n_pages and self.idle:
            k, _ = self.idle.popitem(last=False)
            allocator.free([self.pages.pop(k)])
            del self.refs[k]
            del self.tokens[k]
            freed += 1
        return freed


class Scheduler:
    """Admission + page bookkeeping for one model replica."""

    def __init__(self, max_seqs: int, pages_per_seq: int, page_size: int,
                 num_pages: int, prefix_cache: bool = False):
        self.max_seqs = max_seqs
        self.pages_per_seq = pages_per_seq
        self.page_size = page_size
        self.allocator = PageAllocator(num_pages)
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self.prefix = PrefixCache(page_size) if prefix_cache else None

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
        if self.prefix is not None:
            return self._admit_prefix()
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

    def _admit_prefix(self) -> List[Request]:
        """Prefix-aware FIFO admission: a request needs pages only for the
        part of its prompt past its cached prefix; idle shared pages are
        evicted under pressure."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            # image prompts never share prefix pages: equal token ids do not
            # mean equal KV (the placeholders' KV depends on the pixels)
            keys, shared = (([], []) if req.images is not None
                            else self.prefix.match(req.prompt))
            cached_len = len(shared) * self.page_size
            need = max(1, -(-(req.total_len - cached_len) // self.page_size))
            if self.allocator.free_pages < need + 1:
                self.prefix.evict(need + 1 - self.allocator.free_pages,
                                  self.allocator)
            if self.allocator.free_pages < need + 1:
                self.prefix.release(keys)
                break
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.cached_len = cached_len
            req.prefix_keys = list(keys)
            req.pages = shared + self.allocator.alloc(need)
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
        if self.prefix is not None:
            # shared pages stay with the prefix cache
            shared = self.prefix.shared_page_ids()
            self.prefix.release(req.prefix_keys)
            req.prefix_keys = []
            req.cached_len = 0
            self.allocator.free([p for p in req.pages if p not in shared])
        else:
            self.allocator.free(req.pages)
        req.pages = []
        self.active.pop(req.slot, None)
        self._free_slots.append(req.slot)
        req.slot = -1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)
