"""Paged KV cache (counterpart of mfa_tpu/cache/paged_cache.py).

Device state is one StackedKVCache for all layers with ONE block table and
lengths vector; page allocation is host-side bookkeeping (PageAllocator).
Unlike the JAX package, whose arrays are immutable, the functions here
update the cache's tensors IN PLACE (index_put_ / slice assignment) and
return the same cache object, so the serving loop never copies a pool.

Pages are [num_kv_heads, n_layers * num_pages, page_size, head_dim]:
layer l's logical page p is physical page l * num_pages + p (the merged
pool of the JAX package). Rows are head_dim wide; int8 pages carry fp32
per-row scales [num_kv_heads, n_layers * num_pages, page_size].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from mfa_tpu_torch.dispatch.config import host_to_device
from mfa_tpu_torch.kernels.quant import storage_dtype


@dataclasses.dataclass
class StackedKVCache:
    """All layers' paged KV state, metadata shared across layers."""

    k_pages: torch.Tensor  # [hkv, layers * num_pages, page, d]
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]  # [hkv, layers * num_pages, page] fp32
    v_scales: Optional[torch.Tensor]
    block_tables: torch.Tensor  # [max_seqs, pages_per_seq] int32
    lengths: torch.Tensor  # [max_seqs] int32
    page_size: int
    quant_dtype: Optional[str]
    layers: int = 1

    @property
    def num_pages(self) -> int:
        """LOGICAL pages per layer (the host allocator's id space)."""
        return self.k_pages.shape[1] // self.layers

    @property
    def pages_per_seq(self) -> int:
        return self.block_tables.shape[1]


def create_stacked_cache(
    n_layers: int,
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    max_seqs: int,
    pages_per_seq: int,
    dtype=torch.bfloat16,
    quant_dtype: Optional[str] = None,
    device="cuda",
) -> StackedKVCache:
    store = storage_dtype(quant_dtype) if quant_dtype else dtype
    shape = (num_kv_heads, n_layers * num_pages, page_size, head_dim)

    def scales():
        return (torch.ones(shape[:3], dtype=torch.float32, device=device)
                if quant_dtype else None)

    return StackedKVCache(
        k_pages=torch.zeros(shape, dtype=store, device=device),
        v_pages=torch.zeros(shape, dtype=store, device=device),
        k_scales=scales(),
        v_scales=scales(),
        block_tables=torch.zeros((max_seqs, pages_per_seq), dtype=torch.int32,
                                 device=device),
        lengths=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
        page_size=page_size,
        quant_dtype=quant_dtype,
        layers=n_layers,
    )


class PageAllocator:
    """Host-side free-list page allocator (page 0 is reserved as the null
    page so uninitialized block-table entries stay in bounds)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV cache out of pages: need {n}, have {len(self._free)}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p != 0:
                self._free.append(int(p))


def pack_pages_payload(kq: torch.Tensor, n_pages: int, page: int
                       ) -> torch.Tensor:
    """Whole-page payload [hkv, n_pages * page, d] (or [hkv, n, s, d] with
    n * s == n_pages * page) -> the pages' stored shape [hkv, n_pages,
    page, d]."""
    return kq.reshape(kq.shape[0], n_pages, page, kq.shape[-1])


def scatter_span_rows(pages: torch.Tensor, page_ids: torch.Tensor,
                      offs: torch.Tensor, kq: torch.Tensor) -> None:
    """IN PLACE: write per-token rows kq [hkv, n, d] at (page_ids[i], row
    offs[i]) of pages [hkv, P, page, d]."""
    pages[:, page_ids.long(), offs.long()] = kq.to(pages.dtype)


def map_pages(cache: StackedKVCache, seq_slots, page_indices, page_ids
              ) -> StackedKVCache:
    """IN PLACE: map many pages into the block table in one scatter
    (enqueued behind the decode bursts in flight: no host wait)."""
    dev = cache.block_tables.device
    slots = host_to_device(seq_slots, torch.long, dev)
    idxs = host_to_device(page_indices, torch.long, dev)
    ids = host_to_device(page_ids, torch.int32, dev)
    cache.block_tables[slots, idxs] = ids
    return cache


def release_slots(cache: StackedKVCache, seq_slots) -> StackedKVCache:
    """IN PLACE: clear finished slots' table rows and lengths (pages are
    freed on the host) in one scatter pair, enqueued without a host wait."""
    idx = host_to_device(seq_slots, torch.long, cache.block_tables.device)
    cache.block_tables[idx] = 0
    cache.lengths[idx] = 0
    return cache
