"""Paged KV cache (counterpart of mfa_tpu/cache/paged_cache.py).

Two device states, as in the JAX package: the serving engine's
StackedKVCache, all layers with ONE block table and lengths vector, and
PagedKVCache, one layer's cache for callers that keep it themselves
(create_cache -> write_prompt -> append_token -> kernels/paged.py:
paged_attention). Page allocation is host-side bookkeeping
(PageAllocator). Unlike the JAX package, whose arrays are immutable, the
functions here update the cache's tensors IN PLACE (index_put_ / slice
assignment) and return the same cache object, so the serving loop never
copies a pool. map_page(s), release_slot(s) and shard_cache take either
form.

Pages are [num_kv_heads, num_pages, page_size, w]; a StackedKVCache's are
[num_kv_heads, n_layers * num_pages, page_size, w], where layer l's
logical page p is physical page l * num_pages + p (the merged pool of the
JAX package). A row holds the head-dim plan's stored width
(dispatch/config.py:head_dim_plan: head_dim, widened with zero features
only where the row's bytes would not be a multiple of 16, which a TMA map
needs): w features (16-bit, int8, fp8 as float8_e4m3fn) or w / 2 bytes
(int4, feature pairs: kernels/quant.py:pack_int4). The JAX package pads
every row to 128 lanes instead (its TPU DMA's rule), so at head_dim 80 its
rows are 128 wide where these are 80 (int4: 48 bytes). Quantized pages
carry fp32 per-row scales [num_kv_heads, pool pages, page_size],
taken over the true features. Rows of every format are written whole (no
nibble blend), so any set of positions takes one scatter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from mfa_tpu_torch.dispatch.config import (head_dim_plan, host_to_device,
                                           pad_features, resolve_device)
from mfa_tpu_torch.kernels.quant import (FP8, as_bytes, pack_int4,
                                         quantize_rows, row_width,
                                         storage_dtype)


@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged KV state (mfa_tpu's PagedKVCache)."""

    k_pages: torch.Tensor  # [hkv, num_pages, page, w]
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]  # [hkv, num_pages, page] fp32
    v_scales: Optional[torch.Tensor]
    block_tables: torch.Tensor  # [max_seqs, pages_per_seq] int32
    lengths: torch.Tensor  # [max_seqs] int32
    page_size: int
    quant_dtype: Optional[str]
    head_dim: int = 0  # the true head_dim; rows hold the plan's stored width

    @property
    def num_kv_heads(self) -> int:
        return self.k_pages.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_width(self) -> int:
        return self.k_pages.shape[-1]

    @property
    def max_seqs(self) -> int:
        return self.block_tables.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.block_tables.shape[1]


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
    head_dim: int = 0  # the true head_dim; rows hold the plan's stored width

    @property
    def n_layers(self) -> int:
        return self.layers

    @property
    def num_kv_heads(self) -> int:
        return self.k_pages.shape[0]

    @property
    def num_pages(self) -> int:
        """LOGICAL pages per layer (the host allocator's id space)."""
        return self.k_pages.shape[1] // self.layers

    @property
    def page_width(self) -> int:
        return self.k_pages.shape[-1]

    @property
    def max_seqs(self) -> int:
        return self.block_tables.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.block_tables.shape[1]


AnyKVCache = Union[PagedKVCache, StackedKVCache]


def _allocate(pool_pages: int, page_size: int, num_kv_heads: int,
              head_dim: int, max_seqs: int, pages_per_seq: int, dtype,
              quant_dtype: Optional[str], device) -> dict:
    """Zeroed pages of pool_pages pages, unit scales (quantized formats),
    an all-null block table and zero lengths: the tensors of either cache."""
    store = storage_dtype(quant_dtype) if quant_dtype else dtype
    shape = (num_kv_heads, pool_pages, page_size,
             row_width(quant_dtype, head_dim))

    def scales():
        return (torch.ones(shape[:3], dtype=torch.float32, device=device)
                if quant_dtype else None)

    return dict(
        k_pages=torch.zeros(shape, dtype=store, device=device),
        v_pages=torch.zeros(shape, dtype=store, device=device),
        k_scales=scales(),
        v_scales=scales(),
        block_tables=torch.zeros((max_seqs, pages_per_seq), dtype=torch.int32,
                                 device=device),
        lengths=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
        page_size=page_size,
        quant_dtype=quant_dtype,
    )


def create_cache(
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    max_seqs: int,
    pages_per_seq: int,
    dtype=torch.bfloat16,
    quant_dtype: Optional[str] = None,
    device="cuda",
) -> PagedKVCache:
    """One layer's cache, on the card unless `device` says otherwise. int4
    needs an even page_size, as mfa_tpu's token-pair rows do (the port's
    feature-pair rows would not, but this cache keeps mfa_tpu's contract)."""
    if quant_dtype == "int4" and page_size % 2:
        raise ValueError("int4 KV needs an even page_size (row pairing)")
    return PagedKVCache(
        **_allocate(num_pages, page_size, num_kv_heads, head_dim, max_seqs,
                    pages_per_seq, dtype, quant_dtype, resolve_device(device)),
        head_dim=head_dim)


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
    return StackedKVCache(
        **_allocate(n_layers * num_pages, page_size, num_kv_heads, head_dim,
                    max_seqs, pages_per_seq, dtype, quant_dtype, device),
        layers=n_layers, head_dim=head_dim)


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


def stored_rows(quant_dtype: Optional[str], kq: torch.Tensor) -> torch.Tensor:
    """quantize_rows payload rows [..., d] -> the rows as pages store them:
    zero-padded to the plan's stored width w, int4 packed to w / 2 bytes,
    fp8 as its uint8 bits (as_bytes). A zero byte is 0 in every format."""
    rows = as_bytes(kq)
    rows = pad_features(rows, head_dim_plan(kq.shape[-1], quant_dtype).stored)
    return pack_int4(rows) if quant_dtype == "int4" else rows


def pack_pages_payload(quant_dtype: Optional[str], kq: torch.Tensor,
                       n_pages: int, page: int) -> torch.Tensor:
    """Whole-page payload [hkv, n_pages * page, d] (or [hkv, n, s, d] with
    n * s == n_pages * page) -> the pages' stored shape [hkv, n_pages,
    page, w] (w = row_width: the stored features, or half of them in bytes
    for int4; fp8 as uint8 bits)."""
    rows = stored_rows(quant_dtype, kq)
    return rows.reshape(rows.shape[0], n_pages, page, rows.shape[-1])


def write_pages(pages: torch.Tensor, ids: torch.Tensor,
                payload: torch.Tensor) -> None:
    """IN PLACE: pages[:, ids] = payload (pack_pages_payload's output, or
    16-bit rows), through byte views for fp8."""
    as_bytes(pages)[:, ids] = as_bytes(payload).to(as_bytes(pages).dtype)


def scatter_span_rows(pages: torch.Tensor, page_ids: torch.Tensor,
                      offs: torch.Tensor, kq: torch.Tensor,
                      quant_dtype: Optional[str] = None) -> None:
    """IN PLACE: write per-token payload rows kq [hkv, n, d] at
    (page_ids[i], row offs[i]) of pages [hkv, P, page, w]."""
    rows = stored_rows(quant_dtype, kq)
    as_bytes(pages)[:, page_ids.long(), offs.long()] = rows.to(
        as_bytes(pages).dtype)


def payload_rows(quant_dtype: Optional[str], store_dtype, x,
                 reciprocal: bool = True):
    """-> (payload, per-row scales or None): the cache's storage dtype, or
    quantize_rows' payload (int4 values unpacked; the writes pack them).
    reciprocal: the scale rule of mfa_tpu's jitted writers (its engine's
    steps and append_token); write_prompt, eager there, passes False."""
    if quant_dtype is None:
        return x.to(store_dtype), None
    return quantize_rows(x, quant_dtype, reciprocal)


def write_prompt(cache: PagedKVCache, seq_slot: int, pages: Sequence[int],
                 k_prompt: torch.Tensor, v_prompt: torch.Tensor
                 ) -> PagedKVCache:
    """IN PLACE: a whole prompt's K/V [seqlen, hkv, d] into the pages the
    host allocated for slot seq_slot (at least ceil(seqlen / page_size) of
    them; all of them enter its table row), zero-padded to whole pages."""
    seqlen, page = k_prompt.shape[0], cache.page_size
    n_pages = -(-seqlen // page)
    if len(pages) < n_pages:
        raise ValueError(f"a prompt of {seqlen} tokens needs {n_pages} pages "
                         f"of {page}, got {len(pages)}")
    if len(pages) > cache.pages_per_seq:
        raise ValueError(f"{len(pages)} pages exceed the block table's "
                         f"{cache.pages_per_seq}")
    dev = cache.lengths.device
    ids = host_to_device(list(pages), torch.long, dev)
    pad = (0, 0, 0, 0, 0, n_pages * page - seqlen)
    for x, pool, scales in ((k_prompt, cache.k_pages, cache.k_scales),
                            (v_prompt, cache.v_pages, cache.v_scales)):
        xq, xs = payload_rows(cache.quant_dtype, pool.dtype,
                              torch.nn.functional.pad(x.to(dev), pad)
                              .transpose(0, 1), reciprocal=False)
        write_pages(pool, ids[:n_pages],
                    pack_pages_payload(cache.quant_dtype, xq, n_pages, page))
        if xs is not None:
            scales[:, ids[:n_pages]] = xs.reshape(xs.shape[0], n_pages, page)
    cache.block_tables[seq_slot] = 0
    cache.block_tables[seq_slot, : len(pages)] = ids.to(torch.int32)
    cache.lengths[seq_slot] = seqlen
    return cache


def append_token(cache: PagedKVCache, seq_slots, new_k: torch.Tensor,
                 new_v: torch.Tensor) -> PagedKVCache:
    """IN PLACE: one token's K/V [n, hkv, d] for each sequence of seq_slots
    at its length, which then grows by one. The page of each write position
    must already be mapped (map_page). No host wait."""
    dev = cache.lengths.device
    slots = (seq_slots.to(dev, torch.long) if isinstance(seq_slots, torch.Tensor)
             else host_to_device(seq_slots, torch.long, dev))
    lens = cache.lengths[slots].long()
    page_ids = cache.block_tables[slots, lens // cache.page_size].long()
    offs = lens % cache.page_size
    for x, pool, scales in ((new_k, cache.k_pages, cache.k_scales),
                            (new_v, cache.v_pages, cache.v_scales)):
        xq, xs = payload_rows(cache.quant_dtype, pool.dtype,
                              x.to(dev).transpose(0, 1))
        scatter_span_rows(pool, page_ids, offs, xq, cache.quant_dtype)
        if xs is not None:
            scales[:, page_ids, offs] = xs
    cache.lengths[slots] = (lens + 1).to(torch.int32)
    return cache


def map_page(cache: AnyKVCache, seq_slot: int, page_index: int,
             page_id: int) -> AnyKVCache:
    """IN PLACE: map one allocated page into a sequence's block table."""
    return map_pages(cache, [seq_slot], [page_index], [page_id])


def release_slot(cache: AnyKVCache, seq_slot: int) -> AnyKVCache:
    """IN PLACE: clear a finished sequence's table row and length (its
    pages are freed on the host)."""
    return release_slots(cache, [seq_slot])


def map_pages(cache: AnyKVCache, seq_slots, page_indices, page_ids
              ) -> AnyKVCache:
    """IN PLACE: map many pages into the block table in one scatter
    (enqueued behind the decode bursts in flight: no host wait)."""
    dev = cache.block_tables.device
    slots = host_to_device(seq_slots, torch.long, dev)
    idxs = host_to_device(page_indices, torch.long, dev)
    ids = host_to_device(page_ids, torch.int32, dev)
    cache.block_tables[slots, idxs] = ids
    return cache


def release_slots(cache: AnyKVCache, seq_slots) -> AnyKVCache:
    """IN PLACE: clear finished slots' table rows and lengths (pages are
    freed on the host) in one scatter pair, enqueued without a host wait."""
    idx = host_to_device(seq_slots, torch.long, cache.block_tables.device)
    cache.block_tables[idx] = 0
    cache.lengths[idx] = 0
    return cache


def shard_cache(cache: AnyKVCache, mesh, axis: str) -> AnyKVCache:
    """This rank's kv heads of a full cache, TP by kv head on `axis`
    (mfa_tpu's cache_shardings; raises ValueError when the axis does not
    divide the kv heads). Block tables and lengths are copied: every rank
    holds them whole."""
    from mfa_tpu_torch.shard.mesh import sharding, shard_tensor

    heads = sharding(mesh, axis)

    def cut(t):
        return None if t is None else shard_tensor(t, heads, "kv heads")

    return dataclasses.replace(
        cache, k_pages=cut(cache.k_pages), v_pages=cut(cache.v_pages),
        k_scales=cut(cache.k_scales), v_scales=cut(cache.v_scales),
        block_tables=cache.block_tables.clone(), lengths=cache.lengths.clone())


def _tensor_of(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor; ml_dtypes' bfloat16 and
    float8_e4m3fn (which torch.from_numpy refuses) through their bits."""
    a = np.array(a)  # a writable copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(FP8)
    return torch.from_numpy(a)


def _unpack_token_pairs(packed: torch.Tensor) -> torch.Tensor:
    """mfa_tpu's int4 rows [..., rows, w], byte (r, c) = token 2r's feature
    c (low nibble) | token 2r + 1's (high nibble) -> int8 values [...,
    2 * rows, w] in token order (its kernels/quant.py:unpack_int4_pairs)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-2).reshape(
        *packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def cache_from_numpy(tree, device="cuda") -> AnyKVCache:
    """mfa_tpu's PagedKVCache or StackedKVCache with numpy leaves
    (jax.tree.map(np.asarray, cache)) -> the port's, on `device`: rows
    padded to 128 lanes are cut to the true head_dim and stored at the
    plan's width, int4 token-pair rows repacked as feature pairs
    (kernels/quant.py:pack_int4); scales, tables and lengths as they are."""
    dev = resolve_device(device)
    fmt, page = tree.quant_dtype, tree.page_size
    d = tree.head_dim or np.asarray(tree.k_pages).shape[-1]

    def pages(a):
        t = _tensor_of(a)
        if fmt == "int4":
            t = _unpack_token_pairs(t)
        rows = stored_rows(fmt, t[..., :d].contiguous())
        return (rows.view(FP8) if fmt == "fp8" else rows).to(dev)

    def opt(a):
        return None if a is None else _tensor_of(a).to(dev)

    fields = dict(
        k_pages=pages(tree.k_pages), v_pages=pages(tree.v_pages),
        k_scales=opt(tree.k_scales), v_scales=opt(tree.v_scales),
        block_tables=_tensor_of(tree.block_tables).to(dev, torch.int32),
        lengths=_tensor_of(tree.lengths).to(dev, torch.int32),
        page_size=page, quant_dtype=fmt)
    if hasattr(tree, "layers"):
        return StackedKVCache(**fields, layers=tree.layers, head_dim=d)
    return PagedKVCache(**fields, head_dim=d)
