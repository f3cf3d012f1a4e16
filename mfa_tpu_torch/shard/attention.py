"""Sharded attention: TP over heads, DP over batch, CP over KV length
(counterpart of mfa_tpu/shard/attention.py).

Each wrapper returns a function that every rank of the mesh calls on its
own shard (SPMD; mfa_tpu's shard_map specs say which): it runs the port's
kernel on the local shard and makes the collectives explicitly.

- sharded_flash_attn: prefill with heads on "model" and batch on "data".
  GQA keeps each q-head group with its kv head, so attention needs no
  communication.
- sharded_paged_decode: decode over the paged KV cache sharded by kv head
  on "model" and requests on "data"; no communication either.
- context_parallel_decode / context_parallel_paged_decode: KV length on
  "ctx". Each rank runs the split-KV decode (kernel 5) or the paged decode
  (kernel 6) on its KV with return_lse, and the partials merge with the
  max-normalized LSE combine (pmax / psum): the in-card split combine
  lifted across ranks. Traffic is O(heads * head_dim) per sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from mfa_tpu_torch.shard.mesh import CTX_AXIS, axis_index, pmax, psum


def cross_chip_lse_combine(o: torch.Tensor, lse: torch.Tensor, mesh,
                           axis: str) -> torch.Tensor:
    """Max-normalized merge of per-rank partials (o fp32 [..., d], lse
    fp32 [...]) over the mesh axis. Rows no rank saw a column of come out
    zero; a rank's empty partial gets weight 0, not NaN."""
    m = pmax(lse, mesh, axis)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    denom = psum(w, mesh, axis)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return psum(o * w[..., None], mesh, axis) / denom[..., None]


def sharded_flash_attn(mesh, causal: bool = False,
                       softmax_scale: Optional[float] = None,
                       window_size: tuple = (-1, -1)):
    """-> f(q, k, v) on the rank's block of the [batch, seq, heads,
    head_dim] layout: batch rows of "data", heads of "model", whose size
    must divide n_kv_heads (whole GQA groups on a rank). The kernel is
    flash_attn_func's (prefill engines 1-4). mesh is mfa_tpu's first
    argument, kept for its call form: the rank's block needs no
    collective, so f reads nothing of it."""
    from mfa_tpu_torch.interface import flash_attn_func

    def fn(q, k, v):
        return flash_attn_func(q, k, v, causal=causal,
                               softmax_scale=softmax_scale,
                               window_size=window_size)

    return fn


def sharded_paged_decode(mesh, softmax_scale: Optional[float] = None,
                         quantized=False):
    """-> f(q, k_pages, v_pages, lengths, block_table[, k_scales,
    v_scales]) on the rank's block: q [batch, heads, d] (batch on "data",
    heads on "model"), k/v_pages [hkv, pages, page, d] and scales [hkv,
    pages, page] (kv heads on "model"), lengths [batch] and block_table
    [batch, pages_per_seq] (batch on "data"). quantized: False, True (int8
    / fp8 pages, from their dtype) or "int4"; scales are then required.
    Kernel 6; no communication, so, as in sharded_flash_attn, mesh is
    kept for mfa_tpu's call form only."""
    from mfa_tpu_torch.kernels.paged import paged_attention

    qd = quantized if isinstance(quantized, str) else None

    def fn(q, k_pages, v_pages, lengths, block_table, k_scales=None,
           v_scales=None):
        if bool(quantized) != (k_scales is not None):
            raise ValueError("quantized pages need k_scales and v_scales, "
                             "bf16 pages take none")
        return paged_attention(q, k_pages, v_pages, lengths, block_table,
                               k_scales=k_scales, v_scales=v_scales,
                               softmax_scale=softmax_scale, quant_dtype=qd)

    return fn


def context_parallel_decode(mesh, softmax_scale: Optional[float] = None,
                            num_splits: int = 0, ctx_axis: str = CTX_AXIS):
    """-> f(q, k_shard, v_shard, lengths): q [batch, heads, d] (the same on
    every rank), k/v_shard [batch, hkv, max_seq / n, d] the rank's block of
    the cache along max_seq, lengths [batch] the GLOBAL lengths. Each rank
    runs kernel 5 on its visible part with return_lse; the partials merge
    across ctx_axis. Returns [batch, heads, d] in q's dtype on every rank."""
    from mfa_tpu_torch.kernels.decode import decode_attention

    def fn(q, k_shard, v_shard, lengths):
        shard_len = k_shard.shape[2]
        start = axis_index(mesh, ctx_axis) * shard_len
        local = (lengths.to(torch.int64) - start).clamp(0, shard_len)
        o, lse = decode_attention(q, k_shard, v_shard, local.to(torch.int32),
                                  softmax_scale=softmax_scale,
                                  num_splits=num_splits, return_lse=True)
        return cross_chip_lse_combine(o.float(), lse, mesh,
                                      ctx_axis).to(q.dtype)

    return fn


def context_parallel_paged_decode(mesh, softmax_scale: Optional[float] = None,
                                  quantized=False, ctx_axis: str = CTX_AXIS):
    """Paged decode with the page pool sharded on ctx_axis: each rank owns a
    private pool holding a slice of every sequence's KV (the cache manager
    assigns pages to ranks; the block tables are per rank), so a KV cache
    larger than one card's memory serves decode.

    -> f(q, k_pages, v_pages, local_lens, local_tables[, k_scales,
    v_scales]): q [batch, heads, d] the same on every rank; the rank's pool
    k/v_pages [hkv, pages, page, d] (scales [hkv, pages, page] when
    quantized: True for int8 / fp8, "int4"); local_lens [batch] this rank's
    valid tokens of each sequence; local_tables [batch, pages_per_seq] its
    page ids. Kernel 6 with return_lse on the rank's pool, then the LSE
    merge across ctx_axis. Returns [batch, heads, d] on every rank."""
    from mfa_tpu_torch.kernels.paged import paged_attention

    qd = quantized if isinstance(quantized, str) else None

    def fn(q, k_pages, v_pages, local_lens, local_tables, k_scales=None,
           v_scales=None):
        if bool(quantized) != (k_scales is not None):
            raise ValueError("quantized pages need k_scales and v_scales, "
                             "bf16 pages take none")
        o, lse = paged_attention(q, k_pages, v_pages, local_lens, local_tables,
                                 k_scales=k_scales, v_scales=v_scales,
                                 softmax_scale=softmax_scale, quant_dtype=qd,
                                 return_lse=True)
        return cross_chip_lse_combine(o.float(), lse, mesh,
                                      ctx_axis).to(q.dtype)

    return fn
