"""Public API (counterpart of mfa_tpu/interface.py).

The reference's layouts at the boundary: [batch, seq, heads, head_dim] for
flash_attn_func; packed [total, heads, head_dim] with cu_seqlens (or a
paged pool with block_table) for flash_attn_varlen_func;
flash_attn_with_kvcache takes a contiguous cache
[batch, max_seqlen, kv_heads, head_dim] or a paged pool [num_pages,
page_size, kv_heads, head_dim] with block_table. Kernels run on
[batch, heads, seq, head_dim] and [kv_heads, num_pages, page, head_dim];
the transposes happen here. Serving code that owns its layouts calls
mfa_tpu_torch.kernels directly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from mfa_tpu_torch.dispatch.config import validate_attention_inputs
from mfa_tpu_torch.kernels.decode import decode_attention, paged_decode_attention
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.varlen import varlen_attention

__all__ = [
    "flash_attn_func",
    "flash_attn_varlen_func",
    "flash_attn_with_kvcache",
]


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention forward (reference: interface.py:6-37).

    q: (batch, seqlen_q, nheads, headdim); k/v: (batch, seqlen_k, nheads_k,
    headdim) with nheads % nheads_k == 0. causal: top-left aligned.
    window_size: (left, right), -1 = unbounded. softcap > 0: tanh cap on the
    logits. alibi_slopes: [nheads] fp32, - slope * |i - j| on the logits
    (top-left positions, as in mfa_tpu; not with softcap). Returns
    (batch, seqlen_q, nheads, headdim).
    """
    validate_attention_inputs(q, k, v, api_name="flash_attn_func")
    out = prefill_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, softmax_scale=softmax_scale,
        window_size=tuple(window_size), logit_softcap=float(softcap),
        alibi_slopes=alibi_slopes,
    )
    return out.transpose(1, 2)


def flash_attn_varlen_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    causal: bool = False,
    block_table: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    window_size: tuple = (-1, -1),
    sink_tokens: int = 0,
) -> torch.Tensor:
    """Varlen (continuous batching) attention (reference: interface.py:40-92).

    q: (total_q, nheads, headdim); k/v: (total_k, nheads_k, headdim) -> the
    varlen kernel, or with block_table (batch, max_pages_per_seq) a paged
    pool (num_pages, page_size, nheads_k, headdim) -> the paged prefill
    kernel. cu_seqlens_*: (batch+1,) int32 cumulative lengths. causal is
    top-left aligned per sequence; window_size: (left, right) on
    sequence-local positions; sink_tokens keeps each sequence's first
    tokens visible through a left window; alibi_slopes [nheads] on
    sequence-local positions. Returns (total_q, nheads, headdim).
    """
    return varlen_attention(
        q, k, v, cu_seqlens_q, cu_seqlens_k, int(max_seqlen_q),
        int(max_seqlen_k), causal=causal, block_table=block_table,
        softmax_scale=softmax_scale, logit_softcap=float(softcap),
        alibi_slopes=alibi_slopes,
        window_size=(int(window_size[0]), int(window_size[1])),
        sink_tokens=int(sink_tokens))


def flash_attn_with_kvcache(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_seqlens: Optional[Union[int, torch.Tensor]] = None,
    block_table: Optional[torch.Tensor] = None,
    num_splits: int = 0,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention against a KV cache (reference: interface.py:95-124).

    q: (batch, 1, nheads, headdim) — seqlen_q must be 1. Contiguous cache:
    k_cache/v_cache (batch, max_seqlen_k, nheads_k, headdim) -> the split-KV
    decode kernel (num_splits: 0 = heuristic). Paged cache: k_cache/v_cache
    (num_pages, page_size, nheads_k, headdim) with block_table (batch,
    max_pages_per_seq) -> the paged kernel. cache_seqlens: int or (batch,)
    valid lengths (None = full). window_size: only `left` applies (the
    query is the last token); sink_tokens: with a left window, the first
    sink_tokens cache tokens stay visible. alibi_slopes [nheads]: - slope *
    |length - 1 - j|. Returns (batch, 1, nheads, headdim).
    """
    if q.shape[1] != 1:
        raise ValueError(
            "flash_attn_with_kvcache currently only supports seqlen_q=1 for "
            "decoding")
    batch = q.shape[0]
    if cache_seqlens is None:
        cache_seqlens = (block_table.shape[1] * k_cache.shape[1]
                         if block_table is not None else k_cache.shape[1])
    if isinstance(cache_seqlens, int):
        cache_seqlens = torch.full((batch,), cache_seqlens, dtype=torch.int32,
                                   device=q.device)
    else:
        cache_seqlens = torch.as_tensor(cache_seqlens, dtype=torch.int32,
                                        device=q.device)
    q3 = q[:, 0]
    if block_table is not None:
        # [num_pages, page, hkv, d] -> kernel layout [hkv, num_pages, page, d]
        out = paged_decode_attention(
            q3, k_cache.permute(2, 0, 1, 3), v_cache.permute(2, 0, 1, 3),
            cache_seqlens, block_table.to(device=q.device, dtype=torch.int32),
            softmax_scale=softmax_scale, num_splits=num_splits,
            window_left=int(window_size[0]), logit_softcap=float(softcap),
            sink_tokens=int(sink_tokens), alibi_slopes=alibi_slopes)
    else:
        out = decode_attention(
            q3, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            cache_seqlens, softmax_scale=softmax_scale, num_splits=num_splits,
            window_left=int(window_size[0]), logit_softcap=float(softcap),
            sink_tokens=int(sink_tokens), alibi_slopes=alibi_slopes)
    return out[:, None]
