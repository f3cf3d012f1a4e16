"""Public API (counterpart of mfa_tpu/interface.py).

The reference's layouts at the boundary: [batch, seq, heads, head_dim] for
flash_attn_func; flash_attn_with_kvcache takes a contiguous cache
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

__all__ = ["flash_attn_func", "flash_attn_with_kvcache"]


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
    logits. ALiBi is not ported yet. Returns (batch, seqlen_q, nheads,
    headdim).
    """
    validate_attention_inputs(q, k, v, api_name="flash_attn_func")
    out = prefill_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, softmax_scale=softmax_scale,
        window_size=tuple(window_size), logit_softcap=float(softcap),
        alibi_slopes=alibi_slopes,
    )
    return out.transpose(1, 2)


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
) -> torch.Tensor:
    """Decode attention against a KV cache (reference: interface.py:95-124).

    q: (batch, 1, nheads, headdim) — seqlen_q must be 1. Contiguous cache:
    k_cache/v_cache (batch, max_seqlen_k, nheads_k, headdim) -> the split-KV
    decode kernel (num_splits: 0 = heuristic). Paged cache: k_cache/v_cache
    (num_pages, page_size, nheads_k, headdim) with block_table (batch,
    max_pages_per_seq) -> the paged kernel. cache_seqlens: int or (batch,)
    valid lengths (None = full). window_size: only `left` applies (the
    query is the last token). Returns (batch, 1, nheads, headdim).
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
            window_left=int(window_size[0]), logit_softcap=float(softcap))
    else:
        out = decode_attention(
            q3, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            cache_seqlens, softmax_scale=softmax_scale, num_splits=num_splits,
            window_left=int(window_size[0]), logit_softcap=float(softcap))
    return out[:, None]
