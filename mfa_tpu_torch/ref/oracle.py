"""Plain fp32 attention oracles (counterpart of mfa_tpu/ref/oracle.py).

Semantics mirror the jnp originals: GQA q head h reads kv head
h // (num_heads // num_kv_heads), causal is top-left aligned, softmax
scale defaults to 1/sqrt(head_dim), fully masked rows give zeros.
Layouts are the public [batch, seq, heads, head_dim].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "decode_ref", "paged_decode_ref"]

_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


def _expand_kv_heads(k: torch.Tensor, num_heads: int, head_axis: int):
    num_kv_heads = k.shape[head_axis]
    if num_kv_heads == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // num_kv_heads, dim=head_axis)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    q_offset=0,
    seqlen_k: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense attention oracle.

    q: [batch, seqlen_q, num_heads, head_dim]; k/v: [batch, seqlen_k,
    num_kv_heads, head_dim]. q_offset: absolute position of q row 0 (int
    or [batch]); seqlen_k: optional [batch] valid kv lengths.
    Returns [batch, seqlen_q, num_heads, head_dim] in q.dtype.
    """
    orig_dtype = q.dtype
    batch, sq, num_heads, head_dim = q.shape
    sk = k.shape[1]
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(head_dim)
    dev = q.device
    qf = q.float()
    kf = _expand_kv_heads(k.float(), num_heads, 2)
    vf = _expand_kv_heads(v.float(), num_heads, 2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * softmax_scale

    row = torch.arange(sq, device=dev)[:, None]
    col = torch.arange(sk, device=dev)[None, :]
    q_offset = torch.as_tensor(q_offset, device=dev)
    if q_offset.ndim == 0:
        abs_row = (row + q_offset)[None]  # [1, sq, 1]
    else:
        abs_row = row[None] + q_offset[:, None, None]  # [b, sq, 1]
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=dev) & \
        torch.ones_like(abs_row, dtype=torch.bool)
    if causal:
        mask = mask & (col[None] <= abs_row)
    wl, wr = window_size
    if wl >= 0:
        mask = mask & (col[None] >= abs_row - wl)
    if wr >= 0 and not causal:
        mask = mask & (col[None] <= abs_row + wr)
    if seqlen_k is not None:
        lens = torch.as_tensor(seqlen_k, device=dev)
        mask = mask & (col[None] < lens[:, None, None])

    scores = torch.where(mask[:, None], scores,
                         torch.tensor(_MASK_VALUE, device=dev))
    probs = torch.softmax(scores, dim=-1)
    row_any = torch.any(mask, dim=-1)[:, None, :, None]
    probs = torch.where(row_any, probs, torch.zeros((), device=dev))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(orig_dtype)


def decode_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
) -> torch.Tensor:
    """Decode (seqlen_q == 1) oracle against a contiguous KV cache.

    q: [batch, 1, num_heads, head_dim]; k_cache/v_cache: [batch,
    max_seqlen_k, num_kv_heads, head_dim]; cache_seqlens: [batch].
    The single query is the last token: masking is by cache length (and
    the left window, counted back from position length-1).
    """
    batch, s_k, num_kv_heads, head_dim = k_cache.shape
    num_heads = q.shape[2]
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    dev = q.device
    qf = q.float()[:, 0]
    kf = _expand_kv_heads(k_cache.float(), num_heads, 2)
    vf = _expand_kv_heads(v_cache.float(), num_heads, 2)
    scores = torch.einsum("bhd,bshd->bhs", qf, kf) * softmax_scale
    lens = torch.as_tensor(cache_seqlens, device=dev).long()[:, None, None]
    col = torch.arange(s_k, device=dev)[None, None, :]
    visible = col < lens
    if window_left >= 0:
        start = torch.clamp(lens - 1 - window_left, min=0)
        visible = visible & (col >= start)
    scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out[:, None].to(q.dtype)


def paged_decode_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    cache_seqlens: torch.Tensor,
    block_table: torch.Tensor,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
) -> torch.Tensor:
    """Paged decode oracle: gathers each sequence's pages into a contiguous
    cache, then runs decode_ref.

    q: [batch, 1, num_heads, head_dim]; k_pages/v_pages: [num_pages,
    page_size, num_kv_heads, head_dim]; block_table: [batch, max_pages].
    """
    num_pages, page_size, num_kv_heads, head_dim = k_pages.shape
    batch, max_pages = block_table.shape
    idx = block_table.long()
    k_gather = k_pages[idx].reshape(batch, max_pages * page_size,
                                    num_kv_heads, head_dim)
    v_gather = v_pages[idx].reshape(batch, max_pages * page_size,
                                    num_kv_heads, head_dim)
    return decode_ref(q, k_gather, v_gather, cache_seqlens,
                      softmax_scale=softmax_scale, window_left=window_left)
