"""Paged decode attention (counterpart of mfa_tpu/kernels/paged.py).

Kernel 6 of the port: csrc/paged.cu on kernel 5's tile
(csrc/decode_sm90.cuh): one block per (sequence, kv head, split) reads that
sequence's pages in place, one TMA box per page through block_table
(bf16/fp16 pages, or int8 pages with fp32 per-row scales), and runs both
products on the tensor cores. One split writes the final output and LSE;
more write fp32 partials that kernel 5's combine launch merges. A CPU
tensor runs `_paged_plain`, the same function in PyTorch;
`_paged_split_plain` is the kernel's split route in PyTorch.

Pages are [num_kv_heads, num_pages, page_size, head_dim]: head_dim wide,
without the TPU's 128-lane padding, fp8-as-int8 bits or int4 pair order.
Only q_span == 1 is ported (speculative spans come later).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (cdiv, num_splits_heuristic,
                                           softmax_scale_default)
from mfa_tpu_torch.kernels import _build, decode
from mfa_tpu_torch.kernels.decode import KERNEL_HEAD_DIMS, MAX_GROUP, TILE

_LOG2E = math.log2(math.e)
# Blocks of the kernel an SM holds: its ring takes 150-190 KB of shared memory
BLOCKS_PER_SM = 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 13 + [_F, _F, _F, _P]


def split_plan(batch: int, num_kv_heads: int, pages_per_seq: int,
               page_size: int):
    """-> (num_splits, tokens_per_split) of the kernel's grid: the split
    heuristic at the kernel's residency over the table's whole span
    (pages_per_seq * page_size tokens; the lengths stay on the device), in
    whole 64-token tiles. It must never read the lengths: a decode graph
    (serve/graphs.py) freezes the grid at capture and replays it at every
    later length (tests/test_torch_graphs_gpu.py crosses the split point)."""
    max_s = pages_per_seq * page_size
    n = num_splits_heuristic(batch, num_kv_heads, max_s, TILE,
                             blocks_per_sm=BLOCKS_PER_SM)
    return decode.split_layout(max_s, n)


def split_pages(split: int, tokens_per_split: int, page_size: int,
                pages_per_seq: int):
    """-> (first, end): the table entries a split can read, tokens
    [split * tokens_per_split, (split + 1) * tokens_per_split)."""
    first = split * tokens_per_split // page_size
    end = min(pages_per_seq, cdiv((split + 1) * tokens_per_split, page_size))
    return first, end


def _visible_range(lens, window_left, pos_offset):
    """Columns [lo, hi) each sequence's query sees."""
    hi = lens.long()
    lo = torch.zeros_like(hi)
    if window_left >= 0:
        lo = torch.clamp(hi + pos_offset - 1 - window_left, min=0)
    return lo, hi


def _paged_core(q, k_pages, v_pages, k_scales, v_scales, table, first, scale,
                softcap, lo, hi):
    """Normalized fp32 O [b, hq, d] and LSE [b, hq] over the columns [lo,
    hi) of each sequence that table entries [first, first + table.shape[1])
    hold: K scales on score columns, V scales folded into the
    probabilities, probabilities rounded to the value dtype (bf16 for int8
    pages) before P.V."""
    batch, num_heads, d = q.shape
    hkv, _, page, _ = k_pages.shape
    group = num_heads // hkv
    pps = table.shape[1]
    quantized = k_scales is not None
    idx = table.long().clamp(0, k_pages.shape[1] - 1)
    # [hkv, b, pps, page, d] -> [b, hkv, pps*page, d]
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(batch, hkv, pps * page, d)
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(batch, hkv, pps * page, d)
    vdtype = torch.bfloat16 if quantized else v_pages.dtype
    if quantized and q.dtype == torch.float16:
        q = q.to(torch.bfloat16)  # int8 pages contract in bf16 (as on TPU)
    qg = q.reshape(batch, hkv, group, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    if quantized:
        ks = k_scales[:, idx].permute(1, 0, 2, 3).reshape(batch, hkv, 1, -1)
        s = s * ks
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    col = first * page + torch.arange(pps * page, device=q.device)[None]
    visible = (col >= lo.to(q.device)[:, None]) & (col < hi.to(q.device)[:, None])
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    if quantized:
        p = p * v_scales[:, idx].permute(1, 0, 2, 3).reshape(batch, hkv, 1, -1)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(vdtype).float(), v.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (o / l_safe[..., None]).reshape(batch, num_heads, d)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m[..., 0] + torch.log(l_safe))
    return out, lse.reshape(batch, num_heads)


def _paged_plain(q, k_pages, v_pages, k_scales, v_scales, lens, table,
                 scale, window_left, softcap, pos_offset):
    """The kernel's function in plain PyTorch (`_paged_core` over every
    visible column), out in q's dtype."""
    lo, hi = _visible_range(lens, window_left, pos_offset)
    out, lse = _paged_core(q, k_pages, v_pages, k_scales, v_scales, table, 0,
                           scale, softcap, lo, hi)
    return out.to(q.dtype), lse


def _paged_split_plain(q, k_pages, v_pages, k_scales, v_scales, lens, table,
                       scale, window_left, softcap, pos_offset,
                       num_splits=None):
    """The kernel's split route in plain PyTorch: a partial over each
    split's table entries (`split_pages`) and tokens, merged by
    decode.combine_splits. num_splits None: the launcher's `split_plan`."""
    batch, num_heads, d = q.shape
    hkv, _, page, _ = k_pages.shape
    pps = table.shape[1]
    if num_splits is None:
        num_splits, tps = split_plan(batch, hkv, pps, page)
    else:
        num_splits, tps = decode.split_layout(pps * page, num_splits)
    lo, hi = _visible_range(lens, window_left, pos_offset)
    hi = torch.clamp(hi, max=pps * page)
    parts, lses = [], []
    for sp in range(num_splits):
        first, end = split_pages(sp, tps, page, pps)
        o, lse = _paged_core(q, k_pages, v_pages, k_scales, v_scales,
                             table[:, first:end], first, scale, softcap,
                             torch.clamp(lo, min=sp * tps),
                             torch.clamp(hi, max=(sp + 1) * tps))
        parts.append(o)
        lses.append(lse)
    out, lse = decode.combine_splits(torch.stack(parts, 1), torch.stack(lses, 1),
                                     axis=1, return_lse=True)
    return out.to(q.dtype), lse


def _paged_cuda(q, k_pages, v_pages, k_scales, v_scales, lens, table, scale,
                window_left, softcap, pos_offset):
    _build.refuse_grad("paged_attention", q, k_pages, v_pages, k_scales,
                       v_scales)
    batch, num_heads, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    group = num_heads // hkv
    if d not in KERNEL_HEAD_DIMS or group > MAX_GROUP:
        raise NotImplementedError(
            f"the paged kernel takes head_dim in {KERNEL_HEAD_DIMS} and at "
            f"most {MAX_GROUP} q heads per kv head")
    if page % 8:
        raise NotImplementedError(
            f"the paged kernel takes pages of a multiple of 8 rows (one "
            f"swizzled TMA box), got {page}")
    if k_pages.dtype == torch.int8:
        if q.dtype not in (torch.bfloat16, torch.float16):
            raise NotImplementedError("int8 pages take bf16/fp16 q")
        qk = q.to(torch.bfloat16)  # int8 pages contract in bf16 (as on TPU)
    elif k_pages.dtype == q.dtype and q.dtype in (torch.bfloat16, torch.float16):
        qk = q
    else:
        raise NotImplementedError(
            f"the paged kernel takes bf16/fp16 pages of the q dtype or int8 "
            f"pages, got {k_pages.dtype} pages with {q.dtype} q")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages dtypes differ")
    tensors = [qk, k_pages, v_pages, lens, table]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    _build.same_device("paged_attention", *tensors)
    name = "paged_attention"
    _build.expect_shape(name, "v_pages", v_pages, k_pages.shape)
    _build.expect_shape(name, "cache_seqlens", lens, (batch,))
    _build.expect_shape(name, "block_table", table, (batch, table.shape[1]))
    if k_scales is not None:
        _build.expect_shape(name, "k_scales", k_scales, k_pages.shape[:3])
        _build.expect_shape(name, "v_scales", v_scales, k_pages.shape[:3])
        k_scales, v_scales = (_build.dense(t.float()) for t in (k_scales, v_scales))
    qk, k_pages, v_pages = (_build.dense(t) for t in (qk, k_pages, v_pages))
    lens = lens.to(torch.int32).contiguous()
    table = table.to(torch.int32).contiguous()
    pps = table.shape[1]
    num_splits, tps = split_plan(batch, hkv, pps, page)
    out = torch.empty_like(qk)
    lse = torch.empty((batch, num_heads), dtype=torch.float32, device=q.device)
    o_part = lse_part = None
    if num_splits > 1:
        o_part = torch.empty((batch, hkv, num_splits, group, d),
                             dtype=torch.float32, device=q.device)
        lse_part = torch.empty((batch, hkv, num_splits, group),
                               dtype=torch.float32, device=q.device)
    fn = _build.function("paged", "mfa_paged_decode", _ARGTYPES)
    rc = fn(qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales), lens.data_ptr(),
            table.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _build.ptr(o_part), _build.ptr(lse_part),
            _build.DTYPE_CODES[qk.dtype], _build.DTYPE_CODES[k_pages.dtype],
            batch, num_heads, hkv, num_pages, page, pps, d, num_splits, tps,
            pos_offset, window_left,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, _build.stream_of(q))
    _build.check("paged", rc)
    _build.launches["paged"] += 1
    if num_splits > 1:
        decode.launch_combine(o_part, lse_part, out, lse)
    return out.to(q.dtype), lse


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    cache_seqlens: torch.Tensor,
    block_table: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    quant_dtype: Optional[str] = None,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
    pos_offset: int = 0,
):
    """Paged decode attention (seqlen_q == 1).

    q: [batch, num_heads, head_dim]. k_pages/v_pages: [num_kv_heads,
    num_pages, page_size, head_dim], bf16/fp16/fp32, or int8 with
    k_scales/v_scales [num_kv_heads, num_pages, page_size] fp32.
    cache_seqlens: [batch] stored lengths; block_table: [batch,
    pages_per_seq] physical page ids.

    pos_offset (deferred append): the query sits at absolute position
    cache_seqlens + pos_offset - 1 while reads stay bounded by
    cache_seqlens — the caller merges the query's own K/V row by LSE
    (models/llama.py:_merge_deferred). Needs window_left >= 1 when
    windowed, as on the TPU.

    Returns [batch, num_heads, head_dim] in q's dtype (and, with
    return_lse, the fp32 natural-log LSE [batch, num_heads]; -inf for an
    empty row).
    """
    if q.ndim != 3:
        raise NotImplementedError("multi-query spans (q_span > 1) are not "
                                  "ported yet")
    if quant_dtype not in (None, "int8"):
        raise NotImplementedError(f"{quant_dtype} pages are not ported yet")
    if sink_tokens or alibi_slopes is not None:
        raise NotImplementedError("sink_tokens and alibi_slopes are not "
                                  "ported yet")
    if pos_offset and 0 <= window_left < 1:
        raise ValueError(f"pos_offset={pos_offset} (deferred append) needs "
                         f"window_left >= 1, got {window_left}")
    if (k_scales is None) != (k_pages.dtype != torch.int8):
        raise ValueError("int8 pages need k_scales/v_scales, and only they")
    if k_pages.shape[-1] != q.shape[-1]:
        raise ValueError(f"page width {k_pages.shape[-1]} != head_dim "
                         f"{q.shape[-1]}")
    if q.shape[1] % k_pages.shape[0]:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    args = (q, k_pages, v_pages, k_scales, v_scales, cache_seqlens,
            block_table, scale, int(window_left), float(logit_softcap),
            int(pos_offset))
    if q.device.type == "cpu":
        out, lse = _paged_plain(*args)
    elif q.device.type == "cuda":
        out, lse = _paged_cuda(*args)
    else:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out
