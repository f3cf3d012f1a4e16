"""Paged decode attention (counterpart of mfa_tpu/kernels/paged.py).

Kernel 6 of the port: csrc/paged.cu on kernel 5's tile
(csrc/decode_sm90.cuh): one block per (sequence, kv head, split) reads that
sequence's pages in place, TMA boxes of gcd(page_size, 64) rows through
block_table (bf16/fp16 pages, or int8, fp8 (e4m3) or int4 pages with fp32
per-row scales, converted exactly to bf16 in registers), and runs both
products on the tensor cores. Pages of any row count (int4: an even
one, as the cache makes them). One launch at any split count: one split
writes the final output and LSE; with more, each block writes its fp32
partial and the last block of each (sequence, kv head, row block) to
finish merges them (kernel 5's merge). A CPU tensor runs `_paged_plain`,
the same function in PyTorch; `_paged_split_plain` is the kernel's split
route in PyTorch.

Pages are [num_kv_heads, num_pages, page_size, w]: rows of w features
(int4: w / 2 bytes of feature pairs, kernels/quant.py:pack_int4), w the
head-dim plan's stored width (dispatch/config.py:head_dim_plan: head_dim,
widened with zero features only where a row's bytes would not be a
multiple of 16) as the cache creates them, or head_dim itself; without
the TPU's 128-lane padding, fp8-as-int8 bits or int4 token-pair order. q
is zero-padded to the pages' width (the extra features are inert), the
output sliced back, and the softmax scale is the true head_dim's. On the
card, pages not at the stored width are copied to it first (costly: the
cache never makes such pages).

Multi-query spans (q [b, q_span, hq, d], speculative verification): the
rows of a kv head are [q_span, group] flattened, and span row si sits at
position cache_seqlens + pos_offset - q_span + si, seeing the columns
before it (and its window). On the card they, and groups of more than 8 q
heads a kv head, run the kernel's 16-row blocks (`launch_name`
"paged_span" for spans).

With a left window the first `sink_tokens` columns stay visible to every
row (each read by the split that holds it); ALiBi subtracts slope_h *
|position - column| at each row's position, on every page format.

fp32 q runs the same tile (launch name `paged_fp32`) on fp32 pages, both
products in 3xTF32, or on quantized pages with q . k in fp32 against the
payload values (three exact bf16 products of q's parts) and p rounded to
bf16 for P.V, as mfa_tpu computes it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (cdiv, head_dim_plan,
                                           num_splits_heuristic, pad_features,
                                           softmax_scale_default,
                                           unpad_features)
from mfa_tpu_torch.kernels import _build, decode
from mfa_tpu_torch.kernels.decode import TILE
from mfa_tpu_torch.kernels.prefill import check_band_options, cuda_slopes
from mfa_tpu_torch.kernels.quant import (page_features, page_format,
                                         page_values, row_width)

_LOG2E = math.log2(math.e)
# Blocks of the kernel an SM holds: its ring takes 150-190 KB of shared memory
BLOCKS_PER_SM = 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 12 + [_I] * 15 + [_F, _F, _F, _I, _P, _P]


def launch_name(kernel: str, quant_dtype, q_span: int = 1,
                dtype: Optional[torch.dtype] = None) -> str:
    """Launch-count name of a paged kernel: "paged" / "paged_prefill" for
    16-bit and int8 pages, with "_fp8" or "_int4" for those formats;
    "paged_span" for kernel 6 on multi-query spans, whatever the format;
    "<kernel>_fp32" for fp32 q (the fp32 tile), whatever the pages and
    the span."""
    if dtype == torch.float32:
        return _build.launch_key(kernel, dtype)
    if q_span > 1:
        return "paged_span"
    return f"{kernel}_{quant_dtype}" if quant_dtype in ("fp8", "int4") else kernel


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


def _visible_range(lens, window_left, pos_offset, q_span=1):
    """Columns [lo, hi) [b, q_span] each query row sees (sinks aside) and
    the rows' positions: span row si sits at lens + pos_offset - q_span + si
    and reads no further than lens."""
    pos = (lens.long() + pos_offset - q_span)[:, None] + torch.arange(
        q_span, device=lens.device)[None]
    hi = torch.minimum(lens.long()[:, None], pos + 1)
    lo = torch.zeros_like(hi)
    if window_left >= 0:
        lo = torch.clamp(pos - window_left, min=0)
    return lo, hi, pos


def _paged_core(q, k_pages, v_pages, k_scales, v_scales, table, first, scale,
                softcap, lo, hi, quant_dtype=None, sinks=0, alibi=None,
                pos=None, col_lo=0, matmul=torch.matmul):
    """Normalized fp32 O [b, q_span, hq, d] and LSE [b, q_span, hq] of q [b,
    q_span, hq, d] over the columns [lo, hi) ([b, q_span]) of each query
    row, and those below `sinks` and hi, that table entries [first, first +
    table.shape[1]) hold from column col_lo on: K scales on score columns,
    ALiBi (slopes [hq]) at the rows' positions pos [b, q_span], V scales
    folded into the probabilities, probabilities rounded to the value dtype
    (bf16 for quantized pages) before P.V. int4 pages unpack, fp8 converts
    exactly. q is zero-padded to the pages' features, O sliced back.
    `matmul` forms the two products (the tests pass the fp32 tile's
    arithmetic: kernels/backward.py:_matmul_3xtf32_plain, or q's three bf16
    parts on quantized pages)."""
    batch, span, num_heads, d_true = q.shape
    hkv, _, page, _ = k_pages.shape
    group = num_heads // hkv
    pps = table.shape[1]
    quantized = k_scales is not None
    idx = table.long().clamp(0, k_pages.shape[1] - 1)
    d = page_features(quant_dtype, k_pages)
    q = pad_features(q, d)

    def gather(pages):  # [hkv, b, pps, page, w] -> [b, hkv, pps*page, d]
        g = page_values(pages[:, idx], quant_dtype)
        return g.permute(1, 0, 2, 3, 4).reshape(batch, hkv, pps * page, d)

    k, v = gather(k_pages), gather(v_pages)
    vdtype = torch.bfloat16 if quantized else v_pages.dtype
    if quantized and q.dtype == torch.float16:
        # fp16 q contracts against quantized pages in bf16 (as on TPU); fp32
        # q stays fp32 (mfa_tpu/kernels/paged.py:521-522)
        q = q.to(torch.bfloat16)
    rows = span * group  # [span, group] of a kv head, flattened
    qg = q.reshape(batch, span, hkv, group, d).float().transpose(1, 2)
    s = matmul(qg.reshape(batch, hkv, rows, d), k.float().transpose(-1, -2)
               ).reshape(batch, hkv, span, group, -1)
    if quantized:
        ks = k_scales[:, idx].permute(1, 0, 2, 3).reshape(batch, hkv, 1, 1, -1)
        s = s * ks
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    col = first * page + torch.arange(pps * page, device=q.device)[None, None]
    if alibi is not None:
        dist = (pos.to(q.device)[..., None] - col).abs().float()  # [b, span, cols]
        s = s - alibi.float().to(q.device).reshape(1, hkv, 1, group, 1) \
            * dist[:, None, :, None, :]
    visible = (((col >= lo.to(q.device)[..., None]) | (col < sinks))
               & (col < hi.to(q.device)[..., None]) & (col >= col_lo))
    s = s.masked_fill(~visible[:, None, :, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    if quantized:
        p = p * v_scales[:, idx].permute(1, 0, 2, 3).reshape(batch, hkv, 1, 1, -1)
    o = matmul(p.to(vdtype).float().reshape(batch, hkv, rows, -1), v.float()
               ).reshape(batch, hkv, span, group, d)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (o / l_safe[..., None]).permute(0, 2, 1, 3, 4).reshape(
        batch, span, num_heads, d)[..., :d_true]
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m[..., 0] + torch.log(l_safe))
    return out, lse.permute(0, 2, 1, 3).reshape(batch, span, num_heads)


def _spans(q):
    """q [b, hq, d] or [b, q_span, hq, d] -> (the 4-D view, q_span, squeeze):
    the 3-D form is a span of 1 whose results drop the span axis."""
    if q.ndim == 3:
        return q[:, None], 1, True
    return q, q.shape[1], False


def _paged_plain(q, k_pages, v_pages, k_scales, v_scales, lens, table,
                 scale, window_left, softcap, pos_offset, quant_dtype=None,
                 sinks=0, alibi=None):
    """The kernel's function in plain PyTorch (`_paged_core` over every
    visible column), out in q's dtype; q [b, hq, d] or [b, q_span, hq, d]."""
    q4, span, squeeze = _spans(q)
    lo, hi, pos = _visible_range(lens, window_left, pos_offset, span)
    out, lse = _paged_core(q4, k_pages, v_pages, k_scales, v_scales, table, 0,
                           scale, softcap, lo, hi, quant_dtype, sinks, alibi,
                           pos)
    if squeeze:
        out, lse = out[:, 0], lse[:, 0]
    return out.to(q.dtype), lse


def _paged_split_plain(q, k_pages, v_pages, k_scales, v_scales, lens, table,
                       scale, window_left, softcap, pos_offset,
                       num_splits=None, quant_dtype=None, sinks=0, alibi=None,
                       matmul=torch.matmul):
    """The kernel's split route in plain PyTorch: a partial over each
    split's table entries (`split_pages`) and tokens, merged by
    decode.combine_splits. num_splits None: the launcher's `split_plan`.
    `matmul` as in `_paged_core`."""
    q4, span, squeeze = _spans(q)
    batch = q4.shape[0]
    hkv, _, page, _ = k_pages.shape
    pps = table.shape[1]
    if num_splits is None:
        num_splits, tps = split_plan(batch, hkv, pps, page)
    else:
        num_splits, tps = decode.split_layout(pps * page, num_splits)
    lo, hi, pos = _visible_range(lens, window_left, pos_offset, span)
    hi = torch.clamp(hi, max=pps * page)
    parts, lses = [], []
    for sp in range(num_splits):
        first, end = split_pages(sp, tps, page, pps)
        o, lse = _paged_core(q4, k_pages, v_pages, k_scales, v_scales,
                             table[:, first:end], first, scale, softcap,
                             torch.clamp(lo, min=sp * tps),
                             torch.clamp(hi, max=(sp + 1) * tps), quant_dtype,
                             sinks, alibi, pos, sp * tps, matmul)
        parts.append(o)
        lses.append(lse)
    out, lse = decode.combine_splits(torch.stack(parts, 1), torch.stack(lses, 1),
                                     axis=1, return_lse=True)
    if squeeze:
        out, lse = out[:, 0], lse[:, 0]
    return out.to(q.dtype), lse


def _paged_cuda(q, k_pages, v_pages, k_scales, v_scales, lens, table, scale,
                window_left, softcap, pos_offset, quant_dtype=None, sinks=0,
                alibi=None, partials=None):
    """One launch of kernel 6. partials: (o_part [b, hkv, splits, q_span *
    group, d], lse_part [b, hkv, splits, q_span * group]) fp32 scratch for
    the splits' partials when split_plan gives more than one (a test reads
    them after the launch); else allocated."""
    _build.refuse_grad("paged_attention", q, k_pages, v_pages, k_scales,
                       v_scales)
    q4, span, squeeze = _spans(q)
    batch, _, num_heads, d_true = q4.shape
    hkv, num_pages, page, _ = k_pages.shape
    group = num_heads // hkv
    plan = head_dim_plan(d_true, quant_dtype)
    qk = quant_q(q4, k_pages, quant_dtype, "paged")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages dtypes differ")
    k_pages, v_pages = (stored_pages(p, quant_dtype, d_true)
                        for p in (k_pages, v_pages))
    d = plan.stored
    qk = pad_features(qk, d)
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
    slopes = cuda_slopes(alibi, _LOG2E, num_heads, q.device)
    out = torch.empty_like(qk)
    lse = torch.empty((batch, span, num_heads), dtype=torch.float32,
                      device=q.device)
    o_part = lse_part = counters = None
    if num_splits > 1:
        rows = span * group
        o_part, lse_part = partials if partials is not None else (
            torch.empty((batch, hkv, num_splits, rows, d), dtype=torch.float32,
                        device=q.device),
            torch.empty((batch, hkv, num_splits, rows), dtype=torch.float32,
                        device=q.device))
        _build.expect_shape(name, "o_part", o_part, (batch, hkv, num_splits, rows, d))
        _build.expect_shape(name, "lse_part", lse_part, (batch, hkv, num_splits, rows))
        row_blocks = 1 if span == 1 and group <= decode.TILE_ROWS else cdiv(
            rows, decode.M16_ROWS)
        counters = _build.split_counters(q.device, batch * hkv * row_blocks)
    fn = _build.function("paged", "mfa_paged_decode", _ARGTYPES)
    rc = fn(qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales), lens.data_ptr(),
            table.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _build.ptr(o_part), _build.ptr(lse_part), _build.ptr(counters),
            _build.DTYPE_CODES[qk.dtype], _build.kv_code(quant_dtype, k_pages),
            batch, num_heads, hkv, num_pages, page, pps, d, plan.kernel_dim,
            span, num_splits, tps, pos_offset, window_left,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, sinks, _build.ptr(slopes),
            _build.stream_of(q))
    _build.check("paged", rc)
    _build.launches[launch_name("paged", quant_dtype, span, qk.dtype)] += 1
    out = unpad_features(out, d_true)
    if squeeze:
        out, lse = out[:, 0], lse[:, 0]
    return out.to(q.dtype), lse


def quant_q(q: torch.Tensor, k_pages: torch.Tensor, quant_dtype,
            kernel: str) -> torch.Tensor:
    """q as a paged kernel takes it: pages of q's own dtype (bf16, fp16 or
    fp32), or quantized pages with bf16 or fp32 q; fp16 q contracts
    against quantized pages in bf16, fp32 q stays fp32 (q . k in fp32
    against the payload values, as mfa_tpu/kernels/paged.py:521-522 and
    paged_prefill.py:440-441 keep it)."""
    if quant_dtype is not None:
        if q.dtype == torch.float16:
            return q.to(torch.bfloat16)
        if q.dtype in (torch.bfloat16, torch.float32):
            return q
        raise NotImplementedError(f"{quant_dtype} pages take bf16/fp16/fp32 q")
    if k_pages.dtype == q.dtype and q.dtype in (torch.bfloat16, torch.float16,
                                                 torch.float32):
        return q
    raise NotImplementedError(
        f"the {kernel} kernel takes bf16/fp16/fp32 pages of the q dtype or "
        f"quantized pages, got {k_pages.dtype} pages with {q.dtype} q")


def stored_pages(pages: torch.Tensor, quant_dtype, head_dim: int) -> torch.Tensor:
    """Pages at the head-dim plan's stored width: the pages themselves, or
    (unpadded rows whose bytes are not a multiple of 16) a zero-padded copy
    of the whole pool, which a TMA map can read."""
    width = row_width(quant_dtype, head_dim)
    if pages.shape[-1] == width:
        return pages
    return pad_features(pages.view(torch.uint8) if pages.dtype.itemsize == 1
                        else pages, width).view(pages.dtype)


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
    """Paged decode attention (seqlen_q == 1, or a speculative span).

    q: [batch, num_heads, head_dim], or [batch, q_span, num_heads,
    head_dim]: span row si sits at position cache_seqlens + pos_offset -
    q_span + si and sees the columns before it (pos_offset 0: the lengths
    include the span). k_pages/v_pages: [num_kv_heads,
    num_pages, page_size, head_dim], bf16/fp16/fp32, or quantized with
    k_scales/v_scales [num_kv_heads, num_pages, page_size] fp32: int8,
    fp8 (float8_e4m3fn) or int4 (quant_dtype="int4": int8 bytes
    [..., head_dim / 2], kernels/quant.py:pack_int4). quant_dtype None
    takes int8 or fp8 from the pages' dtype.
    cache_seqlens: [batch] stored lengths; block_table: [batch,
    pages_per_seq] physical page ids.

    pos_offset (deferred append): reads stay bounded by cache_seqlens
    while the queries sit pos_offset further on — the caller merges the
    span's own K/V rows by LSE (models/llama.py:_merge_deferred). Needs
    window_left >= q_span when windowed, as on the TPU.

    sink_tokens: with a left window, the first sink_tokens columns stay
    visible to every row. alibi_slopes [num_heads]: - slope_h * |position
    - column| at each row's position (not with logit_softcap).

    Returns q's shape in q's dtype (and, with return_lse, the fp32
    natural-log LSE [batch, (q_span,) num_heads]; -inf for an empty row).
    """
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be [b, hq, d] or [b, q_span, hq, d], got "
                         f"{tuple(q.shape)}")
    sinks, _ = check_band_options(int(window_left), sink_tokens)
    if alibi_slopes is not None and logit_softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    q_span = 1 if q.ndim == 3 else q.shape[1]
    if pos_offset and 0 <= window_left < q_span:
        raise ValueError(f"pos_offset={pos_offset} (deferred append) needs "
                         f"window_left >= q_span ({q_span}), got {window_left}")
    fmt = page_format(quant_dtype, k_pages, k_scales, q.shape[-1])
    if q.shape[-2] % k_pages.shape[0]:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    args = (q, k_pages, v_pages, k_scales, v_scales, cache_seqlens,
            block_table, scale, int(window_left), float(logit_softcap),
            int(pos_offset), fmt, sinks, alibi_slopes)
    if q.device.type == "cpu":
        out, lse = _paged_plain(*args)
    elif q.device.type == "cuda":
        out, lse = _paged_cuda(*args)
    else:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out
