"""Split-KV flash decoding (counterpart of mfa_tpu/kernels/decode.py).

Kernel 5 of the port: csrc/decode.cu, one launch (csrc/decode_sm90.cuh: a
TMA ring of K/V tiles, the products on the tensor cores) of one block per
(batch, kv head, split) over a contiguous [b, hkv, S, d] cache. One split
writes O and the LSE; with more, each block writes its normalized fp32
partial with its LSE and the last block of each (batch, kv head) to finish
merges them in the same launch, by `combine_splits`'s function (max
subtracted first, empty splits weighted 0). A CPU tensor runs the
partials and `combine_splits` in plain PyTorch.

Split ranges are whole 64-token tiles: split s covers tokens
[s * tps, (s + 1) * tps) with tps = ceil(ceil(S / 64) / splits) * 64, so a
result never depends on the split count beyond fp32 rounding. With a left
window the first `sink_tokens` columns stay visible (each in the one split
that holds it); ALiBi subtracts slope * |length - 1 - column|.

Any head_dim up to 256 (dispatch/config.py:head_dim_plan: the kernel's D,
a zero-padded copy only where a row's bytes are not a multiple of 16) and
any number of q heads a kv head: up to 8 q rows share one m16 tile, more
run in blocks of 16 rows (the paged kernel's), each block reading its kv
head's tiles again. fp32 q and caches run the same tile with both
products in 3xTF32 (launch name `decode_fp32`).
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
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels.prefill import check_band_options, cuda_slopes

_LOG2E = math.log2(math.e)
TILE = 64  # tokens per kernel tile (csrc/decode_sm90.cuh, also the paged kernel's)
# Blocks of launch 1 an SM holds: its ring takes ~193 KB of shared memory
BLOCKS_PER_SM = 1
# q rows of one kv head in a block: the m16 tile's 8 (its other 8 rows
# zero), or 16 a block when the group is larger (csrc/decode_sm90.cuh M16)
TILE_ROWS, M16_ROWS = 8, 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the most splits a launch takes: the merge keeps a weight a split and row
# in shared memory (csrc/decode_sm90.cuh MAX_SPLITS; the heuristic's own cap)
MAX_SPLITS = 128
_PARTIALS_ARGTYPES = [_P] * 9 + [_I] * 10 + [_F, _F, _F, _I, _P, _P]


def row_blocks(group: int) -> int:
    """Blocks of q rows launch 1 runs for each (batch, kv head, split): 1
    up to TILE_ROWS q heads a kv head, else one per M16_ROWS of them."""
    return 1 if group <= TILE_ROWS else cdiv(group, M16_ROWS)


def default_splits(batch: int, num_kv_heads: int, max_s: int,
                   group: int = 1) -> int:
    """The split count `num_splits=0` asks for: the heuristic at launch 1's
    residency, the 16-row blocks of groups above TILE_ROWS counted as
    work."""
    return num_splits_heuristic(batch * row_blocks(group), num_kv_heads,
                                max_s, TILE, blocks_per_sm=BLOCKS_PER_SM)


def split_layout(max_s: int, num_splits: int):
    """-> (num_splits, tokens_per_split) with every split non-empty in
    tiles (the last one may end past max_s), MAX_SPLITS at most."""
    n_tiles = max(1, cdiv(max_s, TILE))
    num_splits = max(1, min(num_splits, n_tiles, MAX_SPLITS))
    tiles_per_split = cdiv(n_tiles, num_splits)
    return cdiv(n_tiles, tiles_per_split), tiles_per_split * TILE


def combine_splits(o_parts: torch.Tensor, lse: torch.Tensor, axis: int = 2,
                   return_lse: bool = False):
    """Max-normalized LSE combine over a splits axis (plain version of the
    split merge of kernels 5 and 6; mfa_tpu/kernels/decode.py:combine_splits).

    o_parts: [..., splits, ..., d] normalized fp32 partials; lse: matching
    natural-log LSE per partial (-inf = empty split)."""
    m = lse.amax(dim=axis, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)
    w = torch.nan_to_num(w, nan=0.0)
    denom = w.sum(dim=axis, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (o_parts * w[..., None]).sum(dim=axis) / denom.squeeze(axis)[..., None]
    if return_lse:
        lse_g = m.squeeze(axis) + torch.log(denom.squeeze(axis))
        lse_g = torch.where(torch.isneginf(lse).all(dim=axis),
                            torch.full_like(lse_g, float("-inf")), lse_g)
        return out, lse_g
    return out


def _combine_exact(o_part: torch.Tensor, lse_part: torch.Tensor,
                   dtype: torch.dtype):
    """The split merge with the kernel's arithmetic (csrc/decode_sm90.cuh:
    merge_splits), to check its bits on the card: o_part [b, hkv, splits,
    rows, d] and lse_part [b, hkv, splits, rows] fp32 -> (O [b, hkv, rows,
    d] in dtype, LSE [b, hkv, rows]). Splits in order; each O step is one
    fused multiply-add, formed in fp64 (the product exact) and rounded to
    fp32, which can part from the kernel's single rounding only where the
    fp64 sum lands on an fp32 tie."""
    splits = lse_part.shape[2]
    m = torch.full_like(lse_part[:, :, 0], float("-inf"))
    for s in range(splits):
        m = torch.fmax(m, lse_part[:, :, s])
    all_empty = m == float("-inf")
    m = torch.where(all_empty, torch.zeros_like(m), m)
    w = torch.exp(lse_part - m[:, :, None])
    denom = torch.zeros_like(m)
    acc = torch.zeros_like(o_part[:, :, 0])
    for s in range(splits):
        denom = denom + w[:, :, s]
        acc = (w[:, :, s, :, None].double() * o_part[:, :, s].double()
               + acc.double()).float()
    dsafe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse = torch.where(all_empty, torch.full_like(m, float("-inf")),
                      m + torch.log(dsafe))
    return (acc / dsafe[..., None]).to(dtype), lse


def _decode_partials_plain(q, k_cache, v_cache, lens, scale, num_splits, tps,
                           window_left, softcap, sinks=0, alibi=None,
                           matmul=torch.matmul):
    """Per-split partials [b, hkv, splits, group, d] and LSE, as launch 1
    computes them (probabilities rounded to the cache dtype before P.V).
    `matmul` forms the two products (the tests pass
    kernels/backward.py:_matmul_3xtf32_plain, the fp32 tile's arithmetic)."""
    batch, num_heads, d = q.shape
    hkv, max_s = k_cache.shape[1], k_cache.shape[2]
    group = num_heads // hkv
    qg = q.float().reshape(batch, hkv, group, d)
    s = matmul(qg, k_cache.float().transpose(-1, -2))
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    col = torch.arange(max_s, device=q.device)
    lens = lens.to(q.device).long()[:, None]
    if alibi is not None:  # the decode row sits at length - 1
        dist = ((lens - 1) - col[None]).abs().float()  # [b, S]
        s = s - alibi.float().to(q.device).reshape(1, hkv, group, 1) \
            * dist[:, None, None, :]
    visible = col[None] < lens
    if window_left >= 0:
        visible &= (col[None] >= torch.clamp(lens - 1 - window_left, min=0)) \
            | (col[None] < sinks)
    parts, lses = [], []
    for sp in range(num_splits):
        vis = visible & (col[None] >= sp * tps) & (col[None] < (sp + 1) * tps)
        z = s.masked_fill(~vis[:, None, None, :], float("-inf"))
        m = z.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        p = torch.exp(z - m)
        l = p.sum(dim=-1)
        pr = p.to(v_cache.dtype).float()
        o = matmul(pr, v_cache.float())
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        parts.append(o / l_safe[..., None])
        lses.append(torch.where(l == 0, torch.full_like(l, float("-inf")),
                                m[..., 0] + torch.log(l_safe)))
    return torch.stack(parts, dim=2), torch.stack(lses, dim=2)


def _decode_cuda(q, k_cache, v_cache, lens, scale, num_splits, tps,
                 window_left, softcap, sinks=0, alibi=None, partials=None):
    """One launch of kernel 5. partials: (o_part [b, hkv, splits, group,
    d], lse_part [b, hkv, splits, group]) fp32 scratch for the splits'
    partials when there are more than one (a test reads them after the
    launch); else allocated."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    batch, num_heads, d = q.shape
    hkv, max_s = k_cache.shape[1], k_cache.shape[2]
    group = num_heads // hkv
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise NotImplementedError(
            "the decode kernel takes bf16/fp16/fp32 q and cache of one dtype")
    plan = head_dim_plan(d)
    _build.same_device("decode_attention", q, k_cache, v_cache, lens)
    _build.expect_shape("decode_attention", "k_cache", k_cache,
                        (batch, hkv, max_s, d))
    _build.expect_shape("decode_attention", "v_cache", v_cache, k_cache.shape)
    _build.expect_shape("decode_attention", "cache_seqlens", lens, (batch,))
    q, k_cache, v_cache = (_build.dense(pad_features(t, plan.stored))
                           for t in (q, k_cache, v_cache))
    d = plan.stored
    lens = lens.to(torch.int32).contiguous()
    dev = q.device
    slopes = cuda_slopes(alibi, _LOG2E, num_heads, dev)
    out = torch.empty_like(q)
    lse = torch.empty((batch, num_heads), dtype=torch.float32, device=dev)
    o_part = lse_part = counters = None
    if num_splits > 1:
        o_part, lse_part = partials if partials is not None else (
            torch.empty((batch, hkv, num_splits, group, d), dtype=torch.float32,
                        device=dev),
            torch.empty((batch, hkv, num_splits, group), dtype=torch.float32,
                        device=dev))
        _build.expect_shape("decode_attention", "o_part", o_part,
                            (batch, hkv, num_splits, group, d))
        _build.expect_shape("decode_attention", "lse_part", lse_part,
                            (batch, hkv, num_splits, group))
        counters = _build.split_counters(dev, batch * hkv * row_blocks(group))
    fn = _build.function("decode", "mfa_decode_partials", _PARTIALS_ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), lse.data_ptr(), _build.ptr(o_part),
            _build.ptr(lse_part), _build.ptr(counters),
            _build.DTYPE_CODES[q.dtype], batch, num_heads, hkv, max_s, d,
            plan.kernel_dim, num_splits, tps, window_left,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, sinks, _build.ptr(slopes),
            _build.stream_of(q))
    _build.check("decode", rc)
    _build.launches[_build.launch_key("decode", q.dtype)] += 1
    return unpad_features(out, plan.head_dim), lse


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    num_splits: int = 0,
    window_left: int = -1,
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
):
    """Decode attention against a contiguous per-batch KV cache.

    q: [batch, num_heads, head_dim]; k_cache/v_cache: [batch, num_kv_heads,
    max_seqlen, head_dim]; cache_seqlens: [batch] valid lengths.
    num_splits: 0 = the Hopper heuristic. window_left: attend to the last
    window_left + 1 tokens (-1 = all); sink_tokens: with a window, the
    first sink_tokens tokens stay visible too. alibi_slopes [num_heads]:
    - slope_h * |length - 1 - column| (not with logit_softcap). Returns
    [batch, num_heads, head_dim] in q's dtype (and, with return_lse, the
    fp32 natural-log LSE [batch, num_heads]).
    """
    sinks, _ = check_band_options(int(window_left), sink_tokens)
    if alibi_slopes is not None and logit_softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    batch, num_heads, head_dim = q.shape
    num_kv_heads, max_s = k_cache.shape[1], k_cache.shape[2]
    if num_heads % num_kv_heads:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(head_dim))
    if num_splits <= 0:
        num_splits = default_splits(batch, num_kv_heads, max_s,
                                    num_heads // num_kv_heads)
    num_splits, tps = split_layout(max_s, num_splits)
    args = (q, k_cache, v_cache, cache_seqlens, scale, num_splits, tps,
            int(window_left), float(logit_softcap), sinks, alibi_slopes)
    if q.device.type == "cpu":
        o_parts, lse = _decode_partials_plain(*args)
        out, lse_g = combine_splits(o_parts, lse, axis=2, return_lse=True)
        out = out.reshape(batch, num_heads, head_dim).to(q.dtype)
        lse_g = lse_g.reshape(batch, num_heads)
    elif q.device.type == "cuda":
        out, lse_g = _decode_cuda(*args)
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return (out, lse_g) if return_lse else out


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    cache_seqlens: torch.Tensor,
    block_table: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    num_splits: int = 0,
    window_left: int = -1,
    logit_softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode attention — see mfa_tpu_torch.kernels.paged.

    num_splits is accepted for signature parity with the contiguous route
    and has no effect: the paged kernel takes its own split count from
    the shapes (kernels/paged.py:split_plan).
    """
    from mfa_tpu_torch.kernels.paged import paged_attention

    del num_splits
    return paged_attention(
        q, k_pages, v_pages, cache_seqlens, block_table,
        softmax_scale=softmax_scale, window_left=window_left,
        logit_softcap=logit_softcap, sink_tokens=sink_tokens,
        alibi_slopes=alibi_slopes,
    )
