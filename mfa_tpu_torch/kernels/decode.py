"""Split-KV flash decoding (counterpart of mfa_tpu/kernels/decode.py).

Kernel 5 of the port: csrc/decode.cu. Launch 1 (csrc/decode_sm90.cuh: a
TMA ring of K/V tiles, the products on the tensor cores) runs one block per
(batch, kv head, split) over a contiguous [b, hkv, S, d] cache and writes
normalized fp32 partials with their LSE; launch 2 merges the splits
(`combine_splits`, max subtracted first, empty splits skipped). A CPU
tensor runs the same two steps in plain PyTorch.

Split ranges are whole 64-token tiles: split s covers tokens
[s * tps, (s + 1) * tps) with tps = ceil(ceil(S / 64) / splits) * 64, so a
result never depends on the split count beyond fp32 rounding.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (cdiv, num_splits_heuristic,
                                           softmax_scale_default)
from mfa_tpu_torch.kernels import _build

_LOG2E = math.log2(math.e)
TILE = 64  # tokens per kernel tile (csrc/decode_sm90.cuh, also the paged kernel's)
# Blocks of launch 1 an SM holds: its ring takes ~193 KB of shared memory
BLOCKS_PER_SM = 1
MAX_GROUP = 8  # q heads per kv head the kernels take
KERNEL_HEAD_DIMS = (64, 128, 256)  # shared with the paged kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PARTIALS_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _F, _F, _F, _P]
_COMBINE_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def default_splits(batch: int, num_kv_heads: int, max_s: int) -> int:
    """The split count `num_splits=0` asks for: the heuristic at launch 1's
    residency."""
    return num_splits_heuristic(batch, num_kv_heads, max_s, TILE,
                                blocks_per_sm=BLOCKS_PER_SM)


def split_layout(max_s: int, num_splits: int):
    """-> (num_splits, tokens_per_split) with every split non-empty in
    tiles (the last one may end past max_s)."""
    n_tiles = max(1, cdiv(max_s, TILE))
    num_splits = max(1, min(num_splits, n_tiles))
    tiles_per_split = cdiv(n_tiles, num_splits)
    return cdiv(n_tiles, tiles_per_split), tiles_per_split * TILE


def combine_splits(o_parts: torch.Tensor, lse: torch.Tensor, axis: int = 2,
                   return_lse: bool = False):
    """Max-normalized LSE combine over a splits axis (plain version of the
    combine launch; mfa_tpu/kernels/decode.py:combine_splits).

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


def _decode_partials_plain(q, k_cache, v_cache, lens, scale, num_splits, tps,
                           window_left, softcap):
    """Per-split partials [b, hkv, splits, group, d] and LSE, as launch 1
    computes them (probabilities rounded to the cache dtype before P.V)."""
    batch, num_heads, d = q.shape
    hkv, max_s = k_cache.shape[1], k_cache.shape[2]
    group = num_heads // hkv
    qg = q.float().reshape(batch, hkv, group, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    col = torch.arange(max_s, device=q.device)
    lens = lens.to(q.device).long()[:, None]
    visible = col[None] < lens
    if window_left >= 0:
        visible &= col[None] >= torch.clamp(lens - 1 - window_left, min=0)
    parts, lses = [], []
    for sp in range(num_splits):
        vis = visible & (col[None] >= sp * tps) & (col[None] < (sp + 1) * tps)
        z = s.masked_fill(~vis[:, None, None, :], float("-inf"))
        m = z.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        p = torch.exp(z - m)
        l = p.sum(dim=-1)
        pr = p.to(v_cache.dtype).float()
        o = torch.einsum("bhgs,bhsd->bhgd", pr, v_cache.float())
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        parts.append(o / l_safe[..., None])
        lses.append(torch.where(l == 0, torch.full_like(l, float("-inf")),
                                m[..., 0] + torch.log(l_safe)))
    return torch.stack(parts, dim=2), torch.stack(lses, dim=2)


def _decode_cuda(q, k_cache, v_cache, lens, scale, num_splits, tps,
                 window_left, softcap):
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    batch, num_heads, d = q.shape
    hkv, max_s = k_cache.shape[1], k_cache.shape[2]
    group = num_heads // hkv
    if q.dtype not in (torch.bfloat16, torch.float16) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise NotImplementedError(
            "the decode kernel takes bf16/fp16 q and cache of one dtype")
    if d not in KERNEL_HEAD_DIMS or group > MAX_GROUP:
        raise NotImplementedError(
            f"the decode kernel takes head_dim in {KERNEL_HEAD_DIMS} and at "
            f"most {MAX_GROUP} q heads per kv head")
    _build.same_device("decode_attention", q, k_cache, v_cache, lens)
    _build.expect_shape("decode_attention", "k_cache", k_cache,
                        (batch, hkv, max_s, d))
    _build.expect_shape("decode_attention", "v_cache", v_cache, k_cache.shape)
    _build.expect_shape("decode_attention", "cache_seqlens", lens, (batch,))
    q, k_cache, v_cache = (_build.dense(t) for t in (q, k_cache, v_cache))
    lens = lens.to(torch.int32).contiguous()
    dev = q.device
    o_part = torch.empty((batch, hkv, num_splits, group, d),
                         dtype=torch.float32, device=dev)
    lse_part = torch.empty((batch, hkv, num_splits, group),
                           dtype=torch.float32, device=dev)
    stream = _build.stream_of(q)
    code = _build.DTYPE_CODES[q.dtype]
    fn = _build.function("decode", "mfa_decode_partials", _PARTIALS_ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), code,
            batch, num_heads, hkv, max_s, d, num_splits, tps, window_left,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, stream)
    _build.check("decode", rc)
    _build.launches["decode"] += 1
    out = torch.empty_like(q)
    lse = torch.empty((batch, num_heads), dtype=torch.float32, device=dev)
    launch_combine(o_part, lse_part, out, lse)
    return out, lse


def launch_combine(o_part, lse_part, out, lse):
    """Launch 2 (mfa_decode_combine): fp32 partials [b, hkv, splits, group,
    d] and their LSE -> out [b, hq, d] in its dtype and lse [b, hq]. Also
    the paged decode's merge (kernels/paged.py)."""
    batch, hkv, num_splits, _, d = o_part.shape
    fn = _build.function("decode", "mfa_decode_combine", _COMBINE_ARGTYPES)
    rc = fn(o_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _build.DTYPE_CODES[out.dtype], batch, out.shape[1],
            hkv, num_splits, d, _build.stream_of(out))
    _build.check("decode", rc)
    _build.launches["combine"] += 1


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
    window_left + 1 tokens (-1 = all). Returns [batch, num_heads, head_dim]
    in q's dtype (and, with return_lse, the fp32 natural-log LSE
    [batch, num_heads]). Sinks and ALiBi are not ported yet.
    """
    if sink_tokens or alibi_slopes is not None:
        raise NotImplementedError("sink_tokens and alibi_slopes are not "
                                  "ported yet")
    batch, num_heads, head_dim = q.shape
    num_kv_heads, max_s = k_cache.shape[1], k_cache.shape[2]
    if num_heads % num_kv_heads:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(head_dim))
    if num_splits <= 0:
        num_splits = default_splits(batch, num_kv_heads, max_s)
    num_splits, tps = split_layout(max_s, num_splits)
    args = (q, k_cache, v_cache, cache_seqlens, scale, num_splits, tps,
            int(window_left), float(logit_softcap))
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
