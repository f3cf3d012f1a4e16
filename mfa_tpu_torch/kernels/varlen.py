"""Packed variable-length attention (counterpart of mfa_tpu/kernels/varlen.py).

Kernel 7 of the port: the `mfa_varlen_fwd` launch of csrc/prefill.cu, on
kernel 1's warp-specialised wgmma + TMA tile (csrc/flash_fwd_sm90.cuh)
with strided tensor maps over the packed rows. The grid is (q head,
sequence, q tile of max_seqlen_q); each block reads its sequence's offsets
from cu_seqlens and leaves when its tile lies past that sequence, as the
original CUDA library did; on equal lengths it gives kernel 1's bits.
The TPU kernel's segment-id masks, prefetched per-q-block KV bounds and
zero-shift fast path exist because a TPU grid is static; the classic
algorithm here computes the same function exactly.
A CPU tensor runs `_varlen_plain` (kernel 1's plain version per sequence).

With block_table, k/v are a paged pool and the call goes to the paged
prefill kernel (kernels/paged_prefill.py), after gathering only the
batch's pages, as mfa_tpu does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import softmax_scale_default
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.prefill import PREFILL_HEAD_DIMS, _prefill_plain

_LOG2E = math.log2(math.e)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 10 + [_F, _F, _F, _P]


def _varlen_plain(q, k, v, cu_q, cu_k, scale, window_left, window_right,
                  softcap, return_lse):
    """fp32 reference of the kernel: kernel 1's plain version on each
    sequence, LSE in flash-attn's varlen layout [num_heads, total_q]."""
    cq, ck = cu_q.tolist(), cu_k.tolist()
    outs, lses = [], []
    for b in range(len(cq) - 1):
        qb = q[cq[b]:cq[b + 1]].transpose(0, 1)[None]  # [1, hq, sq, d]
        kb = k[ck[b]:ck[b + 1]].transpose(0, 1)[None]
        vb = v[ck[b]:ck[b + 1]].transpose(0, 1)[None]
        o, lse = _prefill_plain(qb, kb, vb, scale, window_left, window_right,
                                softcap, True)
        outs.append(o[0].transpose(0, 1))
        lses.append(lse[0])
    out = torch.cat(outs)
    return (out, torch.cat(lses, dim=1)) if return_lse else out


def _varlen_cuda(q, k, v, cu_q, cu_k, max_seqlen_q, scale, window_left,
                 window_right, softcap, return_lse):
    _build.refuse_grad("varlen_attention", q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"the varlen kernel takes bf16/fp16, got {q.dtype}")
    total_q, hq, d = q.shape
    hkv = k.shape[1]
    if d not in PREFILL_HEAD_DIMS:
        raise NotImplementedError(f"the varlen kernel takes head_dim in "
                                  f"{PREFILL_HEAD_DIMS}, got {d}")
    name = "varlen_attention"
    _build.same_device(name, q, k, v, cu_q, cu_k)
    _build.expect_shape(name, "v", v, k.shape)
    _build.expect_shape(name, "cu_seqlens_k", cu_k, cu_q.shape)
    q, k, v = _build.dense(q), _build.dense(k), _build.dense(v)
    out = torch.empty_like(q)
    lse = (torch.empty((hq, total_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _build.function("prefill", "mfa_varlen_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), cu_q.data_ptr(), cu_k.data_ptr(),
            _build.DTYPE_CODES[q.dtype], cu_q.shape[0] - 1, hq, hkv, total_q,
            k.shape[0], int(max_seqlen_q), d, window_left, window_right,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, _build.stream_of(q))
    _build.check("prefill", rc)
    _build.launches["varlen"] += 1
    return (out, lse) if return_lse else out


def _paged_route(q, k_pool, v_pool, cu_q, cu_k, max_seqlen_q, block_table,
                 scale, window_left, window_right, softcap, return_lse):
    """Unpack q per sequence and run the paged prefill kernel on a pool of
    only the batch's pages (mfa_tpu/kernels/varlen.py:289-339)."""
    total_q, hq, d = q.shape
    batch = cu_q.shape[0] - 1
    dev = q.device
    lens_q = (cu_q[1:] - cu_q[:-1]).to(torch.int32)
    lens_k = (cu_k[1:] - cu_k[:-1]).to(torch.int32)
    seg = torch.repeat_interleave(torch.arange(batch, device=dev),
                                  lens_q.long(), output_size=total_q)
    pos = torch.arange(total_q, device=dev) - cu_q.long()[seg]
    q_pad = q.new_zeros((batch, int(max_seqlen_q), hq, d))
    q_pad[seg, pos] = q
    pps = block_table.shape[1]
    flat = block_table.to(dev).long().reshape(-1)
    # [b*pps, page, hkv, d] -> kernel layout [hkv, b*pps, page, d]
    pool = k_pool[flat].permute(2, 0, 1, 3)
    pool_v = v_pool[flat].permute(2, 0, 1, 3)
    dense_table = torch.arange(batch * pps, dtype=torch.int32,
                               device=dev).reshape(batch, pps)
    out4 = paged_prefill_attention(
        q_pad, pool, pool_v, lens_k, torch.zeros_like(lens_k), dense_table,
        q_lens=lens_q, causal=False, softmax_scale=scale,
        window_left=window_left, window_right=window_right,
        logit_softcap=softcap, return_lse=return_lse)
    if return_lse:
        out4, lse4 = out4  # [b, hq, max_sq] -> [hq, total_q]
        return out4[seg, pos], lse4[seg, :, pos].transpose(0, 1)
    return out4[seg, pos]


def varlen_attention(
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
    logit_softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    window_size: tuple = (-1, -1),
    sink_tokens: int = 0,
    return_lse: bool = False,
):
    """Packed varlen attention.

    q: [total_q, num_heads, head_dim]; k/v: [total_k, num_kv_heads,
    head_dim], or with block_table ([batch, pages_per_seq]) a paged pool
    [num_pages, page_size, num_kv_heads, head_dim]. cu_seqlens_q/k:
    [batch + 1] cumulative lengths; total_q == cu_seqlens_q[-1] and
    max_seqlen_q bounds every sequence's q length (flash-attn's contract).
    Causal is top-left aligned per sequence (row r sees columns <= r, for
    lens_k != lens_q too); window_size (left, right) counts from each
    row's own position, -1 = unbounded. A row that sees no column gives
    O = 0 (LSE -inf). Returns [total_q, num_heads, head_dim] and, with
    return_lse, the fp32 natural-log LSE [num_heads, total_q].
    ALiBi and attention sinks are not ported yet.
    """
    if alibi_slopes is not None or sink_tokens:
        raise NotImplementedError("alibi_slopes and sink_tokens are not "
                                  "ported yet")
    if q.shape[1] % k.shape[-2]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[-2]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    window_left, window_right = (int(w) for w in window_size)
    if causal:
        window_right = 0
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    if block_table is not None:
        return _paged_route(q, k, v, cu_q, cu_k, max_seqlen_q, block_table,
                            scale, window_left, window_right,
                            float(logit_softcap), return_lse)
    if q.device.type == "cpu":
        return _varlen_plain(q, k, v, cu_q, cu_k, scale, window_left,
                             window_right, float(logit_softcap), return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"varlen_attention: unsupported device {q.device}")
    return _varlen_cuda(q, k, v, cu_q.contiguous(), cu_k.contiguous(),
                        max_seqlen_q, scale, window_left, window_right,
                        float(logit_softcap), return_lse)
