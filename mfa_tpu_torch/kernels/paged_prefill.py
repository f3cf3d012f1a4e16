"""Paged prefill attention (counterpart of mfa_tpu/kernels/paged_prefill.py).

Kernel 8 of the port: csrc/paged_prefill.cu. Query chunks attend to a
paged KV cache read in place through the block table, with a runtime
`q_start` per sequence: chunked prefill, prefix-cache suffixes and the
paged route of `flash_attn_varlen_func`. One block per (q tile, kv head,
sequence) holds all q heads of the kv head (the TPU's [group, bq] rows).
A CPU tensor runs `_paged_prefill_plain`, the same function in PyTorch.

Pages are [num_kv_heads, num_pages, page_size, head_dim]: head_dim wide,
without the TPU's 128-lane padding. int8 pages carry fp32 per-row scales;
fp8 and int4 pages, attention sinks and ALiBi are not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import softmax_scale_default
from mfa_tpu_torch.kernels import _build

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 12 + [_F, _F, _F, _P]
KERNEL_HEAD_DIMS = (64, 128)
BLOCK_ROWS = 64  # q rows per block: group * (chunk rows per tile)


def _paged_prefill_plain(q, k_pages, v_pages, k_scales, v_scales, lens,
                         q_start, q_lens, table, scale, window_left,
                         window_right, softcap):
    """The kernel's function in plain PyTorch: scores in the log2 domain,
    K scales on score columns, V scales folded into the probabilities,
    probabilities rounded to the value dtype (bf16 for int8 pages) before
    P.V. Rows r >= q_lens give O = 0 and LSE = -inf."""
    batch, sq, num_heads, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    group = num_heads // hkv
    pps = table.shape[1]
    out_dtype = q.dtype
    dev = q.device
    quantized = k_scales is not None
    idx = table.long().clamp(0, num_pages - 1)

    def gather(pages):  # [hkv, b, pps, page, ...] -> [b, hkv, pps*page, ...]
        g = pages[:, idx]
        return g.permute(1, 0, *range(2, g.ndim)).reshape(
            batch, hkv, pps * page, *pages.shape[3:])

    k, v = gather(k_pages), gather(v_pages)
    vdtype = torch.bfloat16 if quantized else v_pages.dtype
    if quantized and q.dtype == torch.float16:
        q = q.to(torch.bfloat16)  # int8 pages contract in bf16 (as on TPU)
    qg = q.float().reshape(batch, sq, hkv, group, d).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if quantized:
        s = s * gather(k_scales)[:, :, None, None, :]
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap * _LOG2E
    else:
        s = s * (scale * _LOG2E)
    row = torch.arange(sq, device=dev)
    pos = q_start.to(dev).long()[:, None] + row  # [b, sq]
    col = torch.arange(pps * page, device=dev)
    vis = (col < lens.to(dev).long()[:, None, None]) \
        & (row < q_lens.to(dev).long()[:, None])[..., None]
    if window_right >= 0:
        vis &= col <= pos[..., None] + window_right
    if window_left >= 0:
        vis &= col >= pos[..., None] - window_left
    s = s.masked_fill(~vis[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1)
    if quantized:
        p = p * gather(v_scales)[:, :, None, None, :]
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vdtype).float(), v.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (o / l_safe[..., None]).permute(0, 3, 1, 2, 4).reshape(
        batch, sq, num_heads, d).to(out_dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      (m[..., 0] + torch.log2(l_safe)) * _LN2)
    return out, lse.reshape(batch, num_heads, sq)


def _paged_prefill_cuda(q, k_pages, v_pages, k_scales, v_scales, lens,
                        q_start, q_lens, table, scale, window_left,
                        window_right, softcap):
    _build.refuse_grad("paged_prefill_attention", q, k_pages, v_pages,
                       k_scales, v_scales)
    batch, sq, num_heads, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    group = num_heads // hkv
    if d not in KERNEL_HEAD_DIMS or BLOCK_ROWS % group:
        raise NotImplementedError(
            f"the paged prefill kernel takes head_dim in {KERNEL_HEAD_DIMS} "
            f"and a q-per-kv-head group dividing {BLOCK_ROWS}")
    if k_pages.dtype == torch.int8:
        if q.dtype not in (torch.bfloat16, torch.float16):
            raise NotImplementedError("int8 pages take bf16/fp16 q")
        qk = q.to(torch.bfloat16)  # int8 pages contract in bf16 (as on TPU)
    elif k_pages.dtype == q.dtype and q.dtype in (torch.bfloat16, torch.float16):
        qk = q
    else:
        raise NotImplementedError(
            f"the paged prefill kernel takes bf16/fp16 pages of the q dtype "
            f"or int8 pages, got {k_pages.dtype} pages with {q.dtype} q")
    name = "paged_prefill_attention"
    tensors = [qk, k_pages, v_pages, lens, q_start, q_lens, table]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    _build.same_device(name, *tensors)
    _build.expect_shape(name, "v_pages", v_pages, k_pages.shape)
    for what, t in (("lengths", lens), ("q_start", q_start), ("q_lens", q_lens)):
        _build.expect_shape(name, what, t, (batch,))
    _build.expect_shape(name, "block_table", table, (batch, table.shape[1]))
    if k_scales is not None:
        _build.expect_shape(name, "k_scales", k_scales, k_pages.shape[:3])
        _build.expect_shape(name, "v_scales", v_scales, k_pages.shape[:3])
        k_scales = k_scales.float().contiguous()
        v_scales = v_scales.float().contiguous()
    qk, k_pages, v_pages = (_build.dense(t) for t in (qk, k_pages, v_pages))
    lens, q_start, q_lens, table = (t.to(torch.int32).contiguous()
                                    for t in (lens, q_start, q_lens, table))
    out = torch.empty_like(qk)
    lse = torch.empty((batch, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    fn = _build.function("paged_prefill", "mfa_paged_prefill", _ARGTYPES)
    rc = fn(qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales), lens.data_ptr(),
            q_start.data_ptr(), q_lens.data_ptr(), table.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _build.DTYPE_CODES[qk.dtype],
            _build.DTYPE_CODES[k_pages.dtype], batch, sq, num_heads, hkv,
            num_pages, page, table.shape[1], d, window_left, window_right,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, _build.stream_of(q))
    _build.check("paged_prefill", rc)
    _build.launches["paged_prefill"] += 1
    return out.to(q.dtype), lse


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    q_start: torch.Tensor,
    block_table: torch.Tensor,
    *,
    q_lens: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window_left: int = -1,
    window_right: int = -1,
    logit_softcap: float = 0.0,
    quant_dtype: Optional[str] = None,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Chunk prefill against a paged KV cache.

    q: [batch, sq, num_heads, head_dim]. k_pages/v_pages: [num_kv_heads,
    num_pages, page_size, head_dim], bf16/fp16/fp32, or int8 with
    k_scales/v_scales [num_kv_heads, num_pages, page_size] fp32.
    lengths: [batch] visible KV length (the chunk included: its K/V must be
    written to the pages first); q_start: [batch] absolute position of q
    row 0; q_lens: [batch] real q rows (default lengths - q_start);
    block_table: [batch, pages_per_seq].

    Row r of sequence b (position p = q_start[b] + r) sees columns c <
    lengths[b] with p - window_left <= c <= p + window_right (-1 =
    unbounded); causal is the window_right == 0 band. Returns [batch, sq,
    num_heads, head_dim] in q's dtype and, with return_lse, the fp32
    natural-log LSE [batch, num_heads, sq] (-inf on rows that see no
    column). Rows r >= q_lens[b] come out O = 0, LSE = -inf (unspecified
    in mfa_tpu).
    """
    if quant_dtype not in (None, "int8"):
        raise NotImplementedError(f"{quant_dtype} pages are not ported yet")
    if sink_tokens or alibi_slopes is not None:
        raise NotImplementedError("sink_tokens and alibi_slopes are not "
                                  "ported yet")
    if (k_scales is None) != (k_pages.dtype != torch.int8):
        raise ValueError("int8 pages need k_scales/v_scales, and only they")
    if k_pages.shape[-1] != q.shape[-1]:
        raise ValueError(f"page width {k_pages.shape[-1]} != head_dim "
                         f"{q.shape[-1]}")
    if q.shape[2] % k_pages.shape[0]:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    if causal:
        window_right = 0
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    lengths = torch.as_tensor(lengths, device=q.device)
    q_start = torch.as_tensor(q_start, device=q.device)
    if q_lens is None:
        q_lens = torch.clamp(lengths - q_start, min=0)
    q_lens = torch.as_tensor(q_lens, device=q.device)
    args = (q, k_pages, v_pages, k_scales, v_scales, lengths, q_start,
            q_lens, block_table, scale, int(window_left), int(window_right),
            float(logit_softcap))
    if q.device.type == "cpu":
        out, lse = _paged_prefill_plain(*args)
    elif q.device.type == "cuda":
        out, lse = _paged_prefill_cuda(*args)
    else:
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    return (out, lse) if return_lse else out
