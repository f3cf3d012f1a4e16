"""Paged prefill attention (counterpart of mfa_tpu/kernels/paged_prefill.py).

Kernel 8 of the port: csrc/paged_prefill.cu. Query chunks attend to a
paged KV cache read in place through the block table, with a runtime
`q_start` per sequence: chunked prefill, prefix-cache suffixes and the
paged route of `flash_attn_varlen_func`. One warp-specialised wgmma block
per (q tile, kv head, head chunk, sequence) holds two consumer warpgroups
of 64 rows: 64 / group chunk positions each (rounded down) of every q head
of the kv head (the TPU's [group, bq] rows), with K and V brought by TMA
in boxes of gcd(page_size, tile) rows through the block table. Any group
of q heads a kv head: one that does not divide 64 (Qwen2-7B's 7) leaves
64 % group dead tail rows a warpgroup, which are never stored; above 64
(Falcon-7B's 71) a warpgroup holds 64 q heads of one position, the grid
takes ceil(group / 64) head chunks, and the last chunk's rows past the
group are that dead tail.
A CPU tensor runs `_paged_prefill_plain`, the same function in PyTorch.

Pages are [num_kv_heads, num_pages, page_size, w]: rows of w features
(int4: w / 2 bytes of feature pairs, kernels/quant.py:pack_int4), w the
head-dim plan's stored width as the cache creates them, or head_dim
itself (kernels/paged.py), without the TPU's 128-lane padding. Any
head_dim up to 256: q is zero-padded to the pages' width and the output
sliced back; the softmax scale is the true head_dim's. int8, fp8 (e4m3) and int4 pages carry
fp32 per-row scales. With a left window the first `sink_tokens` columns
stay visible (the kernel lists their tiles ahead of the band); ALiBi uses
the chunk's absolute positions. Pages
of any row count (int4: an even one). fp32 q runs the fp32
tile (csrc/paged_prefill.cu: af32::paged_prefill_kernel, 64 packed rows a
block; launch name `paged_prefill_fp32`) on fp32 pages, or on quantized
pages with q . k in fp32 and p rounded to bf16 for P.V.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (head_dim_plan, pad_features,
                                           softmax_scale_default,
                                           unpad_features)
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels.paged import launch_name, quant_q, stored_pages
from mfa_tpu_torch.kernels.prefill import check_band_options, cuda_slopes
from mfa_tpu_torch.kernels.quant import (page_features, page_format,
                                         page_values)

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 13 + [_F, _F, _F, _I, _P, _P]


def _paged_prefill_plain(q, k_pages, v_pages, k_scales, v_scales, lens,
                         q_start, q_lens, table, scale, window_left,
                         window_right, softcap, quant_dtype=None, sinks=0,
                         alibi=None, matmul=torch.matmul):
    """The kernel's function in plain PyTorch: scores in the log2 domain,
    K scales on score columns, ALiBi at the chunk's absolute positions
    (slopes [hq]), V scales folded into the probabilities,
    probabilities rounded to the value dtype (bf16 for quantized pages)
    before P.V (int4 pages unpacked, fp8 converted exactly). Rows r >=
    q_lens give O = 0 and LSE = -inf. q is zero-padded to the pages'
    features, O sliced back. `matmul` forms the two products (the tests
    pass kernels/backward.py:_matmul_3xtf32_plain)."""
    d_true = q.shape[-1]
    q = pad_features(q, page_features(quant_dtype, k_pages))
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
            batch, hkv, pps * page, *g.shape[4:])

    k, v = (page_values(gather(p), quant_dtype) for p in (k_pages, v_pages))
    vdtype = torch.bfloat16 if quantized else v_pages.dtype
    if quantized and q.dtype == torch.float16:
        # fp16 q contracts against quantized pages in bf16 (as on TPU); fp32
        # q stays fp32 (mfa_tpu/kernels/paged_prefill.py:440-441)
        q = q.to(torch.bfloat16)
    qg = q.float().reshape(batch, sq, hkv, group, d).permute(0, 2, 3, 1, 4)
    cols = pps * page
    s = matmul(qg.reshape(batch, hkv, group * sq, d), k.float().transpose(-1, -2)
               ).reshape(batch, hkv, group, sq, cols)
    if quantized:
        s = s * gather(k_scales)[:, :, None, None, :]
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap * _LOG2E
    else:
        s = s * (scale * _LOG2E)
    row = torch.arange(sq, device=dev)
    pos = q_start.to(dev).long()[:, None] + row  # [b, sq]
    col = torch.arange(cols, device=dev)
    if alibi is not None:  # [b, sq, cols] distances, log2 domain
        dist = (pos[..., None] - col).abs().float()
        s = s - (alibi.float().to(dev) * _LOG2E).reshape(1, hkv, group, 1, 1) \
            * dist[:, None, None]
    vis = (col < lens.to(dev).long()[:, None, None]) \
        & (row < q_lens.to(dev).long()[:, None])[..., None]
    if window_right >= 0:
        vis &= col <= pos[..., None] + window_right
    if window_left >= 0:
        vis &= (col >= pos[..., None] - window_left) | (col < sinks)
    s = s.masked_fill(~vis[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1)
    if quantized:
        p = p * gather(v_scales)[:, :, None, None, :]
    o = matmul(p.to(vdtype).float().reshape(batch, hkv, group * sq, cols), v.float()
               ).reshape(batch, hkv, group, sq, d)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (o / l_safe[..., None]).permute(0, 3, 1, 2, 4).reshape(
        batch, sq, num_heads, d)[..., :d_true].to(out_dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      (m[..., 0] + torch.log2(l_safe)) * _LN2)
    return out, lse.reshape(batch, num_heads, sq)


def cuda_plan(q, k_pages, quant_dtype=None):
    """What the card's route checks before it touches a device or a
    kernel -> the head-dim plan: any head_dim up to 256 (ValueError
    above) and num_heads a multiple of num_kv_heads, as mfa_tpu checks;
    any group and page size."""
    num_heads, d = q.shape[2], q.shape[3]
    if num_heads % k_pages.shape[0]:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    return head_dim_plan(d, quant_dtype)


def _paged_prefill_cuda(q, k_pages, v_pages, k_scales, v_scales, lens,
                        q_start, q_lens, table, scale, window_left,
                        window_right, softcap, quant_dtype=None, sinks=0,
                        alibi=None):
    _build.refuse_grad("paged_prefill_attention", q, k_pages, v_pages,
                       k_scales, v_scales)
    plan = cuda_plan(q, k_pages, quant_dtype)
    batch, sq, num_heads, _ = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    qk = quant_q(q, k_pages, quant_dtype, "paged prefill")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages dtypes differ")
    k_pages, v_pages = (stored_pages(p, quant_dtype, plan.head_dim)
                        for p in (k_pages, v_pages))
    d = plan.stored
    qk = pad_features(qk, d)
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
        k_scales = _build.dense(k_scales.float())
        v_scales = _build.dense(v_scales.float())
    qk, k_pages, v_pages = (_build.dense(t) for t in (qk, k_pages, v_pages))
    lens, q_start, q_lens, table = (t.to(torch.int32).contiguous()
                                    for t in (lens, q_start, q_lens, table))
    slopes = cuda_slopes(alibi, 1.0 / scale, num_heads, q.device)
    out = torch.empty_like(qk)
    lse = torch.empty((batch, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    fn = _build.function("paged_prefill", "mfa_paged_prefill", _ARGTYPES)
    rc = fn(qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _build.ptr(k_scales), _build.ptr(v_scales), lens.data_ptr(),
            q_start.data_ptr(), q_lens.data_ptr(), table.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _build.DTYPE_CODES[qk.dtype],
            _build.kv_code(quant_dtype, k_pages), batch, sq, num_heads, hkv,
            num_pages, page, table.shape[1], d, plan.kernel_dim, window_left,
            window_right,
            _LOG2E if softcap else scale * _LOG2E, float(softcap),
            scale / softcap if softcap else 0.0, sinks, _build.ptr(slopes),
            _build.stream_of(q))
    _build.check("paged_prefill", rc)
    _build.launches[launch_name("paged_prefill", quant_dtype, 1, qk.dtype)] += 1
    return unpad_features(out, plan.head_dim).to(q.dtype), lse


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
    num_pages, page_size, head_dim], bf16/fp16/fp32, or quantized with
    k_scales/v_scales [num_kv_heads, num_pages, page_size] fp32: int8,
    fp8 (float8_e4m3fn) or int4 (quant_dtype="int4": int8 bytes [...,
    head_dim / 2]); quant_dtype None takes int8 or fp8 from the dtype.
    lengths: [batch] visible KV length (the chunk included: its K/V must be
    written to the pages first); q_start: [batch] absolute position of q
    row 0; q_lens: [batch] real q rows (default lengths - q_start);
    block_table: [batch, pages_per_seq].

    Row r of sequence b (position p = q_start[b] + r) sees columns c <
    lengths[b] with p - window_left <= c <= p + window_right (-1 =
    unbounded), or c < sink_tokens with a left window; causal is the
    window_right == 0 band. alibi_slopes [num_heads]: - slope_h * |p - c|
    (not with logit_softcap). Returns [batch, sq,
    num_heads, head_dim] in q's dtype and, with return_lse, the fp32
    natural-log LSE [batch, num_heads, sq] (-inf on rows that see no
    column). Rows r >= q_lens[b] come out O = 0, LSE = -inf (unspecified
    in mfa_tpu).
    """
    sinks, _ = check_band_options(int(window_left), sink_tokens)
    if alibi_slopes is not None and logit_softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    fmt = page_format(quant_dtype, k_pages, k_scales, q.shape[-1])
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
            float(logit_softcap), fmt, sinks, alibi_slopes)
    if q.device.type == "cpu":
        out, lse = _paged_prefill_plain(*args)
    elif q.device.type == "cuda":
        out, lse = _paged_prefill_cuda(*args)
    else:
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    return (out, lse) if return_lse else out
