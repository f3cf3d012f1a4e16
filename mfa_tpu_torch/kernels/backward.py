"""Flash-attention backward (counterpart of mfa_tpu/kernels/backward.py).

Kernels 11-14 of the port, the five launches of csrc/backward.cu, all on
the warp-specialised wgmma + TMA kernels of csrc/flash_bwd_sm90.cuh:
`mfa_bwd_fused` (kernel 11: dQ, dK and dV in one pass, dQ summed across
blocks in fp32); the deterministic split, `mfa_bwd_dkv` (kernel 12: the
same kernel without its dQ step) then `mfa_bwd_dq` (kernel 13: a dQ
kernel shaped like the forward's tile, 128 q rows a block walking the
band's key tiles); and the same split on the packed layout,
`mfa_varlen_bwd_dkv` + `mfa_varlen_bwd_dq` (kernel 14), which on equal
lengths gives kernel 12 + 13's bits. Each recomputes P from the forward's
natural-log LSE:

    delta = rowsum(dO * O)                      (fp32 PyTorch, as in JAX)
    P  = exp(S - LSE)   with S the scaled (softcapped) logits
    dV = P^T dO    dS = P * (dO V^T - delta) * scale (* (1 - tanh^2))
    dK = dS^T Q    dQ = dS K

Rows whose LSE is -inf saw no column in the forward: P = 0 and their
gradients are zero. dK/dV are summed over the GQA group. A CUDA tensor
runs the kernels (bf16/fp16, head_dim 64 or 128) or raises; a CPU tensor
runs `_bwd_plain` / `_varlen_bwd_plain`, the same function in fp32
PyTorch (the counterpart of autodiff._bwd_jnp_reference).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import softmax_scale_default
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels.prefill import KERNEL_HEAD_DIMS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DENSE_TAIL = [_I] * 9 + [_F, _F, _P]  # dtype .. window_right, scale, cap, stream
_FUSED_ARGTYPES = [_P] * 9 + _DENSE_TAIL
_DKV_ARGTYPES = [_P] * 8 + _DENSE_TAIL
_DQ_ARGTYPES = [_P] * 7 + _DENSE_TAIL
_VL_DKV_ARGTYPES = [_P] * 10 + [_I] * 10 + [_F, _F, _P]
_VL_DQ_ARGTYPES = [_P] * 9 + [_I] * 10 + [_F, _F, _P]


def _band_mask(sq, sk, window_left, window_right, device):
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if window_right >= 0:
        mask &= col <= row + window_right
    if window_left >= 0:
        mask &= col >= row - window_left
    return mask


def _bwd_plain(q, k, v, out, lse, do, scale, window_left, window_right,
               softcap):
    """fp32 reference of the kernels on [b, h, s, d]: P from the saved
    LSE, zero on dead rows; returns (dq, dk, dv) in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)
    dcap = None
    if softcap:
        t = torch.tanh(s * (scale / softcap))
        s, dcap = t * softcap, 1.0 - t * t
    else:
        s = s * scale
    live = torch.isfinite(lse)[..., None] & _band_mask(
        sq, sk, window_left, window_right, q.device)
    lse_f = torch.where(torch.isfinite(lse), lse, torch.zeros((), device=q.device))
    p = torch.where(live, torch.exp(s - lse_f[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    if dcap is not None:
        ds = ds * dcap
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _varlen_bwd_plain(q, k, v, out, lse, do, cu_q, cu_k, scale, window_left,
                      window_right, softcap):
    """fp32 reference of the varlen kernels: `_bwd_plain` on each packed
    sequence (LSE [hq, total_q])."""
    cq, ck = cu_q.tolist(), cu_k.tolist()
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for i in range(len(cq) - 1):
        qs, ks = slice(cq[i], cq[i + 1]), slice(ck[i], ck[i + 1])

        def bh(x, sl):  # [n, h, d] -> [1, h, n, d]
            return x[sl].transpose(0, 1)[None]

        g = _bwd_plain(bh(q, qs), bh(k, ks), bh(v, ks), bh(out, qs),
                       lse[:, qs][None], bh(do, qs), scale, window_left,
                       window_right, softcap)
        dq[qs], dk[ks], dv[ks] = (x[0].transpose(0, 1) for x in g)
    return dq, dk, dv


def _check_kernel_inputs(name, q, k, v, out, do, *others):
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(f"{name}: the kernels take bf16/fp16, got "
                                  f"{q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"{name}: the kernels take head_dim in "
                                  f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    _build.same_device(name, q, k, v, out, do, *others)
    if any(t.dtype != q.dtype for t in (k, v, out, do)):
        raise ValueError(f"{name}: q, k, v, out and do must share one dtype")


def _launch_fused(q, k, v, do, lse, delta, scale, wl, wr, softcap):
    """mfa_bwd_fused on dense [b, h, s, d] inputs (all _build.dense) ->
    (dq fp32 workspace, dk, dv)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq_ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_bwd_fused", _FUSED_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_ws.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d,
            wl, wr, scale, softcap, _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches["bwd_fused"] += 1
    return dq_ws, dk, dv


def _launch_dkv(q, k, v, do, lse, delta, scale, wl, wr, softcap):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_bwd_dkv", _DKV_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d, wl, wr, scale,
            softcap, _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches["bwd_dkv"] += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, scale, wl, wr, softcap):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    fn = _build.function("backward", "mfa_bwd_dq", _DQ_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d, wl, wr, scale,
            softcap, _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches["bwd_dq"] += 1
    return dq


def _dense_cuda_inputs(q, k, v, out, lse, do):
    """Checked, dense kernel inputs and delta = rowsum(dO * O) in fp32."""
    name = "flash_attention_bwd"
    _check_kernel_inputs(name, q, k, v, out, do, lse)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _build.expect_shape(name, "k", k, (b, hkv, sk, d))
    _build.expect_shape(name, "v", v, k.shape)
    _build.expect_shape(name, "out", out, q.shape)
    _build.expect_shape(name, "do", do, q.shape)
    _build.expect_shape(name, "lse", lse, (b, hq, sq))
    q, k, v, do = (_build.dense(t) for t in (q, k, v, do))
    delta = (do.float() * out.float()).sum(-1).contiguous()
    return q, k, v, do, _build.dense(lse.float()), delta


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    logit_softcap: float = 0.0,
    fused: Optional[bool] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink_tokens: int = 0,
    kv_position_offset: int = 0,
):
    """-> (dq, dk, dv) on the [b, h, s, d] layout, in the inputs' dtypes.

    q, do, out: [b, hq, sq, d]; k, v: [b, hkv, sk, d]; lse: [b, hq, sq]
    fp32 natural-log LSE from the forward (-inf on rows that saw no
    column). Causal is top-left (window_right = 0); window_size is (left,
    right) around each row, -1 = unbounded; logit_softcap as in the
    forward.

    fused: None or True runs the one-pass kernel (mfa_bwd_fused: dQ summed
    across blocks in fp32 in no fixed order, so it varies in the last bits
    between runs); False runs
    the deterministic two-launch split (mfa_bwd_dkv, then mfa_bwd_dq), the
    A/B reference. The JAX auto rule is a VMEM budget for full-length dK/dV
    accumulators; the Hopper fused kernel holds one key tile's accumulators
    per block, so that budget has no counterpart and None means fused.
    ALiBi, attention sinks and kv_position_offset are not ported yet.
    """
    if alibi_slopes is not None or sink_tokens or kv_position_offset:
        raise NotImplementedError(
            "alibi_slopes, sink_tokens and kv_position_offset are not "
            "ported yet")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    wl, wr = (int(w) for w in window_size)
    if causal:
        wr = 0
    softcap = float(logit_softcap)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, do, scale, wl, wr, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    q, k, v, do, lse, delta = _dense_cuda_inputs(q, k, v, out, lse, do)
    args = (q, k, v, do, lse, delta, scale, wl, wr, softcap)
    if fused is None or fused:
        dq_ws, dk, dv = _launch_fused(*args)
        return dq_ws.to(q.dtype), dk, dv
    dk, dv = _launch_dkv(*args)
    return _launch_dq(*args), dk, dv


def _varlen_cuda_inputs(q, k, v, out, lse, do, cu_q, cu_k):
    name = "varlen_attention_bwd"
    _check_kernel_inputs(name, q, k, v, out, do, lse, cu_q, cu_k)
    total_q, hq, d = q.shape
    _build.expect_shape(name, "v", v, k.shape)
    _build.expect_shape(name, "out", out, q.shape)
    _build.expect_shape(name, "do", do, q.shape)
    _build.expect_shape(name, "lse", lse, (hq, total_q))
    _build.expect_shape(name, "cu_seqlens_k", cu_k, cu_q.shape)
    q, k, v, do = (_build.dense(t) for t in (q, k, v, do))
    delta = (do.float() * out.float()).sum(-1).t().contiguous()  # [hq, total_q]
    return q, k, v, do, _build.dense(lse.float()), delta


def _launch_varlen_dkv(q, k, v, do, lse, delta, cu_q, cu_k, max_sk, scale,
                       wl, wr, softcap):
    total_q, hq, d = q.shape
    total_k, hkv = k.shape[:2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_varlen_bwd_dkv", _VL_DKV_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            cu_q.data_ptr(), cu_k.data_ptr(), _build.DTYPE_CODES[q.dtype],
            cu_q.shape[0] - 1, hq, hkv, total_q, total_k, int(max_sk), d, wl,
            wr, scale, softcap, _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches["varlen_bwd_dkv"] += 1
    return dk, dv


def _launch_varlen_dq(q, k, v, do, lse, delta, cu_q, cu_k, max_sq, scale,
                      wl, wr, softcap):
    total_q, hq, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("backward", "mfa_varlen_bwd_dq", _VL_DQ_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), cu_q.data_ptr(),
            cu_k.data_ptr(), _build.DTYPE_CODES[q.dtype], cu_q.shape[0] - 1,
            hq, k.shape[1], total_q, k.shape[0], int(max_sq), d, wl, wr,
            scale, softcap, _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches["varlen_bwd_dq"] += 1
    return dq


def varlen_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    logit_softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
):
    """-> (dq, dk, dv) on the packed [total, h, d] layout.

    q, do, out: [total_q, hq, d]; k, v: [total_k, hkv, d]; lse: [hq,
    total_q] (the varlen forward's return_lse layout); cu_seqlens_q/k:
    [batch + 1], total_q == cu_seqlens_q[-1] and total_k ==
    cu_seqlens_k[-1] (the kernels store the sequences' rows and no
    other). Causal and the window act on positions local to each
    sequence, top-left aligned, as in the forward. max_seqlen_q/k bound
    the sequences' lengths (the kernels' grids); when None they are read
    from cu_seqlens. Runs the split (mfa_varlen_bwd_dkv, then
    mfa_varlen_bwd_dq), as the JAX varlen backward does. ALiBi is not
    ported yet.
    """
    if alibi_slopes is not None:
        raise NotImplementedError("alibi_slopes is not ported yet")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    wl, wr = (int(w) for w in window_size)
    if causal:
        wr = 0
    softcap = float(logit_softcap)
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    if q.device.type == "cpu":
        return _varlen_bwd_plain(q, k, v, out, lse, do, cu_q, cu_k, scale, wl,
                                 wr, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"varlen_attention_bwd: unsupported device {q.device}")
    if max_seqlen_q is None:
        max_seqlen_q = int((cu_q[1:] - cu_q[:-1]).max()) if cu_q.numel() > 1 else 0
    if max_seqlen_k is None:
        max_seqlen_k = int((cu_k[1:] - cu_k[:-1]).max()) if cu_k.numel() > 1 else 0
    cu_q, cu_k = cu_q.contiguous(), cu_k.contiguous()
    q, k, v, do, lse, delta = _varlen_cuda_inputs(q, k, v, out, lse, do, cu_q,
                                                  cu_k)
    dk, dv = _launch_varlen_dkv(q, k, v, do, lse, delta, cu_q, cu_k,
                                max_seqlen_k, scale, wl, wr, softcap)
    dq = _launch_varlen_dq(q, k, v, do, lse, delta, cu_q, cu_k, max_seqlen_q,
                           scale, wl, wr, softcap)
    return dq, dk, dv
