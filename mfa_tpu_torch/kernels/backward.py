"""Flash-attention backward (counterpart of mfa_tpu/kernels/backward.py).

Kernels 11-14 of the port, the five launches of csrc/backward.cu, on bf16
and fp16 inputs all on the warp-specialised wgmma + TMA kernels of
csrc/flash_bwd_sm90.cuh (fp32 inputs: the mma.sync 3xTF32 tile of
csrc/flash_bwd_f32.cuh, launch names `<name>_fp32`):
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
gradients are zero. dK/dV are summed over the GQA group. The forward's
band options carry over: `kv_position_offset` (kernels 11-13), attention
sinks (kernel 11 only: the split refuses them, as mfa_tpu does) and ALiBi
(every launch; P's exponent gets - slope * |position - key|, and the
slopes' own gradient is zero). A CUDA tensor runs the kernels
(bf16/fp16/fp32, any head_dim up to 256: the head-dim plan's D
of 64, 128 or 256, dispatch/config.py:head_dim_plan; q, k, v and dO are
copied zero-padded only where a row's bytes are not a multiple of 16, and
dQ, dK and dV come back at the caller's head_dim; zero features change
neither delta = rowsum(dO * O) nor P) or raises; a CPU tensor runs
`_bwd_plain` / `_varlen_bwd_plain`, the same function in fp32 PyTorch
(the counterpart of autodiff._bwd_jnp_reference). `_split_tf32_plain` and
`_matmul_3xtf32_plain` emulate the fp32 tile's products for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (head_dim_plan, pad_features,
                                           softmax_scale_default,
                                           unpad_features)
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels.prefill import (_LOG2E, _band, alibi_bias,
                                           check_band_options, cuda_slopes)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# dtype, b, hq, hkv, sq, sk, d, D, window_left, window_right, scale, cap,
# then (fused) sinks, kv_off, slopes, stream
_DENSE_TAIL = [_I] * 10 + [_F, _F]
_FUSED_ARGTYPES = [_P] * 9 + _DENSE_TAIL + [_I, _I, _P, _P]
_DKV_ARGTYPES = [_P] * 8 + _DENSE_TAIL + [_I, _P, _P]
_DQ_ARGTYPES = [_P] * 7 + _DENSE_TAIL + [_I, _P, _P]
_VL_DKV_ARGTYPES = [_P] * 10 + [_I] * 11 + [_F, _F, _P, _P]
_VL_DQ_ARGTYPES = [_P] * 9 + [_I] * 11 + [_F, _F, _P, _P]


def _split_tf32_plain(x):
    """fp32 x -> (hi, lo), each a TF32 value (10 mantissa bits) in fp32:
    hi rounds x to nearest with ties away from zero on the bit pattern, as
    `cvt.rna.tf32.f32` does, and lo is x - hi cut to its TF32 bits, as the
    tensor core reads an fp32 register passed whole (csrc/tf32.cuh:split),
    so hi + lo is within 2^-21 of x relative (finite x)."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = (x.float() - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def _matmul_3xtf32_plain(a, b):
    """a @ b as the fp32 tiles (csrc/flash_fwd_f32.cuh, flash_bwd_f32.cuh)
    form each product: the TF32 parts of both operands, lo.hi + hi.lo +
    hi.hi in fp32 (the small terms first), lo.lo dropped."""
    (ah, al), (bh, bl) = (_split_tf32_plain(x) for x in (a, b))
    return (al @ bh + ah @ bl) + ah @ bh


def _bwd_plain(q, k, v, out, lse, do, scale, window_left, window_right,
               softcap, sinks=0, kv_off=0, alibi=None, matmul=torch.matmul):
    """fp32 reference of the kernels on [b, h, s, d]: P from the saved
    LSE, zero on dead rows, under the forward's band (sinks, kv_off) and
    ALiBi bias; returns (dq, dk, dv) in the inputs' dtypes. `matmul` forms
    the five products (the tests pass `_matmul_3xtf32_plain`)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = matmul(qf, kf.transpose(-1, -2))
    dcap = None
    if softcap:
        t = torch.tanh(s * (scale / softcap))
        s, dcap = t * softcap, 1.0 - t * t
    else:
        s = s * scale
    if alibi is not None:
        s = s + alibi_bias(alibi.to(q.device),
                           torch.arange(sq, device=q.device) + kv_off,
                           torch.arange(sk, device=q.device))
    live = torch.isfinite(lse)[..., None] & _band(
        sq, sk, window_left, window_right, q.device, sinks, kv_off)[0]
    lse_f = torch.where(torch.isfinite(lse), lse, torch.zeros((), device=q.device))
    p = torch.where(live, torch.exp(s - lse_f[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    dv = matmul(p.transpose(-1, -2), dof)
    ds = p * (matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    if dcap is not None:
        ds = ds * dcap
    dq = matmul(ds, kf)
    dk = matmul(ds.transpose(-1, -2), qf)
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _varlen_bwd_plain(q, k, v, out, lse, do, cu_q, cu_k, scale, window_left,
                      window_right, softcap, alibi=None, matmul=torch.matmul):
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
                       window_right, softcap, alibi=alibi, matmul=matmul)
        dq[qs], dk[ks], dv[ks] = (x[0].transpose(0, 1) for x in g)
    return dq, dk, dv


def _check_kernel_inputs(name, q, k, v, out, do, *others):
    """What the card's route checks before it touches a device or a kernel
    -> the head-dim plan (ValueError above 256)."""
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(f"{name}: the kernels take bf16/fp16/fp32, "
                                  f"got {q.dtype}")
    plan = head_dim_plan(q.shape[-1])
    _build.same_device(name, q, k, v, out, do, *others)
    if any(t.dtype != q.dtype for t in (k, v, out, do)):
        raise ValueError(f"{name}: q, k, v, out and do must share one dtype")
    return plan


def _stored(plan, *tensors):
    """Dense kernel inputs at the plan's stored width."""
    return tuple(_build.dense(pad_features(t, plan.stored)) for t in tensors)


def _launch_fused(q, k, v, do, lse, delta, scale, wl, wr, softcap, sinks=0,
                  kv_off=0, slopes=None):
    """mfa_bwd_fused on dense [b, h, s, d] inputs at a stored width d (all
    _build.dense; slopes [hq] log2-domain ALiBi or None) -> (dq fp32
    workspace, dk, dv). Every launch below runs d at head_dim_plan(d)'s
    kernel D: a stored width is its own plan's."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq_ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_bwd_fused", _FUSED_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_ws.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d,
            head_dim_plan(d).kernel_dim, wl, wr, scale, softcap, sinks, kv_off,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches[_build.launch_key("bwd_fused", q.dtype)] += 1
    return dq_ws, dk, dv


def _launch_dkv(q, k, v, do, lse, delta, scale, wl, wr, softcap, kv_off=0,
                slopes=None):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_bwd_dkv", _DKV_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d,
            head_dim_plan(d).kernel_dim, wl, wr, scale, softcap, kv_off,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches[_build.launch_key("bwd_dkv", q.dtype)] += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, scale, wl, wr, softcap, kv_off=0,
               slopes=None):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    fn = _build.function("backward", "mfa_bwd_dq", _DQ_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d,
            head_dim_plan(d).kernel_dim, wl, wr, scale, softcap, kv_off,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches[_build.launch_key("bwd_dq", q.dtype)] += 1
    return dq


def _dense_cuda_inputs(q, k, v, out, lse, do):
    """Checked, dense kernel inputs at the head-dim plan's stored width, and
    delta = rowsum(dO * O) in fp32."""
    name = "flash_attention_bwd"
    plan = _check_kernel_inputs(name, q, k, v, out, do, lse)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _build.expect_shape(name, "k", k, (b, hkv, sk, d))
    _build.expect_shape(name, "v", v, k.shape)
    _build.expect_shape(name, "out", out, q.shape)
    _build.expect_shape(name, "do", do, q.shape)
    _build.expect_shape(name, "lse", lse, (b, hq, sq))
    delta = (do.float() * out.float()).sum(-1).contiguous()
    q, k, v, do = _stored(plan, q, k, v, do)
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
    sink_tokens, alibi_slopes and kv_position_offset as in the forward
    (prefill_attention); sinks need the fused kernel (fused=False raises,
    as in mfa_tpu).
    """
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    wl, wr = (int(w) for w in window_size)
    if causal:
        wr = 0
    sinks, kv_off = check_band_options(wl, sink_tokens, kv_position_offset)
    softcap = float(logit_softcap)
    if alibi_slopes is not None and softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    if sinks and fused is False:
        raise NotImplementedError(
            "attention-sink backward requires the fused single-pass kernel "
            "(fused=False was forced)")
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, do, scale, wl, wr, softcap,
                          sinks, kv_off, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    d = q.shape[-1]
    q, k, v, do, lse, delta = _dense_cuda_inputs(q, k, v, out, lse, do)
    slopes = cuda_slopes(alibi_slopes, _LOG2E, q.shape[1], q.device)
    args = (q, k, v, do, lse, delta, scale, wl, wr, softcap)
    if fused is None or fused:
        dq_ws, dk, dv = _launch_fused(*args, sinks, kv_off, slopes)
        dq = dq_ws.to(q.dtype)
    else:
        dk, dv = _launch_dkv(*args, kv_off, slopes)
        dq = _launch_dq(*args, kv_off, slopes)
    return tuple(unpad_features(g, d) for g in (dq, dk, dv))


def _varlen_cuda_inputs(q, k, v, out, lse, do, cu_q, cu_k):
    name = "varlen_attention_bwd"
    plan = _check_kernel_inputs(name, q, k, v, out, do, lse, cu_q, cu_k)
    total_q, hq, d = q.shape
    _build.expect_shape(name, "v", v, k.shape)
    _build.expect_shape(name, "out", out, q.shape)
    _build.expect_shape(name, "do", do, q.shape)
    _build.expect_shape(name, "lse", lse, (hq, total_q))
    _build.expect_shape(name, "cu_seqlens_k", cu_k, cu_q.shape)
    delta = (do.float() * out.float()).sum(-1).t().contiguous()  # [hq, total_q]
    q, k, v, do = _stored(plan, q, k, v, do)
    return q, k, v, do, _build.dense(lse.float()), delta


def _launch_varlen_dkv(q, k, v, do, lse, delta, cu_q, cu_k, max_sk, scale,
                       wl, wr, softcap, slopes=None):
    total_q, hq, d = q.shape
    total_k, hkv = k.shape[:2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("backward", "mfa_varlen_bwd_dkv", _VL_DKV_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            cu_q.data_ptr(), cu_k.data_ptr(), _build.DTYPE_CODES[q.dtype],
            cu_q.shape[0] - 1, hq, hkv, total_q, total_k, int(max_sk), d,
            head_dim_plan(d).kernel_dim, wl, wr, scale, softcap,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches[_build.launch_key("varlen_bwd_dkv", q.dtype)] += 1
    return dk, dv


def _launch_varlen_dq(q, k, v, do, lse, delta, cu_q, cu_k, max_sq, scale,
                      wl, wr, softcap, slopes=None):
    total_q, hq, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("backward", "mfa_varlen_bwd_dq", _VL_DQ_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), cu_q.data_ptr(),
            cu_k.data_ptr(), _build.DTYPE_CODES[q.dtype], cu_q.shape[0] - 1,
            hq, k.shape[1], total_q, k.shape[0], int(max_sq), d,
            head_dim_plan(d).kernel_dim, wl, wr, scale, softcap,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("backward", rc)
    _build.launches[_build.launch_key("varlen_bwd_dq", q.dtype)] += 1
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
    mfa_varlen_bwd_dq), as the JAX varlen backward does. alibi_slopes
    [num_heads]: the forward's bias on each sequence's own positions.
    """
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    wl, wr = (int(w) for w in window_size)
    if causal:
        wr = 0
    softcap = float(logit_softcap)
    if alibi_slopes is not None and softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    if q.device.type == "cpu":
        return _varlen_bwd_plain(q, k, v, out, lse, do, cu_q, cu_k, scale, wl,
                                 wr, softcap, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"varlen_attention_bwd: unsupported device {q.device}")
    if max_seqlen_q is None:
        max_seqlen_q = int((cu_q[1:] - cu_q[:-1]).max()) if cu_q.numel() > 1 else 0
    if max_seqlen_k is None:
        max_seqlen_k = int((cu_k[1:] - cu_k[:-1]).max()) if cu_k.numel() > 1 else 0
    cu_q, cu_k = cu_q.contiguous(), cu_k.contiguous()
    d = q.shape[-1]
    q, k, v, do, lse, delta = _varlen_cuda_inputs(q, k, v, out, lse, do, cu_q,
                                                  cu_k)
    slopes = cuda_slopes(alibi_slopes, _LOG2E, q.shape[1], q.device)
    dk, dv = _launch_varlen_dkv(q, k, v, do, lse, delta, cu_q, cu_k,
                                max_seqlen_k, scale, wl, wr, softcap, slopes)
    dq = _launch_varlen_dq(q, k, v, do, lse, delta, cu_q, cu_k, max_seqlen_q,
                           scale, wl, wr, softcap, slopes)
    return tuple(unpad_features(g, d) for g in (dq, dk, dv))
