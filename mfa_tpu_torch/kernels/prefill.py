"""Flash-attention prefill forward (counterpart of mfa_tpu/kernels/prefill.py).

The JAX package has three softmax engines behind `bound_softmax`, and the
port has a hand-written kernel for each Pallas kernel:

- classic (False): kernel 1, csrc/prefill.cu `mfa_prefill_fwd`, the online
  softmax with a running row max (`_prefill_body`). Softcap always runs it.
  Kernels 1-4 share the wgmma + TMA tile of csrc/flash_fwd_sm90.cuh.
- zero shift + poison flag, then repair (None / True, the default):
  csrc/bound.cu `mfa_flagged_fwd` (`_flagged_*`) fixes the softmax shift at
  zero and writes one int32 flag per (batch, head, 64-row tile) from values
  already in registers; `mfa_repair_fwd` (`_repair_kernel`) recomputes the
  flagged tiles with the classic algorithm in place. It is launched after
  every flagged launch: the flags never go to the host.
- zero shift + risky bits ("prepass", the default at head_dim % 128 != 0;
  "unchecked"): `mfa_bound_fwd` (`_bound_*`). `_risky_bits` computes, with
  torch ops as JAX does in jnp, which 64-row tiles could leave the fp32
  exp2 range under the zero shift (`_bound_risky`); those run the classic
  tile. "unchecked" has no bits and no classic branch.

The engine is chosen as in mfa_tpu (prefill.py:1093-1197), with one
departure: fp16 inputs take kernel 1 under None / True, and an explicit
zero-shift mode with fp16 raises. An unshifted p = exp2(s * c) is cast to
V's dtype before P.V, and fp16 overflows above 65504 and loses precision
below 6e-5 (ROADMAP Queue 3). `"flag_debug"` also returns the flags [b,
hq, ceil(sq / 64)], `"flag_only"` skips the repair, `"flag_presence"` the
flag.

Attention sinks (`sink_tokens`: with a left window the first columns stay
visible to every row) and `kv_position_offset` (row r sits at position r
+ offset) reach every engine; ALiBi (`alibi_slopes` [hq]: the logit gets
- slope_h * |position - column|) runs kernel 1 only, as in mfa_tpu, whose
zero-shift engines cannot bound its unbounded shift. The tile lists the
sink tiles ahead of the band (csrc/flash_fwd_sm90.cuh:span_of).

Any head_dim up to 256: the kernels run at the head-dim plan's D (64,
128 or 256; dispatch/config.py:head_dim_plan) on rows of the plan's stored
width, d itself unless its bytes are not a multiple of 16 (then a
zero-padded copy, its output sliced back). The engine choice and the
softmax scale see the true d.

fp32 inputs run the same engines on the fp32 tile of
csrc/flash_fwd_f32.cuh (3xTF32 products on tensor cores, 64 rows a block,
one flag tile each; launch names `<name>_fp32`): the zero-shift p =
exp2(s * c) stays fp32 for P.V, as V's dtype is fp32.

A CUDA tensor runs the kernels (or raises); a CPU tensor runs each
engine's plain fp32 version, which repeats its block algorithm: the same
exponent, p cast to V's dtype before P.V, and flags and risky bits per
64-row tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import (cdiv, head_dim_plan, pad_features,
                                           softmax_scale_default,
                                           unpad_features)
from mfa_tpu_torch.kernels import _build

_LOG2E = math.log2(math.e)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _F, _F, _F, _I, _I, _P, _P]
# q, k, v, o, lse, flags or bits, dtype, b, hq, hkv, sq, sk, d, D, wl, wr,
# scale_log2e, sinks, kv_off, stream (csrc/bound.cu)
_ZS_ARGTYPES = [_P] * 6 + [_I] * 10 + [_F, _I, _I, _P]
# q rows per flag / risky bit: one consumer warpgroup of kernels 1-4's
# 128-row blocks (csrc/flash_fwd_sm90.cuh WG_M)
TILE_Q = 64

# Copies of mfa_tpu/kernels/prefill.py's constants. A tile whose |q|max
# |k|max * scale * log2(e) stays within _BOUND_SAFE_LOG2 keeps every
# zero-shift exponent inside +-100 (Cauchy-Schwarz). A zero-shift row sum
# at or below _L_MIN, or not finite, poisons its tile.
_BOUND_SAFE_LOG2 = 100.0
_L_MIN = 2.0 ** -89
MODES = (True, False, "prepass", "unchecked", "flag_only", "flag_presence",
         "flag_debug")


def _bound_risky(maxq, maxk, scale_log2e):
    """True where the zero-shift softmax cannot be proven exact for a tile
    whose |q| / |k| row-norm maxima are maxq / maxk (mfa_tpu's
    _bound_risky)."""
    return maxq * maxk * abs(scale_log2e) > _BOUND_SAFE_LOG2


def _risky_bits(q, k, scale_log2e):
    """int32 [b, hq, ceil(sq / 64)]: 1 for the q tiles whose score range
    the norm bound cannot keep inside fp32 exp2 range. The maximum |k| is
    taken over the whole kv sequence of the tile's kv head, as in JAX."""
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    nt = cdiv(sq, TILE_Q)
    kf = k.float()
    maxk = (torch.sqrt((kf * kf).sum(-1)).amax(-1) if sk
            else kf.new_zeros((b, hkv)))
    qf = q.float()
    qn = torch.nn.functional.pad(torch.sqrt((qf * qf).sum(-1)),
                                 (0, nt * TILE_Q - sq))
    qn_blk = qn.reshape(b, hq, nt, TILE_Q).amax(-1)
    return _bound_risky(qn_blk, maxk.repeat_interleave(hq // hkv, 1)[..., None],
                        scale_log2e).to(torch.int32)


def _band(sq, sk, window_left, window_right, device, sinks=0, kv_off=0):
    """[sq, sk] visibility and [sq] 'band structurally empty' per row; row r
    sits at position r + kv_off, and with a left window the columns <
    sinks stay visible (mfa_tpu's _band_mask)."""
    row = torch.arange(sq, device=device)[:, None] + kv_off
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if window_right >= 0:
        mask &= col <= row + window_right
    if window_left >= 0:
        mask &= (col >= row - window_left) | (col < sinks)
    r = row[:, 0]
    lo = (r - window_left).clamp(min=0) if window_left >= 0 else torch.zeros_like(r)
    hi = (r + window_right + 1).clamp(max=sk) if window_right >= 0 else torch.full_like(r, sk)
    empty = hi <= lo
    if window_left >= 0 and sinks > 0:  # sink columns below the band's end
        empty &= hi <= 0
    return mask, empty


def alibi_bias(slopes, rows, cols):
    """[hq, rows, cols] ALiBi bias -slope_h * |row - col| in fp32 (rows and
    cols: position vectors)."""
    dist = (rows[:, None] - cols[None, :]).abs().float()
    return -slopes.float().reshape(-1, 1, 1) * dist


def _prefill_plain(q, k, v, scale, window_left, window_right, softcap,
                   return_lse, sinks=0, kv_off=0, alibi=None,
                   matmul=torch.matmul):
    """fp32 reference of kernel 1: same band, sinks, offset, softcap, ALiBi
    and dead-row rules; LSE is the natural log of the scaled (capped,
    biased) logits. `matmul` forms the two products (the tests pass
    kernels/backward.py:_matmul_3xtf32_plain, the fp32 tile's arithmetic)."""
    _, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = matmul(q.float(), kf.transpose(-1, -2))
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    if alibi is not None:
        s = s + alibi_bias(alibi.to(q.device),
                           torch.arange(sq, device=q.device) + kv_off,
                           torch.arange(sk, device=q.device))
    mask, _ = _band(sq, sk, window_left, window_right, q.device, sinks, kv_off)
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    live = torch.isfinite(lse)[..., None]
    # shifted by the row max, as the kernel's exp2((s - m) * c): exact for
    # scores far from 0, where s - lse would keep lse's rounding
    p = torch.where(live, torch.softmax(s, dim=-1), torch.zeros((), device=q.device))
    out = matmul(p, vf).to(q.dtype)
    return (out, lse) if return_lse else out


def _zero_shift_plain(q, k, v, scale, window_left, window_right, sinks=0,
                      kv_off=0, matmul=torch.matmul):
    """fp32 version of the zero-shift tile (kernels 2 and 4): p =
    exp2(s * scale * log2 e) with no shift, cast to V's dtype before P.V.
    O is normalized by the sum of p as cast (a convex combination of V's
    rows), LSE = ln l and the poison check use the sum l of the uncast p,
    as mfa_tpu (which normalizes by l too: in fp32 the two are the same).
    Returns (O in q's dtype, LSE = ln l, poison flags per 64-row tile
    [b, hq, ceil(sq / 64)] bool): a row is poisoned when its band is not
    structurally empty and l lies outside (_L_MIN, inf), or one of its O
    values is not finite. `matmul` forms the two products, as in
    _prefill_plain."""
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = matmul(q.float(), kf.transpose(-1, -2))
    mask, empty = _band(sq, sk, window_left, window_right, q.device, sinks,
                        kv_off)
    p = torch.where(mask, torch.exp2(s * (scale * _LOG2E)),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    p = p.to(v.dtype).float()
    n = p.sum(-1)
    acc = matmul(p, vf)
    bad = (l == 0) | torch.isnan(l)
    l_safe = torch.where(bad, torch.ones_like(l), l)
    o = acc * (1.0 / torch.where(bad, torch.ones_like(n), n))[..., None]
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")), torch.log(l_safe))
    ok = ((l > _L_MIN) & (l < float("inf"))) | (empty & (l == 0))
    ok &= torch.isfinite(o).all(-1)
    nt = cdiv(sq, TILE_Q)
    ok = torch.nn.functional.pad(ok, (0, nt * TILE_Q - sq), value=True)
    flags = ~ok.reshape(b, hq, nt, TILE_Q).all(-1)
    return o.to(q.dtype), lse, flags


def _classic_rows(q, k, v, scale, wl, wr, out, lse, tiles, sinks, kv_off):
    """Overwrite the rows of the tiles set in `tiles` [b, hq, nt] with the
    classic result (the plain repair, and the risky tiles of the bound
    engine)."""
    if not bool(tiles.any()):
        return out, lse
    co, cl = _prefill_plain(q, k, v, scale, wl, wr, 0.0, True, sinks, kv_off)
    rows = tiles.repeat_interleave(TILE_Q, -1)[..., :q.shape[2]]
    return (torch.where(rows[..., None], co, out), torch.where(rows, cl, lse))


def _engine_plain(engine, mode, q, k, v, scale, wl, wr, sinks=0, kv_off=0):
    """The zero-shift engines on CPU tensors -> (out, lse, flags or None)."""
    out, lse, flags = _zero_shift_plain(q, k, v, scale, wl, wr, sinks, kv_off)
    if engine == "flagged":
        if mode in (True, "flag_debug"):
            out, lse = _classic_rows(q, k, v, scale, wl, wr, out, lse, flags,
                                     sinks, kv_off)
        return out, lse, flags.to(torch.int32)
    if mode != "unchecked":
        out, lse = _classic_rows(q, k, v, scale, wl, wr, out, lse,
                                 _risky_bits(q, k, scale * _LOG2E) != 0,
                                 sinks, kv_off)
    return out, lse, None


def check_band_options(window_left: int, sink_tokens: int,
                       kv_position_offset: int = 0) -> tuple:
    """-> (sinks, kv_off) after mfa_tpu's rules: sinks are a no-op without a
    left window, the offset must be >= 0, and the two do not combine."""
    sinks = int(sink_tokens) if window_left >= 0 else 0
    kv_off = int(kv_position_offset)
    if sinks < 0:
        raise ValueError("sink_tokens must be >= 0")
    if kv_off < 0:
        raise ValueError("kv_position_offset must be >= 0 (q leads kv)")
    if kv_off and sinks:
        raise NotImplementedError(
            "kv_position_offset with attention sinks is not supported "
            "(the ring path handles sink blocks on the owning shard)")
    return sinks, kv_off


def _cuda_inputs(name, q, k, v):
    """The checks every CUDA prefill engine shares -> dense (q, k, v) at
    the head-dim plan's stored width, and the plan."""
    _build.refuse_grad(name, q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(
            f"the prefill kernel takes bf16/fp16/fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v dtypes differ")
    batch, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    plan = head_dim_plan(d)
    _build.same_device(name, q, k, v)
    _build.expect_shape(name, "k", k, (batch, hkv, sk, d))
    _build.expect_shape(name, "v", v, k.shape)
    return (*(_build.dense(pad_features(t, plan.stored)) for t in (q, k, v)),
            plan)


def cuda_slopes(alibi, scale, num_heads, device):
    """ALiBi slopes for the kernels: fp32 [num_heads] times `scale` (1 /
    softmax scale: the raw score domain; log2 e: the log2 domain), or None."""
    if alibi is None:
        return None
    if alibi.numel() != num_heads:
        raise ValueError(f"alibi_slopes must hold one slope per q head "
                         f"({num_heads}), got shape {tuple(alibi.shape)}")
    return (alibi.to(device=device, dtype=torch.float32).reshape(num_heads)
            * scale).contiguous()


def _prefill_cuda(q, k, v, scale, window_left, window_right, softcap,
                  return_lse, sinks=0, kv_off=0, alibi=None):
    q, k, v, plan = _cuda_inputs("prefill_attention", q, k, v)
    slopes = cuda_slopes(alibi, 1.0 / scale, q.shape[1], q.device)
    batch, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale_log2e = _LOG2E if softcap else scale * _LOG2E
    fn = _build.function("prefill", "mfa_prefill_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), _build.DTYPE_CODES[q.dtype], batch, hq, hkv, sq,
            sk, d, plan.kernel_dim, window_left, window_right, scale_log2e,
            float(softcap), scale / softcap if softcap else 0.0, sinks, kv_off,
            _build.ptr(slopes), _build.stream_of(q))
    _build.check("prefill", rc)
    _build.launches[_build.launch_key("prefill", q.dtype)] += 1
    out = unpad_features(out, plan.head_dim)
    return (out, lse) if return_lse else out


def _zs_launch(kind, q, k, v, out, lse, table, scale, wl, wr, sinks=0,
               kv_off=0):
    """One launch of csrc/bound.cu (kind: flagged, repair or bound) on q,
    k, v at a stored width d, run at head_dim_plan(d)'s kernel D (a stored
    width is its own plan's)."""
    batch, hq, sq, d = q.shape
    fn = _build.function("bound", f"mfa_{kind}_fwd", _ZS_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), _build.ptr(table), _build.DTYPE_CODES[q.dtype],
            batch, hq, k.shape[1], sq, k.shape[2], d,
            head_dim_plan(d).kernel_dim, wl, wr, scale * _LOG2E,
            sinks, kv_off, _build.stream_of(q))
    _build.check("bound", rc)
    _build.launches[_build.launch_key(kind, q.dtype)] += 1


def _engine_cuda(engine, mode, q, k, v, scale, wl, wr, return_lse, sinks=0,
                 kv_off=0):
    """The zero-shift engines on CUDA tensors -> (out, lse, flags or None).
    The flags and risky bits stay on the device."""
    q, k, v, plan = _cuda_inputs("prefill_attention", q, k, v)
    batch, hq, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if engine == "flagged":
        flags = None if mode == "flag_presence" else torch.empty(
            (batch, hq, cdiv(sq, TILE_Q)), dtype=torch.int32, device=q.device)
        _zs_launch("flagged", q, k, v, out, lse, flags, scale, wl, wr, sinks,
                   kv_off)
        if mode in (True, "flag_debug"):
            _zs_launch("repair", q, k, v, out, lse, flags, scale, wl, wr,
                       sinks, kv_off)
        return unpad_features(out, plan.head_dim), lse, flags
    # zero features leave the row norms, so the risky bits, unchanged
    bits = None if mode == "unchecked" else _risky_bits(q, k, scale * _LOG2E)
    _zs_launch("bound", q, k, v, out, lse, bits, scale, wl, wr, sinks, kv_off)
    return unpad_features(out, plan.head_dim), lse, None


def select_engine(bound_softmax, dtype, head_dim: int, softcap: float,
                  alibi: bool = False) -> tuple:
    """-> (engine, mode): engine "classic" (kernel 1), "flagged" (kernels
    2 + 3) or "bound" (kernel 4), as mfa_tpu's prefill_attention selects
    it (softcap and ALiBi keep the classic engine), plus the port's fp16
    rule (module docstring). head_dim is the true d, never the padded
    width a kernel runs at: d 80 takes the bound engine, as in mfa_tpu."""
    mode = True if bound_softmax is None else bound_softmax
    if mode is not True and mode is not False and mode not in MODES[2:]:
        raise ValueError(f"bound_softmax must be one of {MODES} or None, got "
                         f"{bound_softmax!r}")
    if mode is False or softcap or alibi:
        return "classic", False
    if dtype == torch.float16:
        if mode is True:
            return "classic", False
        raise NotImplementedError(
            f"bound_softmax={mode!r} with fp16: the zero-shift engines cast "
            f"the unshifted p = exp2(s * c) to V's dtype, and fp16's range "
            f"(6e-5 to 65504) loses such p at either end; fp16 takes "
            f"bound_softmax=False (the default does so)")
    if mode in (True, "flag_only", "flag_presence", "flag_debug") \
            and head_dim % 128 == 0:
        return "flagged", mode
    return "bound", "prepass" if mode is True else mode


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_position_offset: int = 0,
    bound_softmax=None,
):
    """Flash-attention forward on the [batch, heads, seq, head_dim] layout.

    q: [b, hq, sq, d]; k/v: [b, hkv, sk, d] with hq % hkv == 0 (q head h
    reads kv head h // (hq // hkv)). Causal is top-left aligned (col > row
    masked) and equals window (-1, 0); window_size is (left, right) around
    each row, -1 = unbounded. logit_softcap > 0 applies
    tanh(s * scale / cap) * cap to the logits. bound_softmax selects the
    softmax engine (module docstring): None / True, "prepass", "unchecked",
    False, and the probes "flag_only", "flag_presence", "flag_debug".
    sink_tokens: with a left window, the first sink_tokens columns stay
    visible to every row (a no-op without one). alibi_slopes [hq] fp32:
    the logit gets - slope_h * |position - column| (top-left positions;
    kernel 1 only; not with logit_softcap). kv_position_offset >= 0: row
    r sits at position r + offset against the columns (masks and ALiBi);
    not with sinks.

    Returns O [b, hq, sq, d] in q's dtype and, with return_lse, the fp32
    natural-log LSE [b, hq, sq] (-inf on rows that see no column); with
    "flag_debug" on the flagged engine, also the int32 flags [b, hq,
    ceil(sq / 64)].
    """
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    window_left, window_right = (int(w) for w in window_size)
    if causal:
        window_right = 0
    sinks, kv_off = check_band_options(window_left, sink_tokens,
                                       kv_position_offset)
    if alibi_slopes is not None and logit_softcap:
        raise ValueError("alibi_slopes and logit_softcap are exclusive")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    engine, mode = select_engine(bound_softmax, q.dtype, q.shape[-1],
                                 float(logit_softcap), alibi_slopes is not None)
    if engine == "classic":
        args = (q, k, v, scale, window_left, window_right, float(logit_softcap),
                return_lse, sinks, kv_off, alibi_slopes)
        if q.device.type == "cpu":
            return _prefill_plain(*args)
        return _prefill_cuda(*args)
    if q.device.type == "cpu":
        out, lse, flags = _engine_plain(engine, mode, q, k, v, scale,
                                        window_left, window_right, sinks,
                                        kv_off)
    else:
        out, lse, flags = _engine_cuda(engine, mode, q, k, v, scale,
                                       window_left, window_right, return_lse,
                                       sinks, kv_off)
    res = (out, lse) if return_lse else (out,)
    if mode == "flag_debug" and engine == "flagged":
        res += (flags,)
    return res if len(res) > 1 else res[0]
