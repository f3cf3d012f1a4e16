"""fp32 inputs on the card's routes of every kernel: the forward attention
kernels (1-9), the backward (11-14) and the int8 matmul (10).

The CUDA kernels cannot run here, so each card route is driven on meta
tensors with the C launch replaced by a recorder: the wrapper's checks,
head-dim plan, split plan, dtype code and launch-count name are what is
held, for every kernel and launch, head_dim 64 / 80 / 128 / 256 and every
page format. The plain fp32 versions those kernels are compared with on
the card are held against mfa_tpu in the other test files; here, what the
fp32 tiles rely on: the forward's key tiles never straddle a split, every
tile's shared memory fits a block, the plain versions' dead rows and
split route, and kernel 10's exact three-way bf16 split of fp32 x.
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu_torch.dispatch.config import head_dim_plan
from mfa_tpu_torch.kernels import (_build, backward, blockmask, decode,
                                   paged, paged_prefill, prefill, varlen,
                                   wmatmul)
from mfa_tpu_torch.kernels.quant import FP8, pack_int4, quantize_rows
from tests.jax_maps import release_jax_code  # noqa: F401

HEAD_DIMS = (64, 80, 128, 256)
FORMATS = (None, "int8", "fp8", "int4")
F32_CODE = 5  # csrc/common.cuh MFA_F32


@pytest.fixture
def recorder(monkeypatch):
    """Replace the C launches by a recorder of (library, function, args)."""
    calls = []

    def function(lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (lib, name)
            calls.append((lib, name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _pages(fmt, hkv, n, page, d):
    """Meta pages and scales of a format at the head-dim plan's stored width."""
    if fmt is None:
        w = head_dim_plan(d).stored
        return meta(hkv, n, page, w), meta(hkv, n, page, w), None, None
    w = paged.row_width(fmt, d)
    dt = FP8 if fmt == "fp8" else torch.int8
    return (meta(hkv, n, page, w, dtype=dt), meta(hkv, n, page, w, dtype=dt),
            meta(hkv, n, page), meta(hkv, n, page))


def _kd(d):
    return next(k for k in (64, 128, 256) if k >= d)


def _dense_route(kernel, d):
    """Drive kernel 1, 2 + 3, 4, 5, 7 or 9 on fp32 meta tensors
    -> the launch names it expects."""
    b, hq, hkv, s = 2, 8, 2, 100
    q, k = meta(b, hq, s, d), meta(b, hkv, s, d)
    scale = d ** -0.5
    if kernel == 1:
        prefill._prefill_cuda(q, k, k, scale, -1, 0, 0.0, True)
        return ["prefill_fp32"]
    if kernel == 2:
        prefill._engine_cuda("flagged", True, q, k, k, scale, -1, 0, True)
        return ["flagged_fp32", "repair_fp32"]
    if kernel == 4:
        prefill._engine_cuda("bound", "prepass", q, k, k, scale, -1, 0, True)
        return ["bound_fp32"]
    if kernel == 5:
        lens = meta(b, dtype=torch.int32)
        n, tps = decode.split_layout(4096, 3)
        decode._decode_cuda(meta(b, hq, d), meta(b, hkv, 4096, d),
                            meta(b, hkv, 4096, d), lens, scale, n, tps, -1, 0.0)
        return ["decode_fp32"]  # one launch: the split merge is inside it
    if kernel == 7:
        cu = meta(3, dtype=torch.int32)
        varlen._varlen_cuda(meta(200, hq, d), meta(200, hkv, d),
                            meta(200, hkv, d), cu, cu, 120, scale, -1, 0, 0.0,
                            True)
        return ["varlen_fp32"]
    ids = meta(b, s, dtype=torch.int32)
    blockmask._image_block_cuda(q, k, k, ids, scale, -1)
    return ["blockmask_fp32"]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kernel", [1, 2, 4, 5, 7, 9])
def test_dense_routes_accept_fp32(recorder, kernel, d):
    """Kernels 1-4, 5, 7 and 9 take fp32: the fp32 dtype code,
    the plan's stored width and D, and launch names ending in _fp32."""
    names = _dense_route(kernel, d)
    assert sorted(_build.launches) == sorted(names)
    assert all(n == 1 for n in _build.launches.values())
    plan = head_dim_plan(d)
    for lib, fname, args in recorder:
        assert F32_CODE in args, (lib, fname)
        i = args.index(plan.stored)  # the stored width, then the kernel D
        assert args[i + 1] == _kd(plan.stored) == plan.kernel_dim


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_decode_accepts_fp32(recorder, d, fmt):
    """Kernel 6 takes fp32 q on fp32 pages and on int8 / fp8 / int4 pages
    (fp32 q stays fp32: the q dtype code is fp32's), one split and the
    split route, one launch either way (the merge is inside it); spans
    too."""
    hkv, group, page = 2, 4, 64
    kp, vp, ks, vs = _pages(fmt, hkv, 40, page, d)
    for b, pps, q_span in ((16, 2, 1), (1, 16, 1), (2, 4, 3)):
        recorder.clear()
        _build.reset_launches()
        q = meta(b, q_span, hkv * group, d)
        lens, table = meta(b, dtype=torch.int32), meta(b, pps, dtype=torch.int32)
        out, lse = paged._paged_cuda(q, kp, vp, ks, vs, lens, table, d ** -0.5,
                                     -1, 0.0, 0, fmt)
        assert out.dtype == torch.float32 and out.shape == q.shape
        assert lse.shape == (b, q_span, hkv * group)
        n_splits, _ = paged.split_plan(b, hkv, pps, page)
        (lib, fname, args), *rest = recorder
        assert fname == "mfa_paged_decode" and not rest
        assert args[12] == F32_CODE  # q dtype
        assert args[13] == _build.kv_code(fmt, kp)
        assert dict(_build.launches) == {"paged_fp32": 1}
        # the split route's scratch and counters, and only there
        assert (args[9] is not None) == (args[11] is not None) == (n_splits > 1)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_prefill_accepts_fp32(recorder, d, fmt):
    """Kernel 8 takes fp32 q on fp32 pages and on every quantized format, at
    any group (65 and 71: head chunks) and on pages of any row count."""
    for hq, hkv in ((8, 2), (7, 1), (64, 1), (65, 1), (142, 2)):
        recorder.clear()
        _build.reset_launches()
        kp, vp, ks, vs = _pages(fmt, hkv, 12, 16, d)
        q = meta(2, 24, hq, d)
        ints, table = meta(2, dtype=torch.int32), meta(2, 3, dtype=torch.int32)
        out, lse = paged_prefill._paged_prefill_cuda(
            q, kp, vp, ks, vs, ints, ints, ints, table, d ** -0.5, -1, 0, 0.0,
            fmt)
        assert out.dtype == torch.float32 and out.shape == q.shape
        (lib, fname, args), = recorder
        assert fname == "mfa_paged_prefill"
        assert args[11] == F32_CODE and args[12] == _build.kv_code(fmt, kp)
        assert dict(_build.launches) == {"paged_prefill_fp32": 1}
    for page in (2, 4, 12) if fmt == "int4" else (1, 4, 12):
        recorder.clear()
        _build.reset_launches()
        kp, vp, ks, vs = _pages(fmt, 2, 12, page, d)
        out, lse = paged_prefill._paged_prefill_cuda(meta(1, 8, 8, d), kp, vp, ks, vs,
                                                     ints[:1], ints[:1], ints[:1],
                                                     table[:1], 0.1, -1, 0, 0.0, fmt)
        assert out.dtype == torch.float32 and out.shape == (1, 8, 8, d)
        (lib, fname, args), = recorder
        assert args[18] == page  # page_size
        assert dict(_build.launches) == {"paged_prefill_fp32": 1}


def _bwd_route(launch, d, sinks=0, offset=0, alibi=False, group=4):
    """Drive one backward launch on fp32 meta tensors (hkv 2, `group` q
    heads a kv head) -> its launch name."""
    from mfa_tpu_torch.kernels import backward
    from mfa_tpu_torch.kernels.prefill import _LOG2E, cuda_slopes

    hkv, s = 2, 100
    hq = hkv * group
    wl, wr, scale, cap = (63 if sinks else -1), 0, d ** -0.5, 0.0
    slopes = cuda_slopes(meta(hq), _LOG2E, hq, "meta") if alibi else None
    if launch.startswith("varlen"):
        cu = meta(3, dtype=torch.int32)
        q, k = meta(2 * s, hq, d), meta(2 * s, hkv, d)
        args = backward._varlen_cuda_inputs(q, k, k, q, meta(hq, 2 * s), q, cu, cu)
        if launch == "varlen_bwd_dkv":
            dk, dv = backward._launch_varlen_dkv(*args, cu, cu, s, scale, wl, wr, cap,
                                                 slopes)
            assert dk.shape == dv.shape == (2 * s, hkv, head_dim_plan(d).stored)
        else:
            dq, = (backward._launch_varlen_dq(*args, cu, cu, s, scale, wl, wr, cap,
                                              slopes),)
            assert dq.shape == (2 * s, hq, head_dim_plan(d).stored)
        return launch + "_fp32"
    q, k = meta(2, hq, s, d), meta(2, hkv, s, d)
    args = backward._dense_cuda_inputs(q, k, k, q, meta(2, hq, s), q) + (
        scale, wl, wr, cap)
    if launch == "bwd_fused":
        dq_ws, dk, dv = backward._launch_fused(*args, sinks, offset, slopes)
        assert dq_ws.dtype == dk.dtype == dv.dtype == torch.float32
    elif launch == "bwd_dkv":
        backward._launch_dkv(*args, offset, slopes)
    else:
        assert backward._launch_dq(*args, offset, slopes).dtype == torch.float32
    return launch + "_fp32"


BWD_LAUNCHES = ("bwd_fused", "bwd_dkv", "bwd_dq", "varlen_bwd_dkv",
                "varlen_bwd_dq")


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("launch", BWD_LAUNCHES)
def test_backward_routes_accept_fp32(recorder, launch, d):
    """Kernels 11-14 take fp32 on the card: each launch passes the fp32
    dtype code, the plan's stored width and D, and counts as <name>_fp32."""
    name = _bwd_route(launch, d)
    assert dict(_build.launches) == {name: 1}
    (lib, fname, args), = recorder
    assert lib == "backward" and fname == "mfa_" + launch
    assert F32_CODE in args
    plan = head_dim_plan(d)
    i = args.index(plan.stored)
    assert args[i + 1] == plan.kernel_dim == _kd(plan.stored)


@pytest.mark.parametrize("launch,opts", [
    ("bwd_fused", dict(sinks=4)),
    ("bwd_fused", dict(alibi=True, offset=384)),
    ("bwd_dkv", dict(alibi=True, offset=384)),
    ("bwd_dq", dict(alibi=True, offset=384, group=7)),
    ("varlen_bwd_dkv", dict(alibi=True)),
    ("varlen_bwd_dq", dict(alibi=True, group=7)),
])
def test_backward_fp32_band_options(recorder, launch, opts):
    """Sinks (the fused launch), ALiBi slopes and the offset reach the fp32
    launches as they reach the bf16 ones; the split refuses sinks on fp32
    as on bf16."""
    from mfa_tpu_torch.kernels import backward

    _bwd_route(launch, 128, **opts)
    (_, _, args), = recorder
    stream, slopes = args[-1], args[-2]
    assert stream == 0 and (slopes is not None) == opts.get("alibi", False)
    if launch == "bwd_fused":
        assert args[-4:-2] == (opts.get("sinks", 0), opts.get("offset", 0))
    elif not launch.startswith("varlen"):
        assert args[-3] == opts.get("offset", 0)
    t = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match="fused"):
        backward.flash_attention_bwd(t, t, t, t, torch.zeros(1, 2, 8), t,
                                     window_size=(3, 0), sink_tokens=2,
                                     fused=False)


@pytest.mark.parametrize("m", (1, 16, 40, 255, 3601))
def test_int8_matmul_routes_accept_fp32(recorder, m):
    """Kernel 10 takes fp32 x on the card: the fp32 dtype code, fp32 out, the
    bf16 parts' scratch [3, m, K], at most 128 rows a block in its split
    plan; launch name wmatmul_fp32. fp32 x with 16-bit out is refused."""
    K, N = 4096, 14336
    x, qw, sc = meta(m, K), meta(K, N, dtype=torch.int8), meta(N)
    out = wmatmul._int8_matmul_cuda(x, qw, sc, torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, N)
    assert dict(_build.launches) == {"wmatmul_fp32": 1}
    (lib, fname, args), = recorder
    assert fname == "mfa_int8_matmul"
    assert args[4] is not None and args[5] == F32_CODE and args[6] == 1
    assert args[7:10] == (m, K, N)
    assert args[10:12] == wmatmul.split_k(m, K, N, f32=True)
    assert wmatmul.block_m(m, f32=True) <= 128
    with pytest.raises(NotImplementedError, match="float32"):
        wmatmul._int8_matmul_cuda(x, qw, sc, torch.bfloat16)


@pytest.mark.parametrize("form", ("shared", "per_expert", "grouped"))
def test_int8_bank_routes_accept_fp32(recorder, form):
    """Kernel 10's expert launch takes fp32 x in all three forms: the fp32
    code, the scratch pointer, rows a block at most 128; wmatmul_bank_fp32."""
    E, K, N = 8, 4096, 14336
    qw, sc = meta(E, K, N, dtype=torch.int8), meta(E, N)
    if form == "grouped":
        x, offs = meta(3601, K), meta(E + 1, dtype=torch.int32)
        out = wmatmul._bank_cuda(x, qw, sc, offs, 3601, torch.float32)
        assert out.shape == (3601, N)
    else:
        x = meta(*((E,) if form == "per_expert" else ()), 300, K)
        out = wmatmul._bank_cuda(x, qw, sc, None, None, torch.float32)
        assert out.shape == (E, 300, N)
    assert out.dtype == torch.float32
    assert dict(_build.launches) == {"wmatmul_bank_fp32": 1}
    (lib, fname, args), = recorder
    assert fname == "mfa_int8_bank_matmul"
    assert args[5] is not None and args[6] == F32_CODE
    assert args[11] == int(form == "per_expert") and args[12] <= 128


def test_quant_q_keeps_fp32():
    """fp32 q on quantized pages stays fp32 and fp16 q contracts in bf16;
    pages of another dtype than q's are refused."""
    pages = meta(2, 3, 16, 64, dtype=torch.int8)
    for dt, want in ((torch.float32, torch.float32), (torch.float16, torch.bfloat16),
                     (torch.bfloat16, torch.bfloat16)):
        assert paged.quant_q(meta(2, 8, 64, dtype=dt), pages, "int8",
                             "paged").dtype == want
    assert paged.quant_q(meta(2, 8, 64), meta(2, 3, 16, 64), None,
                         "paged").dtype == torch.float32
    with pytest.raises(NotImplementedError, match="pages of the q dtype"):
        paged.quant_q(meta(2, 8, 64), meta(2, 3, 16, 64, dtype=torch.bfloat16),
                      None, "paged")


CUH = pathlib.Path(mfa_tpu_torch.__file__).parent / "csrc" / "flash_fwd_f32.cuh"
DECODE_CUH = CUH.parent / "decode_sm90.cuh"


def _decode_plan(d, fmt):
    """A mirror of csrc/decode_sm90.cuh's Plan<D, F, F32 = true> (kernels 5
    and 6 with fp32 q), the constants read from the source: tokens a tile
    (fp32 rows above D 128 take TILE / 2), teams of 16-token warps (8
    consumer warps, 4 above D 128), slots of K and V tiles (4-byte values,
    or the page bytes and two fp32 scales a token) rounded up to 1024
    bytes, as many as fit the ring's budget (at most 16) in whole teams,
    the barriers, Q (fp32 rows 16 x D, or three bf16 parts of 16 rows of
    QW words) and 1 KB to align the base; and the merge (per consumer warp
    16 fp32 O rows and m, l), which reuses the ring."""
    src = DECODE_CUH.read_text()
    edge, div = (int(x) for x in re.search(
        r"TT = F32P && D > (\d+) \? TILE / (\d+) : TILE", src).groups())
    budget = int(re.search(r"FIT = \((\d+) \* 1024\) / STAGE_BYTES", src).group(1)) * 1024
    qw = d // 2 + int(re.search(r"QW = D / 2 \+ (\d+);", src).group(1))
    rows = int(re.search(r"F32P \? (\d+) \* D \* 4 : 3 \* \d+ \* QW \* 4", src).group(1))
    f32p = fmt is None
    tt = decode.TILE // div if f32p and d > edge else decode.TILE
    rb = d // 2 if fmt == "int4" else d
    kv = tt * (4 * d if f32p else rb)
    stage = math.ceil((2 * kv + (0 if f32p else 2 * tt * 4)) / 1024) * 1024
    cwarps = 4 if d > 128 else 8
    teams = cwarps // (tt // 16)  # a slot serves one team: a multiple of TEAMS
    stages = min(budget // stage, 16) // teams * teams
    q_off = math.ceil((stages * stage + 16 * stages) / 128) * 128
    return dict(tt=tt, stages=stages, teams=teams, ring=stages * stage,
                bytes=q_off + (rows * d * 4 if f32p else 3 * rows * qw * 4) + 1024,
                merge=cwarps * 16 * d * 4 + cwarps * 2 * 16 * 4)


@pytest.mark.parametrize("d", (64, 128, 256))
def test_fp32_tile_fits_and_aligns_with_splits(d):
    """The fp32 decode of kernels 5 and 6 (decode_sm90.cuh's ring with fp32
    q) on fp32, int8, fp8 and int4 rows: a ring of at least 2 slots, a
    whole number of them a team, whose merge fits inside it, the whole
    under a block's 227 KB; every tile of 16-token warp rows lies inside
    one 64-token split unit (so a split reads exactly its own columns)."""
    for fmt in (None, "int8", "fp8", "int4"):
        p = _decode_plan(d, fmt)
        assert p["stages"] >= 2 and p["stages"] % p["teams"] == 0, (fmt, p)
        assert p["merge"] <= p["ring"] and p["bytes"] <= 232448, (fmt, p)
        assert decode.TILE % p["tt"] == 0 and p["tt"] % 16 == 0
        for max_s, n in ((8192, 7), (300, 2), (64, 1), (4097, 5)):
            _, tps = decode.split_layout(max_s, n)
            assert tps % p["tt"] == 0


BWD_CUH = CUH.parent / "flash_bwd_f32.cuh"
WMM_CU = CUH.parent / "wmatmul.cu"
SMEM_BLOCK, SMEM_SM = 232448, 233472  # bytes: a block's cap, an SM's


def _ex_at(r, c, cols):
    """flash_bwd_f32.cuh:ex_at: column c of exchange row r (rows of C floats)."""
    return r * cols + (c ^ (((r & 3) << 3) | (r & 4)))


def _conflict_free(words, width=1):
    """A warp's shared-memory access of `width` words a lane (lane order):
    every phase (32 / width lanes) touches each of the 32 banks once."""
    per = 32 // width
    for h in range(0, 32, per):
        banks = [(w + i) % 32 for w in words[h:h + per] for i in range(width)]
        if len(set(banks)) != 32:
            return False
    return True


@pytest.mark.parametrize("d", (64, 128, 256))
def test_fp32_backward_tile_fits(d):
    """A Python mirror of csrc/flash_bwd_f32.cuh's Plan (WARPS, the walked
    tile's C rows and the row stride D + 8 read from the source; NC = D /
    64 column groups of 64 features, NR = WARPS / NC row groups of 16, R =
    16 NR rows of the block's own; X tiles [2][R], a 2-slot ring of two [C]
    tiles (each as hi and lo planes up to D 128), one (DQ below or above D
    128) or two exchange buffers [R][C], LSE and delta, two
    mbarriers): every mode fits a block's 227 KB at every D, a warp's pair
    tile is whole n-tiles and its accumulators 16 x 64, FUSED's dQ step
    covers the q tile with the block's 8 warps, and every shared-memory
    access of the products is free of bank conflicts: the K-major float2
    reads of products 1-2, the MN-major float2 reads of dV, dK and dQ's B,
    and the swizzled exchange buffer read along and across its rows and
    written as float2 from the accumulator fragments."""
    text = BWD_CUH.read_text()
    warps = int(re.search(r"constexpr int WARPS = (\d+);", text).group(1))
    cols = int(re.search(r"constexpr int C = (\d+);", text).group(1))
    assert "XS = D + 8;" in text and "NC = D / 64;" in text
    assert "PRESPLIT = D <= 128;" in text
    assert "NE = MODE == DQ && D != 128 ? 1 : 2;" in text
    assert "(c ^ (((r & 3) << 3) | (r & 4)))" in text
    nc = d // 64
    nr = warps // nc
    rr, xs = 16 * nr, d + 8
    assert nr * nc == warps and cols % 32 == 0 and (cols // nc) % 8 == 0
    for mode in ("FUSED", "DKV", "DQ"):
        ne = 1 if mode == "DQ" and d != 128 else 2  # D 128: S's halves swapped too
        rows = 2 * rr if mode == "DQ" else 4 * cols
        planes = 2 if d <= 128 else 1  # a walked tile's hi and lo planes
        floats = 2 * rr * xs + 4 * planes * cols * xs + ne * rr * cols + rows
        assert floats % 2 == 0 and 4 * floats + 16 <= SMEM_BLOCK, (mode, floats)
    # FUSED's dQ step: 8 warps as C / 16 row tiles x 4 column slices of D / 4
    assert warps == 2 * 4 and cols == 32 and (d // 4) % 16 == 0
    assert "q_tiles(kv0, R, C, a)" in text and "span_of(p0, p0 + valid - 1, a.sk, a.wl, a.wr, C)" in text
    lanes = [(ln >> 2, ln & 3) for ln in range(32)]
    for r0 in range(0, rr, 16):
        for kk in range(0, d, 8):  # products 1-2: X[r0 + g][kk + 2 t4], float2
            assert _conflict_free([(r0 + g) * xs + kk + 2 * t for g, t in lanes], 2)
        for kk in range(0, cols, 8):  # dV, dK, DQ's dQ: A along exchange rows
            for k4 in (0, 4):
                for g8 in (0, 8):
                    assert _conflict_free([_ex_at(r0 + g + g8, kk + t + k4, cols)
                                           for g, t in lanes])
        for j in range(cols // nc // 8):  # P, dS written as float2
            for c0 in range(0, cols, cols // nc):
                for g8 in (0, 8):
                    assert _conflict_free([_ex_at(r0 + g + g8, c0 + 8 * j + 2 * t, cols)
                                           for g, t in lanes], 2)
    for kk in range(0, max(rr, cols), 8):  # B across rows: Z[kk + t4][cd + 2 g], float2
        for cd in range(0, d, 16):
            assert _conflict_free([(kk + t) * xs + cd + 2 * g for g, t in lanes], 2)
        for cd in range(0, d, 8):  # split planes: Z[kk + t4][cd + g], one float
            assert _conflict_free([(kk + t) * xs + cd + g for g, t in lanes])
    for kk in range(0, rr, 8):  # FUSED's dQ: A across exchange rows (dS^T -> dS)
        for k4 in (0, 4):
            for m in (0, 8, 16, 24):
                assert _conflict_free([_ex_at(kk + t + k4, m + g, cols) for g, t in lanes])


def _matmul_tf32_1pass(a, b):
    """One TF32 pass (hi.hi only), the product 3xTF32 improves on."""
    return backward._split_tf32_plain(a)[0] @ backward._split_tf32_plain(b)[0]


def test_split_tf32_keeps_21_bits():
    """csrc/tf32.cuh's operand split (hi by cvt.rna.tf32's rule, lo = x - hi
    read as its TF32 bits, low 13 cut): on seeded
    normal fp32 values of magnitudes 1e-30 to 1e30, hi and lo are TF32
    values (their 13 low bits zero), hi is x rounded to 11 significant
    bits with ties away from zero, and hi + lo is within 2^-21 of x
    relative."""
    rng = np.random.RandomState(24)
    x = rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-30, 30, 1 << 16)
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo = backward._split_tf32_plain(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())
    err = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(err) <= 2.0 ** -21
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])  # halfway: away from zero
    assert backward._split_tf32_plain(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def _bwd_limit(got, want):
    """The fp32 kernels' limit on each of dQ, dK and dV: allclose(rtol 1e-4,
    atol 1e-4 max |want|) -> (within, worst excess over the limit)."""
    excess = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        excess.append(float(((g - w).abs() - 1e-4 * (w.abs() + w.abs().max())).max()))
    return max(excess) <= 0, max(excess)


def _jax_dense_case(seed, b, hq, hkv, s, d, window, amp=1.0):
    """Seeded fp32 inputs (q and k scaled by amp), mfa_tpu's forward and
    backward in Pallas interpret mode -> (torch inputs, mfa_tpu's grads)."""
    import jax.numpy as jnp

    from mfa_tpu.kernels.backward import flash_attention_bwd as jbwd
    from mfa_tpu.kernels.prefill import prefill_attention as jprefill

    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((b, hq, s, d)) * amp).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * amp).astype(np.float32)
    v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hkv, hq))
    kw = dict(causal=window[0] < 0, window_size=window)
    out, lse = jprefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **kw)
    out, lse = np.array(out), np.array(lse)
    want = jbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)), **kw)
    return [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, do)], want


@pytest.mark.parametrize("b,s,d,window", [
    (1, 256, 64, (-1, 0)), (2, 128, 128, (-1, 0)), (1, 256, 128, (31, 0)),
    (2, 200, 64, (63, 0))])
def test_3xtf32_backward_matches_mfa_tpu(b, s, d, window):
    """The fp32 tile's arithmetic on the CPU: _bwd_plain with its five
    products in 3xTF32 (_matmul_3xtf32_plain) within the fp32 kernels'
    limit (allclose rtol 1e-4, atol 1e-4 max |ref|) of mfa_tpu's backward
    in Pallas interpret mode on the same seeded inputs (hq 4, hkv 2)."""
    args, want = _jax_dense_case(24, b, 4, 2, s, d, window)
    got = backward._bwd_plain(*args, d ** -0.5, window[0], window[1], 0.0,
                              matmul=backward._matmul_3xtf32_plain)
    within, excess = _bwd_limit(got, want)
    assert within, excess


@pytest.mark.parametrize("lens,d,window", [
    ([100, 256, 37], 64, (-1, 0)), ([128, 0, 200], 128, (-1, 0)),
    ([256, 90], 128, (47, 0))])
def test_3xtf32_varlen_backward_matches_mfa_tpu(lens, d, window):
    """The same on the packed layout: _varlen_bwd_plain in 3xTF32 against
    mfa_tpu's varlen_attention_bwd in interpret mode (hq 4, hkv 2)."""
    import jax.numpy as jnp

    from mfa_tpu.kernels.backward import varlen_attention_bwd as jvbwd
    from mfa_tpu.kernels.varlen import varlen_attention as jvarlen

    rng = np.random.RandomState(25)
    n = sum(lens)
    q, do = (rng.standard_normal((n, 4, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((n, 2, d)).astype(np.float32) for _ in range(2))
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    kw = dict(causal=window[0] < 0, window_size=window)
    out, lse = jvarlen(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(cu), jnp.asarray(cu),
                       max(lens), max(lens), return_lse=True, **kw)
    out, lse = np.array(out), np.array(lse)
    want = jvbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)), jnp.asarray(cu),
                 jnp.asarray(cu), **kw)
    t = [torch.from_numpy(a) for a in (q, k, v, out, lse, do)]
    cut = torch.from_numpy(cu)
    got = backward._varlen_bwd_plain(*t, cut, cut, d ** -0.5, window[0], window[1], 0.0,
                                     matmul=backward._matmul_3xtf32_plain)
    within, excess = _bwd_limit(got, want)
    assert within, excess


def test_one_tf32_pass_breaks_the_limit_three_keep_it():
    """Why three products: at a seeded causal input with larger scores (q
    and k x 3: |S scale| up to ~46; b1 hq4 hkv2 s256 d128), one TF32 pass
    (hi.hi) misses the fp32 limit against mfa_tpu's backward in interpret
    mode, and 3xTF32 keeps it. The GPU tests run the kernels on the same
    input."""
    args, want = _jax_dense_case(0, 1, 4, 2, 256, 128, (-1, 0), amp=3.0)
    tail = (128 ** -0.5, -1, 0, 0.0)
    one = backward._bwd_plain(*args, *tail, matmul=_matmul_tf32_1pass)
    three = backward._bwd_plain(*args, *tail, matmul=backward._matmul_3xtf32_plain)
    assert not _bwd_limit(one, want)[0]
    within, excess = _bwd_limit(three, want)
    assert within, excess


@pytest.mark.parametrize("bmx", (16, 32, 64, 128))
def test_fp32_wmatmul_ring_fits(bmx):
    """csrc/wmatmul.cu's fp32-x plan (three bf16 x tiles and one int8 W tile
    a stage, the stage counts read from the source): every ring fits a
    block and holds the epilogue's staging tile."""
    text = WMM_CU.read_text()
    expr = re.search(r"NX == 3 \? \((BMX == 128 \? \d+ : BMX == 64 \? \d+ : "
                     r"BMX == 32 \? \d+ : \d+)\)", text).group(1)
    stages = _cond(expr, bmx)
    stage = 3 * bmx * 128 + 64 * 128
    assert stages * stage + 16 * stages + 1024 <= SMEM_BLOCK
    assert bmx * (128 * 4 + 16) <= stages * stage
    assert stages >= 4  # a K step's three x tiles in flight beside the W tile


def _cond(expr, bmx):
    """Evaluate `BMX == a ? x : BMX == b ? y : ... : z` at bmx."""
    parts = [t.strip() for t in re.split(r"[?:]", expr)]
    for i in range(0, len(parts) - 1, 2):
        if int(parts[i].split("==")[1]) == bmx:
            return int(parts[i + 1])
    return int(parts[-1])


def test_split_bf16x3_is_exact_and_matches_mfa_tpu():
    """fp32 x in kernel 10: the three bf16 parts of seeded normal fp32 values
    (magnitudes 1e-30 to 1e30) add back to x exactly, and (hi + mid + lo) @
    W, three products with fp32 accumulation, matches mfa_tpu's int8_matmul
    on fp32 x (Pallas interpret mode) within 1e-6 of the largest output."""
    import jax.numpy as jnp

    from mfa_tpu.kernels.wmatmul import int8_matmul as jax_int8_matmul
    from mfa_tpu.models import wquant as jw

    rng = np.random.RandomState(23)
    x = (rng.standard_normal((64, 256)) * 10.0 ** rng.uniform(-30, 30, (64, 256)))
    x = torch.from_numpy(x.astype(np.float32))
    parts = wmatmul._split_bf16x3_plain(x)
    assert all(t.dtype == torch.bfloat16 for t in parts)
    assert torch.equal(sum(t.double() for t in parts), x.double())
    assert all(bool(torch.isfinite(t).all()) for t in parts)
    # the products: m 24, K 256, N 384 of unit-scale x
    xm = torch.from_numpy(rng.standard_normal((24, 256)).astype(np.float32))
    q = jw.quantize_weight(jnp.asarray(rng.standard_normal((256, 384)).astype(np.float32)))
    qw, sc = torch.from_numpy(np.array(q.qw)), torch.from_numpy(np.array(q.scale))
    want = np.asarray(jax_int8_matmul(jnp.asarray(xm.numpy()), q.qw, q.scale), np.float32)
    got = sum(p.float() @ qw.float() for p in wmatmul._split_bf16x3_plain(xm)) * sc
    lim = 1e-6 * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= lim
    plain = wmatmul.int8_matmul(xm, qw, sc)  # the CPU route: the plain version
    assert plain.dtype == torch.float32
    assert np.abs(plain.numpy() - want).max() <= lim


def test_fp32_plain_dead_rows_and_split_route():
    """What the fp32 kernels must reproduce: the plain versions' empty rows
    (a zero length, rows past q_lens: O = 0, LSE = -inf) and the split
    route of kernel 6 equal to one pass within fp32 rounding, on fp32 pages
    and on int8 pages with fp32 q (there within the bf16 rounding of p,
    which each split takes against its own row max: 4e-3, as
    test_torch_kv_formats holds the split route)."""
    rng = np.random.RandomState(0)
    hkv, group, d, page, pps = 2, 4, 64, 16, 8
    kf, vf = (torch.from_numpy(rng.standard_normal((hkv, 30, page, d))
                               .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.permutation(29)[: 3 * pps].reshape(3, pps) + 1).int()
    lens = torch.tensor([100, 0, 37], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3, hkv * group, d)).astype(np.float32))
    (kq, ks), (vq, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
    for kp, vp, kss, vss, fmt, tol in ((kf, vf, None, None, None, 1e-5),
                                       (kq, vq, ks, vs, "int8", 4e-3)):
        args = (q, kp, vp, kss, vss, lens, table, d ** -0.5, -1, 0.0, 0, fmt)
        o1, l1 = paged._paged_plain(*args)
        o3, l3 = paged._paged_split_plain(*args[:11], num_splits=3,
                                          quant_dtype=fmt)
        assert o1.dtype == torch.float32
        torch.testing.assert_close(o3, o1, atol=tol, rtol=1e-5)
        assert torch.equal(torch.isneginf(l1), torch.isneginf(l3))
        assert bool((o1[1] == 0).all()) and bool(torch.isneginf(l1[1]).all())
    qp = torch.from_numpy(rng.standard_normal((2, 24, 8, d)).astype(np.float32))
    out, lse = paged_prefill.paged_prefill_attention(
        qp, kq, vq, torch.tensor([40, 30]), torch.tensor([16, 10]), table[:2],
        q_lens=torch.tensor([24, 5]), k_scales=ks, v_scales=vs, return_lse=True)
    assert out.dtype == torch.float32
    assert bool((out[1, 5:] == 0).all()) and bool(torch.isneginf(lse[1, :, 5:]).all())
    assert bool(torch.isfinite(lse[0]).all()) and bool(torch.isfinite(lse[1, :, :5]).all())


def test_int4_fp32_q_plain_matches_dequantized_fp32():
    """fp32 q on int4 pages: q . k in fp32 against the payload values
    times the K scale, p rounded to bf16 before P.V: within bf16's
    rounding of p of the fp32 attention over the dequantized rows."""
    rng = np.random.RandomState(1)
    hkv, d, page = 1, 64, 16
    kf, vf = (torch.from_numpy(rng.standard_normal((hkv, 4, page, d))
                               .astype(np.float32)) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_rows(kf, "int4"), quantize_rows(vf, "int4")
    kd, vd = kq.float() * ks[..., None], vq.float() * vs[..., None]
    q = torch.from_numpy(rng.standard_normal((1, 2, d)).astype(np.float32))
    table = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    lens = torch.tensor([60], dtype=torch.int32)
    got = paged.paged_attention(q, pack_int4(kq), pack_int4(vq), lens, table,
                                k_scales=ks, v_scales=vs, quant_dtype="int4")
    ref = paged.paged_attention(q, kd, vd, lens, table)
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=0)
