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
from mfa_tpu_torch.kernels import (_build, blockmask, decode, paged,
                                   paged_prefill, prefill, varlen, wmatmul)
from mfa_tpu_torch.kernels.quant import FP8, pack_int4, quantize_rows

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
    """Drive kernel 1, 2 + 3, 4, 5 (+ combine), 7 or 9 on fp32 meta tensors
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
        return ["decode_fp32", "combine_fp32"]
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
    """Kernels 1-4, 5 (+ the combine), 7 and 9 take fp32: the fp32 dtype code,
    the plan's stored width and D, and launch names ending in _fp32."""
    names = _dense_route(kernel, d)
    assert sorted(_build.launches) == sorted(names)
    assert all(n == 1 for n in _build.launches.values())
    plan = head_dim_plan(d)
    for lib, fname, args in recorder:
        assert F32_CODE in args, (lib, fname)
        if fname != "mfa_decode_combine":
            i = args.index(plan.stored)  # the stored width, then the kernel D
            assert args[i + 1] == _kd(plan.stored) == plan.kernel_dim


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_decode_accepts_fp32(recorder, d, fmt):
    """Kernel 6 takes fp32 q on fp32 pages and on int8 / fp8 / int4 pages
    (fp32 q stays fp32: the q dtype code is fp32's), one split and the
    split route with its combine; spans too."""
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
        assert fname == "mfa_paged_decode"
        assert args[11] == F32_CODE  # q dtype
        assert args[12] == _build.kv_code(fmt, kp)
        assert _build.launches["paged_fp32"] == 1
        assert len(rest) == (n_splits > 1)
        if rest:
            assert rest[0][1] == "mfa_decode_combine" and rest[0][2][4] == F32_CODE
            assert _build.launches["combine_fp32"] == 1


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_prefill_accepts_fp32(recorder, d, fmt):
    """Kernel 8 takes fp32 q on fp32 pages and on every quantized format, at
    groups 1-64 (the page-of-12-rows refusal stays)."""
    for hq, hkv in ((8, 2), (7, 1), (64, 1)):
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
    kp, vp, ks, vs = _pages(fmt, 2, 12, 12, d)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        paged_prefill._paged_prefill_cuda(meta(1, 8, 8, d), kp, vp, ks, vs,
                                          ints[:1], ints[:1], ints[:1],
                                          table[:1], 0.1, -1, 0, 0.0, fmt)


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


def _tile_keys(d):
    """BN of csrc/flash_fwd_f32.cuh's Plan at head dim D, read from the
    source (`BN = D >= 128 ? 32 : 64`)."""
    m = re.search(r"BN = D >= (\d+) \? (\d+) : (\d+);", CUH.read_text())
    edge, big, small = (int(x) for x in m.groups())
    return big if d >= edge else small


@pytest.mark.parametrize("d", (64, 128, 256))
def test_fp32_tile_fits_and_aligns_with_splits(d):
    """Every key tile of the fp32 tile lies inside one 64-token split unit
    (so a split reads exactly its own columns), and its shared memory (Q,
    K, V, P, scales, ids and a 56-byte Row a row) fits a block's 227 KB."""
    bn = _tile_keys(d)
    assert decode.TILE % bn == 0
    for max_s, n in ((8192, 7), (300, 2), (64, 1), (4097, 5)):
        _, tps = decode.split_layout(max_s, n)
        assert tps % bn == 0
    for rows in (64, 16):
        floats = rows * (d + 4) + bn * (d + 4) + bn * d + rows * (bn + 4) + 3 * bn
        assert 4 * math.ceil(floats / 4) * 4 + rows * 56 <= 232448


BWD_CUH = CUH.parent / "flash_bwd_f32.cuh"
WMM_CU = CUH.parent / "wmatmul.cu"
SMEM_BLOCK, SMEM_SM = 232448, 233472  # bytes: a block's cap, an SM's


@pytest.mark.parametrize("d", (64, 128, 256))
def test_fp32_backward_tile_fits(d):
    """A Python mirror of csrc/flash_bwd_f32.cuh's Plan (BM 64 q rows, BN
    keys read from the source; Q, dO, K and V tiles of D + 4 floats a row,
    the P / dS buffer of BN + 4, LSE and delta): it fits a block's 227 KB
    at every D, two blocks share an SM below D 256 (as the kernel's
    __launch_bounds__ promises), and the thread tiles divide the block."""
    text = BWD_CUH.read_text()
    bm = int(re.search(r"constexpr int BM = (\d+);", text).group(1))
    edge, big, small = (int(x) for x in re.search(
        r"BN = D >= (\d+) \? (\d+) : (\d+);", text).groups())
    bn = big if d >= edge else small
    floats = 2 * bm * (d + 4) + 2 * bn * (d + 4) + bm * (bn + 4) + 2 * bm
    assert 4 * floats <= SMEM_BLOCK
    if d <= 128:
        assert 2 * (4 * floats + 1024) <= SMEM_SM
    assert bm % 16 == 0 and bn % 16 == 0 and bn // 16 in (2, 4) and d % 64 == 0
    # the split launch's q tiles and the fused launch's key blocks cover a
    # sequence: a key block's band walk (fb90::q_tiles) uses the same BM
    assert "q_tiles(kv0, BN, BM, a)" in text


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
