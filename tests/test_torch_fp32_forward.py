"""The 64-row fp32 forward tile of csrc/flash_fwd_f32.cuh (kernels 1-4, 7
and 9, and kernel 8 in paged_prefill.cu) on the CPU: its arithmetic and
its layout.

The kernel cannot run here, so what it rests on is held instead:
- its arithmetic: the plain versions with both products in 3xTF32 as the
  tile forms them (backward._matmul_3xtf32_plain: lo passed whole, the
  tensor core reading its TF32 bits) against mfa_tpu in Pallas interpret
  mode on seeded inputs, within the fp32 kernels' limit (|o - r| <= 1e-4 + 1e-4
  |r|, O and LSE: chip_smoke.py's _err32), and one TF32 pass outside it;
  the zero-shift flags under 3xTF32 equal plain fp32's on the smoke's
  std-1e3 and shifted inputs;
- the passes it drops on quantized pages: every int8, fp8 and int4 payload
  value and every bf16-rounded p has a zero lo part (exact in TF32, and in
  bf16);
- its register mapping: S and P V formed from the fragments each lane
  reads out of the shared-memory layouts the tile uses (Q, K and V as fp32
  rows split as read, or V as bf16 key pairs on quantized pages; P from
  the S accumulators with keys 2t, 2t + 1 in k slots t, t + 4) equal Q K^T
  and P V;
- its shared-memory plan, read from the source: every kind fits a block at
  D 64 / 128 / 256 and every fragment access is free of bank conflicts.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu_torch.kernels import backward, paged_prefill, prefill
from tests.jax_maps import release_jax_code  # noqa: F401

CUH = pathlib.Path(mfa_tpu_torch.__file__).parent / "csrc" / "flash_fwd_f32.cuh"
SMEM_BLOCK, SMEM_SM = 232448, 233472  # bytes: a block's cap, an SM's
ROW_BYTES, BOUNDS_BYTES = 56, 16  # sizeof(af32::Row), sizeof(af32::Bounds)
M3 = backward._matmul_3xtf32_plain


def _tf32_1pass(a, b):
    """One TF32 pass (hi.hi only), the product 3xTF32 improves on."""
    return backward._split_tf32_plain(a)[0] @ backward._split_tf32_plain(b)[0]


def _within(got, want, tol=1e-4):
    """chip_smoke._err32's limit -> (within, largest excess)."""
    g, w = torch.as_tensor(got).double(), torch.as_tensor(np.array(want)).double()
    fin = torch.isfinite(w)
    assert torch.equal(fin, torch.isfinite(g))
    excess = float(((g[fin] - w[fin]).abs() - tol - tol * w[fin].abs()).max())
    return excess <= 0, excess


def _dense(seed, b, hq, hkv, s, d, amp=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((b, hq, s, d)) * amp).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * amp).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _jax_prefill(q, k, v, window):
    import jax.numpy as jnp

    from mfa_tpu.kernels.prefill import prefill_attention as jprefill

    o, lse = jprefill(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                      window_size=window, return_lse=True)
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("b,s,d,window", [
    (1, 256, 64, (-1, 0)), (2, 128, 128, (-1, 0)), (1, 192, 128, (47, 0))])
def test_3xtf32_prefill_matches_mfa_tpu(b, s, d, window):
    """Kernel 1's arithmetic on the tile: _prefill_plain with its two
    products in 3xTF32 within the fp32 limit of mfa_tpu's prefill in
    interpret mode (hq 4, hkv 2), O and LSE."""
    q, k, v = _dense(25, b, 4, 2, s, d)
    jo, jl = _jax_prefill(q, k, v, window)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = prefill._prefill_plain(*t, d ** -0.5, window[0], window[1], 0.0, True,
                                    matmul=M3)
    for got, want in ((o, jo), (lse, jl)):
        within, excess = _within(got, want)
        assert within, excess


def test_one_tf32_pass_breaks_the_forward_limit():
    """Why three products: on a seeded causal input (b1 hq4 hkv2 s256 d128)
    one TF32 pass (hi.hi) misses the fp32 limit against mfa_tpu, in O and
    in the LSE, and 3xTF32 keeps it."""
    q, k, v = _dense(26, 1, 4, 2, 256, 128)
    jo, jl = _jax_prefill(q, k, v, (-1, 0))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    args = (*t, 128 ** -0.5, -1, 0, 0.0, True)
    one_o, one_l = prefill._prefill_plain(*args, matmul=_tf32_1pass)
    three_o, three_l = prefill._prefill_plain(*args, matmul=M3)
    assert not _within(one_o, jo)[0] and not _within(one_l, jl)[0]
    assert _within(three_o, jo)[0] and _within(three_l, jl)[0]


@pytest.mark.parametrize("kind", ("benign", "overflow", "flush"))
def test_3xtf32_zero_shift_flags_equal_plain(kind):
    """Kernels 2 and 4's zero shift under 3xTF32: on chip_smoke.py's inputs
    at a small size (b2 hq4 hkv2 s256 d128, causal; "overflow": q and k x
    1e3, "flush": q + 40, k - 40) its poison flags equal plain fp32's (none
    on benign inputs, some on the others), and on benign inputs its O and
    LSE are within the fp32 limit of mfa_tpu's prefill."""
    q, k, v = _dense(27, 2, 4, 2, 256, 128)
    if kind == "overflow":
        q, k = q * 1e3, k * 1e3
    elif kind == "flush":
        q, k = q + 40.0, k - 40.0
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse, flags = prefill._zero_shift_plain(*t, 128 ** -0.5, -1, 0, matmul=M3)
    _, _, want = prefill._zero_shift_plain(*t, 128 ** -0.5, -1, 0)
    assert torch.equal(flags, want)
    assert (int(flags.sum()) == 0) == (kind == "benign")
    if kind == "benign":
        jo, jl = _jax_prefill(q, k, v, (-1, 0))
        assert _within(o, jo)[0] and _within(lse, jl)[0]


@pytest.mark.parametrize("pages", ("fp32", "int8"))
def test_3xtf32_paged_prefill_matches_mfa_tpu(pages):
    """Kernel 8's arithmetic: _paged_prefill_plain in 3xTF32 against
    mfa_tpu's paged prefill in interpret mode on a chunk batch (2 chunks of
    32 at q_start 32 / 0, hq 8 hkv 2 d 128, pages of 16 over a shuffled
    table): fp32 pages within the fp32 limit, int8 pages (fp32 q: S in two
    TF32 passes, P V exact) within the bf16-q case's limits (max 2e-2,
    mean 2e-3; the real rows)."""
    import jax.numpy as jnp

    from mfa_tpu.kernels.paged_prefill import paged_prefill_attention as jpp
    from mfa_tpu.kernels.quant import quantize_rows as jq

    rng = np.random.RandomState(28)
    b, sq, hq, hkv, d, page, pps = 2, 32, 8, 2, 128, 16, 6
    n = b * pps + 3
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((hkv, n, page, d)).astype(np.float32) for _ in range(2))
    table = (rng.permutation(n - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    q_start, lens = np.array([32, 0], np.int32), np.array([64, 20], np.int32)
    ql = lens - q_start
    jkw, scales = {}, (None, None)
    if pages == "int8":
        (kp, ks), (vp, vs) = ((np.array(a) for a in jq(jnp.asarray(x), "int8")) for x in (kp, vp))
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), quant_dtype="int8")
        scales = (torch.from_numpy(ks), torch.from_numpy(vs))
    jo, jl = jpp(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
                 jnp.asarray(q_start), jnp.asarray(table), q_lens=jnp.asarray(ql),
                 causal=True, return_lse=True, **jkw)
    o, lse = paged_prefill._paged_prefill_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), *scales,
        torch.from_numpy(lens), torch.from_numpy(q_start), torch.from_numpy(ql),
        torch.from_numpy(table), d ** -0.5, -1, 0, 0.0, "int8" if pages == "int8" else None,
        matmul=M3)
    real = torch.arange(sq)[None, :] < torch.from_numpy(ql)[:, None]  # [b, sq]
    got, want = o[real], torch.from_numpy(np.asarray(jo))[real]
    if pages == "fp32":
        assert _within(got, want)[0]
        assert _within(lse.permute(0, 2, 1)[real],
                       torch.from_numpy(np.asarray(jl)).permute(0, 2, 1)[real])[0]
    else:
        err = (got - want).abs()
        assert float(err.max()) < 2e-2 and float(err.mean()) < 2e-3


def test_payload_values_and_bf16_p_are_exact_in_tf32():
    """The passes the tile drops on quantized pages: _split_tf32_plain's lo
    part is exactly 0 (hi the value itself) for every int8 value, every
    finite fp8 e4m3 code, every int4 value, and for p rounded to bf16 after
    a V scale is folded in; and each such value is exact in bf16 too (the
    bf16 P V product)."""
    e4m3 = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float()
    rng = np.random.RandomState(29)
    p = torch.from_numpy(rng.uniform(0, 1, 4096).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-1, 4096).astype(np.float32))
    for x in (torch.arange(-128, 128).float(), e4m3[torch.isfinite(e4m3)],
              torch.arange(-8, 8).float(), (p * scale).bfloat16().float()):
        hi, lo = backward._split_tf32_plain(x)
        assert torch.equal(hi, x) and bool((lo == 0).all())
        assert torch.equal(x.bfloat16().float(), x)


# -- the tile's plan and layouts, read from the source --------------------------


def _cexpr(expr, env):
    """Evaluate a C++ constant expression of ints, bools, + - * /, ==,
    parentheses and nested ?: in `env`."""
    expr = expr.strip()
    while True:  # innermost parentheses first
        m = re.search(r"\(([^()]*)\)", expr)
        if not m:
            break
        expr = expr[:m.start()] + repr(_cexpr(m.group(1), env)) + expr[m.end():]
    depth, q = 0, -1
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
            break
    if q < 0:
        py = re.sub(r"(?<![/])/(?![/])", "//", expr)
        return eval(py.replace("true", "True").replace("false", "False"), {}, dict(env))
    depth, nest = 0, 0
    for j in range(q + 1, len(expr)):
        ch = expr[j]
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if nest == 0:
                return _cexpr(expr[q + 1:j], env) if _cexpr(expr[:q], env) \
                    else _cexpr(expr[j + 1:], env)
            nest -= 1
    raise ValueError(expr)


def _plan(d, quant):
    """csrc/flash_fwd_f32.cuh's TcPlan<D, QUANT>, each constant evaluated
    from its line in the source."""
    text = CUH.read_text()
    body = re.search(r"struct TcPlan \{(.*?)\n\};", text, re.S).group(1)
    env = {"D": d, "QUANT": quant}
    for name, expr in re.findall(r"static constexpr (?:int|bool) (\w+) = ([^;]+);", body):
        env[name] = _cexpr(expr, env)
    assert "bar_bytes = (size_t)row_off * 4 + RM * sizeof(Row);" in body
    assert "bytes = bar_bytes + 4 * 8;" in body  # the ring's four mbarriers
    env["bytes"] = env["row_off"] * 4 + env["RM"] * ROW_BYTES + 32
    return env


def _conflict_free(words, width=1):
    """A warp's shared-memory access of `width` words a lane (lane order):
    every phase (32 / width lanes) touches each of the 32 banks once."""
    per = 32 // width
    for h in range(0, 32, per):
        banks = [(w + i) % 32 for w in words[h:h + per] for i in range(width)]
        if len(set(banks)) != 32:
            return False
    return True


LANES = [(ln >> 2, ln & 3) for ln in range(32)]  # (g, t)


@pytest.mark.parametrize("d", (64, 128, 256))
def test_fp32_forward_tile_fits_and_is_conflict_free(d):
    """A Python mirror of the 64-row tile's plan (TcPlan, read from the
    source): 8 warps as 4 row groups of 16 x 2 feature halves, whole n-tiles
    and 16-key slabs; every kind fits a block's 227 KB beside the static
    Bounds with its two ring slots (two blocks an SM where the plan says so),
    fp32 (kernels 1-4, 7, 9 and 8 on fp32
    pages: K and V rows and the columns' run ids a slot) and quantized
    (kernel 8: bytes and scales a slot, and the converted tile); and every
    shared-memory access of the products is free of bank conflicts: the
    8-byte reads of Q's and K's rows (banks 8g + 2t), the 4-byte reads of
    V's rows 2t and 2t + 1 (banks 8t + g), the bf16 V pairs' 8-byte reads
    (banks 8t + 2g), the exchange's float2 writes and reads, and the
    conversion pass's stores."""
    text = CUH.read_text()
    assert "constexpr int THREADS = 256;  // 8 warps" in text
    assert "rg = warp >> 1, cg = warp & 1, r0 = 16 * rg" in text
    for quant in (False, True):
        p = _plan(d, quant)
        bn, hd, nt, no = p["BN"], p["HD"], p["NT"], p["NO"]
        assert p["RM"] == 64 and hd * 2 == d and nt * 8 == bn and no * 8 == hd
        assert bn % 16 == 0
        assert p["bytes"] + BOUNDS_BYTES <= SMEM_BLOCK, (quant, p["bytes"])
        # BLOCKS resident an SM: each with its 1 KB of the SM's reserve
        assert p["BLOCKS"] * (p["bytes"] + BOUNDS_BYTES + 1024) <= SMEM_SM
        assert all(p[k] % 4 == 0 for k in ("ring_off", "kp_off", "vp_off", "e_off",
                                           "sc_off", "row_off", "SLOT"))
        qs, ks, vs, es = p["QS"], p["KS"], p["VS"], p["ES"]
        # a ring slot: K rows, V rows and ids, or the bytes and 2 BN scales
        need = 2 * bn * d + 8 * bn if quant else 4 * (bn * (ks + vs) + bn)
        assert 4 * p["SLOT"] == need and ks >= d and (quant or vs >= d)
        for cg in (0, 1):
            for r0 in range(0, 64, 16):
                for kk in range(cg * hd, cg * hd + hd, 8):
                    for r8 in (0, 8):  # Q's A fragment
                        assert _conflict_free([(r0 + g + r8) * qs + kk + 2 * t
                                               for g, t in LANES], 2)
                    for j in range(nt):  # K's B fragment
                        assert _conflict_free([(8 * j + g) * ks + kk + 2 * t
                                               for g, t in LANES], 2)
                for j in range(nt):  # the exchange, written and read as float2
                    for r8 in (0, 8):
                        assert _conflict_free([(r0 + g + r8) * es + 8 * j + 2 * t
                                               for g, t in LANES], 2)
            for n in range(no):  # V's B fragment
                c0 = cg * hd + 8 * n
                if quant:
                    for s2 in range(nt // 2):
                        assert _conflict_free([(4 * s2 + t) * vs + 2 * (c0 + g)
                                               for g, t in LANES], 2)
                else:
                    for j in range(nt):
                        for k1 in (0, 1):
                            assert _conflict_free([(8 * j + 2 * t + k1) * vs + c0 + g
                                                   for g, t in LANES])
        if quant:  # the conversion pass: 32 consecutive threads
            for i0 in range(0, bn * d // 4, 32):
                assert _conflict_free([(i // (d // 4)) * ks + 4 * (i % (d // 4))
                                       for i in range(i0, i0 + 32)], 4)
            for i0 in range(0, bn // 4 * d, 32):
                assert _conflict_free([(i // d) * vs + 2 * (i % d) for i in range(i0, i0 + 32)], 2)


def _mma_k8(a_regs, b_regs):
    """m16n8k8 from the lanes' registers: a0..a3 = A[g][t], A[g + 8][t],
    A[g][t + 4], A[g + 8][t + 4]; b0, b1 = B[t][g], B[t + 4][g]."""
    a, b = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64)
    for (g, t), ar, br in zip(LANES, a_regs, b_regs):
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = ar
        b[t, g], b[t + 4, g] = br
    return a @ b


def _mma_k16(a_regs, b_regs):
    """m16n8k16 (bf16 pairs, low half first) from the lanes' registers:
    a0..a3 = A[g][2t, 2t + 1], A[g + 8][2t, ..], A[g][2t + 8, ..], A[g +
    8][2t + 8, ..]; b0, b1 = B[2t, 2t + 1][g], B[2t + 8, 2t + 9][g]."""
    a, b = torch.zeros(16, 16, dtype=torch.float64), torch.zeros(16, 8, dtype=torch.float64)
    for (g, t), ar, br in zip(LANES, a_regs, b_regs):
        for i, (row, k) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                      (g + 8, 2 * t + 8))):
            a[row, k], a[row, k + 1] = ar[i]
        b[2 * t, g], b[2 * t + 1, g] = br[0]
        b[2 * t + 8, g], b[2 * t + 9, g] = br[1]
    return a @ b


@pytest.mark.parametrize("product", ("S", "PV fp32", "PV quant"))
def test_fragment_reads_form_the_products(product):
    """The tile's register mapping at D 64, on small integers (every product
    exact): the fragments each lane reads out of the tile's layouts (Q and
    K rows, features kk + 2t, + 1 in k slots t, t + 4 of both; V's rows 2t
    and 2t + 1 of each 8-key slab, or its bf16 pairs of keys 16 s + 2t, + 1
    and + 8, + 9; P from the S accumulators, keys 2t, 2t + 1 in k slots t,
    t + 4, or two n-tiles as one bf16 k16 slab), fed through m16n8k8 /
    m16n8k16's operand layout, give Q K^T and P V."""
    d = 64
    p = _plan(d, product == "PV quant")
    bn, qs, ks, vs = p["BN"], p["QS"], p["KS"], p["VS"]
    rng = np.random.RandomState(30)
    q = torch.from_numpy(rng.randint(-4, 5, (16, d)).astype(np.float64))
    k = torch.from_numpy(rng.randint(-4, 5, (bn, d)).astype(np.float64))
    pm = torch.from_numpy(rng.randint(0, 5, (16, bn)).astype(np.float64))
    v = torch.from_numpy(rng.randint(-4, 5, (bn, d)).astype(np.float64))
    if product == "S":
        qf = torch.zeros(16 * qs, dtype=torch.float64)
        kf = torch.zeros(bn * ks, dtype=torch.float64)
        qf.view(16, qs)[:, :d], kf.view(bn, ks)[:, :d] = q, k
        got = torch.zeros(16, bn, dtype=torch.float64)
        for j in range(p["NT"]):
            for kk in range(0, d, 8):
                a_regs, b_regs = [], []
                for g, t in LANES:
                    a, b = qf[g * qs + kk + 2 * t:][:2], qf[(g + 8) * qs + kk + 2 * t:][:2]
                    a_regs.append((a[0], b[0], a[1], b[1]))
                    x = kf[(8 * j + g) * ks + kk + 2 * t:][:2]
                    b_regs.append((x[0], x[1]))
                got[:, 8 * j:8 * j + 8] += _mma_k8(a_regs, b_regs)
        assert torch.equal(got, q @ k.T)
        return
    # the S accumulator fragments of P: c0, c1 = P[g][8j + 2t, + 1], c2, c3 row g + 8
    acc = [[(pm[g, 8 * j + 2 * t], pm[g, 8 * j + 2 * t + 1], pm[g + 8, 8 * j + 2 * t],
             pm[g + 8, 8 * j + 2 * t + 1]) for g, t in LANES] for j in range(p["NT"])]
    got = torch.zeros(16, d, dtype=torch.float64)
    if product == "PV fp32":
        vf = torch.zeros(bn * vs, dtype=torch.float64)
        vf.view(bn, vs)[:, :d] = v
        for n in range(d // 8):
            for j in range(p["NT"]):
                a_regs = [(c[0], c[2], c[1], c[3]) for c in acc[j]]
                b_regs = [(vf[(8 * j + 2 * t) * vs + 8 * n + g],
                           vf[(8 * j + 2 * t + 1) * vs + 8 * n + g]) for g, t in LANES]
                got[:, 8 * n:8 * n + 8] += _mma_k8(a_regs, b_regs)
    else:
        words = {}  # (row (s, t), column, half) -> (key, key + 1)
        for st in range(p["VR"]):
            s, t = st >> 2, st & 3
            for c in range(d):
                words[st, c, 0] = (v[16 * s + 2 * t, c], v[16 * s + 2 * t + 1, c])
                words[st, c, 1] = (v[16 * s + 2 * t + 8, c], v[16 * s + 2 * t + 9, c])
        for n in range(d // 8):
            for s2 in range(p["NT"] // 2):
                a_regs = [((c0[0], c0[1]), (c0[2], c0[3]), (c1[0], c1[1]), (c1[2], c1[3]))
                          for c0, c1 in zip(acc[2 * s2], acc[2 * s2 + 1])]
                b_regs = [(words[4 * s2 + t, 8 * n + g, 0], words[4 * s2 + t, 8 * n + g, 1])
                          for g, t in LANES]
                got[:, 8 * n:8 * n + 8] += _mma_k16(a_regs, b_regs)
    assert torch.equal(got, pm @ v)
