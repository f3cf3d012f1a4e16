"""The fp32 decode of kernels 5 and 6 (csrc/decode_sm90.cuh with fp32 q) on
the CPU: its arithmetic and its layout.

The kernel cannot run here, so what it rests on is held instead:
- its arithmetic: the plain versions with both products formed as the tile
  forms them, against mfa_tpu's decode and paged kernels in Pallas
  interpret mode on seeded inputs. fp32 caches and pages: 3xTF32
  (backward._matmul_3xtf32_plain), within the fp32 kernels' limit (|o - r|
  <= 1e-4 + 1e-4 |r|, O and LSE: chip_smoke.py's _err32). int8, fp8 and
  int4 pages: q . k as three bf16 parts of q against the payload values,
  (lo + mid) + hi, and P V as the plain version forms it; O within 4e-3
  (the split route: p rounded to bf16 after each split's own max, as
  tests/test_torch_kv_formats.py holds it), LSE within 1e-4. Spans, a
  group of 16, a window with sinks, ALiBi and a dead row are covered;
- the passes on quantized pages: q's three bf16 parts add back to q, and
  every int8, fp8 and int4 payload value times each part is exact in fp32;
- its register mapping: S and P V formed from the fragments each lane
  reads out of the swizzled fp32 tiles (s_feat's feature pairs, tokens 2 t4
  and 2 t4 + 1 of P), and the 8-row blocks' two products with the lo parts
  in rows 8-15, equal Q K^T and P V, every one of those reads (and the
  bf16 parts' reads) free of bank conflicts.
"""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu.kernels.decode import decode_attention as jax_decode
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.quant import pack_int4_pairs
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu_torch.kernels import backward, decode, paged, wmatmul
from mfa_tpu_torch.kernels.quant import FP8, pack_int4
from tests.jax_maps import release_jax_code  # noqa: F401

CUH = pathlib.Path(mfa_tpu_torch.__file__).parent / "csrc" / "decode_sm90.cuh"
M3 = backward._matmul_3xtf32_plain


def _matmul_bf16x3(a, b):
    """a @ b as the tile forms q . k on quantized pages: a's three bf16
    parts, each product in fp32, (lo + mid) + hi (a bf16 a, such as the
    rounded p of P V, is its own hi: the other parts are zero)."""
    hi, mid, lo = (x.float() for x in wmatmul._split_bf16x3_plain(a.float()))
    return (lo @ b + mid @ b) + hi @ b


def _within(got, want, atol=1e-4, rtol=1e-4):
    """-> (within, largest excess) of |got - want| <= atol + rtol |want|; -inf
    where the reference is."""
    g, w = torch.as_tensor(got).double(), torch.as_tensor(np.array(want)).double()
    fin = torch.isfinite(w)
    assert torch.equal(fin, torch.isfinite(g))
    excess = float(((g[fin] - w[fin]).abs() - atol - rtol * w[fin].abs()).max())
    return excess <= 0, excess


def _slopes(hq):
    return (2.0 ** (-8.0 * np.arange(1, hq + 1) / hq)).astype(np.float32)


@pytest.mark.parametrize("hq,hkv,window,sinks,alibi", [
    (8, 2, -1, 0, False),  # the 8B's group of 4
    (16, 1, 40, 4, True)])  # a group of 16 (16-row blocks), window + sinks
def test_3xtf32_contiguous_decode_matches_mfa_tpu(hq, hkv, window, sinks, alibi):
    """Kernel 5's arithmetic on fp32 caches: _decode_partials_plain with its
    products in 3xTF32 over 2 splits and the combine, against mfa_tpu's
    decode in interpret mode (b3 S200 d64, lens 200 / 0 / 71: a dead row)."""
    rng = np.random.RandomState(40)
    b, S, d = 3, 200, 64
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, S, d)).astype(np.float32) for _ in range(2))
    lens = np.array([200, 0, 71], np.int32)
    sl = _slopes(hq) if alibi else None
    jo, jl = jax_decode(*(jnp.asarray(x) for x in (q, k, v, lens)), window_left=window,
                        sink_tokens=sinks, return_lse=True,
                        alibi_slopes=None if sl is None else jnp.asarray(sl))
    ns, tps = decode.split_layout(S, 2)
    t = torch.from_numpy
    po, pl = decode._decode_partials_plain(
        t(q), t(k), t(v), t(lens), d ** -0.5, ns, tps, window, 0.0, sinks,
        None if sl is None else t(sl), matmul=M3)
    o, lse = decode.combine_splits(po, pl, axis=2, return_lse=True)
    for got, want in ((o.reshape(b, hq, d), jo), (lse.reshape(b, hq), jl)):
        within, excess = _within(got, want)
        assert within, excess
    assert not o.reshape(b, hq, d)[1].any()


def _jax_pages(kf, vf, quant):
    """-> JAX's pages, the port's pages and the scales (numpy) of one
    quantization of fp32 pages kf, vf (None: the fp32 pages themselves).
    int4: JAX packs token pairs, the port feature pairs."""
    if quant is None:
        return (kf, vf), (torch.from_numpy(kf), torch.from_numpy(vf)), None, None
    (kq, ks), (vq, vs) = (jax_quantize(jnp.asarray(a), quant) for a in (kf, vf))
    ks, vs = np.asarray(ks), np.asarray(vs)
    if quant == "int8":
        return (kq, vq), tuple(torch.from_numpy(np.array(a)) for a in (kq, vq)), ks, vs
    if quant == "fp8":
        tk, tv = (torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(FP8)
                  for a in (kq, vq))
        return (kq, vq), (tk, tv), ks, vs
    hkv, P, page, d = kq.shape
    jk, jv = (pack_int4_pairs(a.reshape(hkv, P * page, d)).reshape(hkv, P, page // 2, d)
              for a in (kq, vq))
    tk, tv = (pack_int4(torch.from_numpy(np.array(a))) for a in (kq, vq))
    return (jk, jv), (tk, tv), ks, vs


@pytest.mark.parametrize("quant,span,hq,kw", [
    (None, 1, 8, dict(pos_offset=1)),  # the 8B serve step's shape
    (None, 3, 8, dict(window_left=20, sink_tokens=3)),  # a span: 16-row blocks
    ("int8", 1, 8, dict(pos_offset=1)),
    ("fp8", 3, 8, dict(window_left=20, sink_tokens=3)),
    ("int4", 1, 16, dict(pos_offset=1, alibi=True))])  # a group of 16
def test_tile_arithmetic_paged_matches_mfa_tpu(quant, span, hq, kw):
    """Kernel 6's arithmetic with fp32 q: _paged_split_plain over 3 splits
    with its products formed as the tile forms them (fp32 pages: 3xTF32;
    quantized pages: q's three bf16 parts) against mfa_tpu's paged kernel in
    interpret mode (hkv 2, d 64, pages of 16 over a shuffled table, lens 70 /
    0 / 33: a dead row)."""
    rng = np.random.RandomState(41)
    b, hkv, d, page, pps, n = 3, 2, 64, 16, 5, 20
    q = rng.standard_normal((b, span, hq, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((hkv, n, page, d)).astype(np.float32) for _ in range(2))
    table = (rng.permutation(n - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    lens = np.array([70, 0, 33], np.int32)
    (jk, jv), (tk, tv), ks, vs = _jax_pages(kf, vf, quant)
    kw = dict(kw)
    sl = _slopes(hq) if kw.pop("alibi", False) else None
    jkw = dict(kw)
    if quant is not None:
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), quant_dtype=quant)
    jo, jl = jax_paged(jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(lens),
                       jnp.asarray(table), return_lse=True,
                       alibi_slopes=None if sl is None else jnp.asarray(sl), **jkw)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    o, lse = paged._paged_split_plain(
        t(q), tk, tv, t(ks), t(vs), t(lens), t(table), d ** -0.5,
        kw.get("window_left", -1), 0.0, kw.get("pos_offset", 0), num_splits=3,
        quant_dtype=quant, sinks=kw.get("sink_tokens", 0), alibi=t(sl),
        matmul=M3 if quant is None else _matmul_bf16x3)
    within, excess = _within(o, jo, atol=1e-4 if quant is None else 4e-3,
                             rtol=1e-4 if quant is None else 0.0)
    assert within, excess
    within, excess = _within(lse, jl)
    assert within, excess
    assert not o[1].any() and bool(torch.isneginf(lse[1]).all())


def _e4m3_values():
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = bits.view(FP8).float()
    return vals[torch.isfinite(vals)]


def test_bf16_parts_of_q_times_payload_are_exact():
    """q's three bf16 parts (wmatmul._split_bf16x3_plain, as the kernel
    splits q once a block) add back to q, and each part times every int8,
    fp8 (e4m3) and int4 payload value is exact in fp32: the float32 product
    equals the float64 one (q over 1e-6 to 1e6 here: no product leaves
    fp32's normal range). So the three products lose nothing, and the sums
    are fp32 sums, as in the plain version."""
    rng = np.random.RandomState(42)
    q = torch.from_numpy(np.concatenate([
        rng.standard_normal(4000) * s for s in (1e-6, 1e-3, 1.0, 1e3, 1e6)
    ]).astype(np.float32))
    hi, mid, lo = wmatmul._split_bf16x3_plain(q)
    assert torch.equal((hi.double() + mid.double()) + lo.double(), q.double())
    payloads = {"int8": torch.arange(-127, 128, dtype=torch.float32),
                "fp8": _e4m3_values(),
                "int4": torch.arange(-8, 8, dtype=torch.float32)}
    for name, vals in payloads.items():
        for part in (hi, mid, lo):
            p32 = part.float()[:, None] * vals[None]
            p64 = part.double()[:, None] * vals.double()[None]
            assert torch.equal(p32.double(), p64), name


# -- the register mapping, from the source's own expressions

def _source_fn(name):
    """The one-line body `return ...;` of device function `name` in
    csrc/decode_sm90.cuh, as a Python expression."""
    src = CUH.read_text()
    m = re.search(name + r"\([^)]*\) \{\s*return (.*?);\s*\}", src, re.S)
    return " ".join(m.group(1).split())


def s_feat(kk, t4):
    return 32 * (kk >> 2) + 4 * (kk & 3) + 16 * (t4 >> 1) + 2 * (t4 & 1)


def swz32(rows, row, col):
    """Byte offset of fp32 (row, col) in a [D / 32][rows][32] swizzled tile."""
    return (col >> 5) * (rows * 128) + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) \
        + ((col & 3) << 2)


def test_mirrors_are_the_source():
    assert _source_fn("s_feat") == \
        "32 * (kk >> 2) + 4 * (kk & 3) + 16 * (t4 >> 1) + 2 * (t4 & 1)"
    assert _source_fn("swz32") == ("(col >> 5) * (ROWS * 128) + row * 128 + "
                                   "((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2)")


def _store(tile, rows):
    """A [rows, D] fp32 matrix -> its bytes in the swizzled layout (as
    float32 words)."""
    r, d = tile.shape
    buf = np.zeros(rows * d, np.float64)
    for i in range(r):
        for c in range(d):
            buf[swz32(rows, i, c) // 4] = tile[i, c]
    return buf


def _banks(words, width):
    return [(w + i) % 32 for w in words for i in range(width)]


@pytest.mark.parametrize("d,tt", [(64, 64), (128, 64), (256, 32)])
def test_fp32_fragments_form_qk_and_pv(d, tt):
    """S and O of one warp from its lanes' reads of the swizzled tiles: the
    m16n8k8 fragments (A[g][t4] / A[g][t4 + 4], B[t4][g] / B[t4 + 4][g],
    C[g][2 t4 (+ 1)], rows g + 8 in a1 / a3 / c2 / c3) at s_feat's features
    for S and tokens 2 t4, 2 t4 + 1 of each 8 for P, summed exactly, equal
    Q K^T and P V; without M16 the two products with q_lo (p_lo) in rows
    8-15 give lo.hi + hi.lo + hi.hi. Every K, Q and V read of a half warp
    (8-byte) or warp (4-byte) covers the 32 banks once."""
    rng = np.random.RandomState(43)
    rows_q = 16
    qm = rng.randint(-8, 8, (rows_q, d)).astype(np.float64)
    km = rng.randint(-8, 8, (tt, d)).astype(np.float64)
    vm = rng.randint(-8, 8, (tt, d)).astype(np.float64)
    kb, qb, vb = _store(km, tt), _store(qm, rows_q), _store(vm, tt)
    lanes = [(ln >> 2, ln & 3) for ln in range(32)]
    for row0 in range(0, tt, 16):
        s = np.zeros((16, 16))  # rows x the warp's 16 tokens
        for kk in range(d // 8):
            for j in range(2):
                am, bm, kwords, qwords = np.zeros((16, 8)), np.zeros((8, 8)), [], []
                for g, t4 in lanes:
                    f = s_feat(kk, t4)
                    ko = swz32(tt, row0 + 8 * j + g, f) // 4
                    bm[t4, g], bm[t4 + 4, g] = kb[ko], kb[ko + 1]
                    kwords.append(ko)
                    for r in (g, g + 8):  # a0 / a1 (slot t4), a2 / a3 (slot t4 + 4)
                        qo = swz32(rows_q, r, f) // 4
                        am[r, t4], am[r, t4 + 4] = qb[qo], qb[qo + 1]
                    qwords.append(swz32(rows_q, g, f) // 4)
                s[:, 8 * j:8 * j + 8] += am @ bm
                for words in (kwords, qwords):
                    for half in (words[:16], words[16:]):
                        assert sorted(_banks(half, 2)) == list(range(32))
        np.testing.assert_array_equal(s, qm @ km[row0:row0 + 16].T)
        # P V: p of lane (g, t4) for tokens 8 j + 2 t4 + e sits in its own
        # S accumulator c[e] (row g) / c[2 + e] (row g + 8)
        p = rng.randint(-4, 5, (16, 16)).astype(np.float64)
        o = np.zeros((16, d))
        for j in range(2):
            am = np.zeros((16, 8))
            for g, t4 in lanes:
                for r in (g, g + 8):
                    am[r, t4], am[r, t4 + 4] = p[r, 8 * j + 2 * t4], p[r, 8 * j + 2 * t4 + 1]
            for n in range(d // 8):
                bm, words = np.zeros((8, 8)), ([], [])  # b0's and b1's reads: two instructions
                for g, t4 in lanes:
                    vo = [swz32(tt, row0 + 8 * j + 2 * t4 + e, 8 * n + g) // 4 for e in (0, 1)]
                    bm[t4, g], bm[t4 + 4, g] = vb[vo[0]], vb[vo[1]]
                    words[0].append(vo[0])
                    words[1].append(vo[1])
                o[:, 8 * n:8 * n + 8] += am @ bm  # C[r][c]: feature 8 n + c
                for w in words:
                    assert sorted(_banks(w, 1)) == list(range(32))
        np.testing.assert_array_equal(o, p @ vm[row0:row0 + 16])
    # the 8-row blocks: rows 0-7 of A hold q_hi, rows 8-15 q_lo (the first
    # product with zeros there) -> C rows 0-7 + C rows 8-15 = the three terms
    a = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    bt = torch.from_numpy(rng.standard_normal((d, 16)).astype(np.float32))
    (ah, al), (bh, bl) = (backward._split_tf32_plain(x) for x in (a, bt))
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    first = torch.cat([ah, torch.zeros_like(ah)]) @ bl
    second = torch.cat([ah, al]) @ bh
    c = first + second
    torch.testing.assert_close(c[8:] + c[:8], (al @ bh + ah @ bl) + ah @ bh,
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("d", (64, 128, 256))
def test_bf16_part_words_are_conflict_free(d):
    """The bf16 parts of fp32 q in shared memory ([3][16 rows][QW words], QW
    read from the source): a half warp's 8-byte reads of one part, row g (or
    g + 8) and k step kk cover the 32 banks once."""
    m = re.search(r"QW = D / 2 \+ (\d+);", CUH.read_text())
    qw = d // 2 + int(m.group(1))
    for p in range(3):
        for kk in range(d // 16):
            for h in (0, 8):
                words = [(p * 16 + (ln >> 2) + h) * qw + 8 * kk + 2 * (ln & 3)
                         for ln in range(32)]
                for half in (words[:16], words[16:]):
                    assert sorted(_banks(half, 2)) == list(range(32))
