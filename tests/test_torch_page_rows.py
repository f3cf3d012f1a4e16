"""Kernels 6 and 8 on pages of any row count, and kernel 8 above 64 q heads a
kv head: the port's plain versions (its CPU route) against mfa_tpu's
paged kernels in Pallas interpret mode, on the same pages.

- paged decode (kernel 6) on bf16, int8 and fp8 pages of 1, 4 and 12 rows
  and int4 pages of 2, 6 and 12 (mfa_tpu's int4 pages pair tokens, so
  they hold an even count): the deferred-append query (pos_offset 1), a
  window whose edge falls inside a page and 3 sink tokens; at pages of 12
  also the kernel's split route over 3 splits, whose boundaries cut pages;
- paged prefill (kernel 8) on the same pages, causal with rows past
  q_lens, and at groups 65, 71 and 128 (hq 130 hkv 2, hq 71 hkv 1, hq 128
  hkv 1; d 64) with ALiBi.

Pages come from one seeded numpy draw: bf16 pages rounded once and handed
to both; quantized payloads and scales from mfa_tpu's quantizer (int4:
JAX packs token pairs, the port feature pairs, from the same values).
Tolerances: fp32 q on quantized pages atol = rtol = 1e-4; paged prefill's
output on quantized pages atol 2e-3 with a mean below 1e-5: p is rounded
to bf16 before P.V, and where the two frameworks' fp32 exp2 differ by an
ulp one p can round a bf16 ulp (2^-8 of p) apart, moving an output by up
to 2^-8 |v| / l (6.2e-4 seen here at one of 4096 values; the 5e-4 of
tests/test_torch_kv_formats.py:PREFILL_TOL holds for that file's inputs
only); bf16 pages 1e-2 (one bf16 rounding of the output on either side);
the split route 4e-3 (p rounded after each split's own max). LSE 1e-4
everywhere, -inf on the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill
from mfa_tpu.kernels.quant import pack_int4_pairs
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu_torch.kernels import paged
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.quant import FP8, pack_int4
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
PREFILL_TOL = dict(atol=2e-3, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FMT_PAGES = [(f, p) for f in ("bf16", "int8", "fp8") for p in (1, 4, 12)] + [
    ("int4", p) for p in (2, 6, 12)]


def _pages(rng, fmt, hkv, num_pages, page, d):
    """-> (jax k, v pages), (torch k, v pages), (k scales, v scales) or
    Nones, and the quant_dtype keyword."""
    kf, vf = (rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
              for _ in range(2))
    if fmt == "bf16":
        tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kf, vf))
        jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tk, tv))
        return (jk, jv), (tk, tv), (None, None), None
    (kq, ks), (vq, vs) = (jax_quantize(jnp.asarray(a), fmt) for a in (kf, vf))
    scales = (np.asarray(ks), np.asarray(vs))
    if fmt == "int8":
        tk, tv = (torch.from_numpy(np.array(a)) for a in (kq, vq))
        return (kq, vq), (tk, tv), scales, fmt
    if fmt == "fp8":
        tk, tv = (torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(FP8)
                  for a in (kq, vq))
        return (kq, vq), (tk, tv), scales, fmt
    jk, jv = (pack_int4_pairs(a.reshape(hkv, num_pages * page, d)).reshape(
        hkv, num_pages, page // 2, d) for a in (kq, vq))
    tk, tv = (pack_int4(torch.from_numpy(np.asarray(a))) for a in (kq, vq))
    return (jk, jv), (tk, tv), scales, fmt


def _q(rng, shape, fmt):
    q = rng.standard_normal(shape).astype(np.float32)
    if fmt == "bf16":
        tq = torch.from_numpy(q).to(torch.bfloat16)
        return jnp.asarray(tq.float().numpy(), jnp.bfloat16), tq
    return jnp.asarray(q), torch.from_numpy(q)


def _table(rng, b, pps, num_pages):
    # non-contiguous, shuffled physical pages; page 0 never used
    return (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(
        b, pps).astype(np.int32)


def _lse_close(tl, jl):
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], **TOL)


@pytest.mark.parametrize("fmt,page", FMT_PAGES)
def test_paged_decode_any_page_rows_matches_jax(fmt, page):
    rng = np.random.RandomState(page + 10 * len(fmt))
    b, hq, hkv, d = 3, 4, 2, 64
    # pages of 12: 192 table tokens, so 3 splits of 64 tokens cut pages;
    # pages of 1 fewer tokens (the interpreted kernel copies page by page)
    lens = np.array({12: [150, 0, 70], 1: [23, 0, 13]}.get(page, [37, 0, 21]),
                    np.int32)
    pps = {12: 16, 1: 24}.get(page, -(-40 // page))
    num_pages = b * pps + 1
    (jk, jv), (tk, tv), (ks, vs), quant = _pages(rng, fmt, hkv, num_pages, page, d)
    jq, tq = _q(rng, (b, hq, d), fmt)
    table = _table(rng, b, pps, num_pages)
    kw = dict(pos_offset=1, window_left=20, sink_tokens=3)
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    jo, jl = jax_paged(jq, jk, jv, jnp.asarray(lens), jnp.asarray(table),
                       quant_dtype=quant, return_lse=True,
                       **{k: jnp.asarray(v) for k, v in sc.items()}, **kw)
    t = torch.from_numpy
    to, tl = paged.paged_attention(tq, tk, tv, t(lens), t(table),
                                   quant_dtype=quant, return_lse=True,
                                   **{k: t(v) for k, v in sc.items()}, **kw)
    jo, jl = np.asarray(jo, np.float32), np.asarray(jl)
    tol = BF16_TOL if fmt == "bf16" else TOL
    np.testing.assert_allclose(to.float().numpy(), jo, **tol)
    _lse_close(tl.numpy(), jl)
    assert np.all(to.float().numpy()[1] == 0.0)  # the empty sequence
    if page == 12:  # split boundaries at 64 and 128 tokens cut pages 5 and 10
        so, sl = paged._paged_split_plain(
            tq, tk, tv, *(None if v is None else t(v) for v in (ks, vs)),
            t(lens), t(table), d ** -0.5, 20, 0.0, 1, num_splits=3,
            quant_dtype=quant, sinks=3)
        np.testing.assert_allclose(so.float().numpy(), jo,
                                   **(BF16_TOL if fmt == "bf16" else
                                      dict(atol=4e-3, rtol=0)))
        _lse_close(sl.numpy(), jl)


def _prefill_both(q, pages, lens, q_start, q_lens, table, **kw):
    (jq, tq), ((jk, jv), (tk, tv), (ks, vs), quant) = q, pages
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    jo, jl = jax_paged_prefill(
        jq, jk, jv, jnp.asarray(lens), jnp.asarray(q_start), jnp.asarray(table),
        q_lens=jnp.asarray(q_lens), quant_dtype=quant, return_lse=True,
        **{k: jnp.asarray(v) for k, v in sc.items()},
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    t = torch.from_numpy
    to, tl = paged_prefill_attention(
        tq, tk, tv, t(lens), t(q_start), t(table), q_lens=t(q_lens),
        quant_dtype=quant, return_lse=True, **{k: t(v) for k, v in sc.items()},
        **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    return (np.asarray(jo, np.float32), np.asarray(jl)), \
        (to.float().numpy(), tl.numpy())


def _prefill_close(jax_out, torch_out, q_lens, tol):
    (jo, jl), (to, tl) = jax_out, torch_out
    for i, r in enumerate(q_lens):  # rows past q_lens: O = 0, LSE = -inf
        np.testing.assert_allclose(to[i, :r], jo[i, :r], **tol)
        assert np.abs(to[i, :r] - jo[i, :r]).mean() < 1e-5 or tol is BF16_TOL
        _lse_close(tl[i, :, :r], jl[i, :, :r])
        assert np.all(to[i, r:] == 0) and np.all(np.isneginf(tl[i, :, r:]))


@pytest.mark.parametrize("fmt,page", FMT_PAGES)
def test_paged_prefill_any_page_rows_matches_jax(fmt, page):
    rng = np.random.RandomState(page + 10 * len(fmt) + 1)
    b, sq, hq, hkv, d = 2, 8, 4, 2, 64
    q_start, lens = np.array([13, 0], np.int32), np.array([21, 7], np.int32)
    q_lens = np.array([8, 5], np.int32)  # sequence 1: rows 5-7 are dead
    pps = -(-24 // page)
    num_pages = b * pps + 1
    pages = _pages(rng, fmt, hkv, num_pages, page, d)
    q = _q(rng, (b, sq, hq, d), fmt)
    table = _table(rng, b, pps, num_pages)
    got = _prefill_both(q, pages, lens, q_start, q_lens, table, window_left=6)
    tol = BF16_TOL if fmt == "bf16" else PREFILL_TOL
    _prefill_close(*got, q_lens, tol)


@pytest.mark.parametrize("hq,hkv,fmt", [(130, 2, "fp32"), (71, 1, "fp32"),
                                        (71, 1, "int8"), (128, 1, "bf16")])
def test_paged_prefill_groups_above_64_match_jax(hq, hkv, fmt):
    """Groups 65, 71 and 128 with ALiBi and rows past q_lens, pages of 16
    (fp32 pages: the same fp32 values to both)."""
    rng = np.random.RandomState(hq + hkv)
    b, sq, d, page = 2, 8, 64, 16
    q_start, lens = np.array([20, 3], np.int32), np.array([28, 9], np.int32)
    q_lens = np.array([8, 5], np.int32)
    pps, num_pages = 2, 6
    if fmt == "fp32":
        kf, vf = (rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
                  for _ in range(2))
        pages = ((jnp.asarray(kf), jnp.asarray(vf)),
                 (torch.from_numpy(kf), torch.from_numpy(vf)), (None, None), None)
    else:
        pages = _pages(rng, fmt, hkv, num_pages, page, d)
    q = _q(rng, (b, sq, hq, d), fmt)
    table = _table(rng, b, pps, num_pages)
    slopes = (0.5 ** (1 + rng.rand(hq) * 7)).astype(np.float32)
    got = _prefill_both(q, pages, lens, q_start, q_lens, table,
                        alibi_slopes=slopes)
    tol = {"fp32": TOL, "int8": PREFILL_TOL, "bf16": BF16_TOL}[fmt]
    _prefill_close(*got, q_lens, tol)
