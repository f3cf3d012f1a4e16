"""The port's paged decode (plain path on CPU) against mfa_tpu's paged
kernel in Pallas interpret mode: fp32, bf16 and int8 pages, the
deferred-append query position (pos_offset=1) with LSE, sliding window,
and non-contiguous block tables. Inputs from numpy with a seed.
Tolerances: fp32 and int8-with-fp32-q outputs atol = rtol = 1e-4 (same
function; int8 payloads and scales are identical inputs to both); bf16
pages 1e-2 (one bf16 rounding of the output on either side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu_torch.kernels.paged import paged_attention
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _case(seed, b=3, hq=8, hkv=2, pages=24, page=16, d=64, pps=5):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    # non-contiguous, shuffled physical pages per sequence
    table = (rng.permutation(pages - 1)[: b * pps] + 1).reshape(b, pps)
    lens = np.array([70, 0, 33][:b], np.int32)
    return q, kp, vp, table.astype(np.int32), lens


def _run_both(q, kp, vp, table, lens, ks=None, vs=None, **kw):
    jkw = dict(kw)
    if ks is not None:
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                   quant_dtype="int8")
    jo, jl = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(lens), jnp.asarray(table),
                       return_lse=True, **jkw)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    to, tl = paged_attention(t(q), t(kp), t(vp), t(lens), t(table),
                             k_scales=t(ks), v_scales=t(vs), return_lse=True,
                             **kw)
    return (np.asarray(jo, np.float32), np.asarray(jl)), \
        (to.float().numpy(), tl.numpy())


def _check_lse(tl, jl):
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], **TOL)


@pytest.mark.parametrize("pos_offset,window_left,softcap",
                         [(0, -1, 0.0), (1, -1, 0.0), (1, 20, 0.0),
                          (1, -1, 15.0)])
def test_paged_fp32_pages_match_jax(pos_offset, window_left, softcap):
    q, kp, vp, table, lens = _case(0)
    (jo, jl), (to, tl) = _run_both(q, kp, vp, table, lens,
                                   pos_offset=pos_offset,
                                   window_left=window_left,
                                   logit_softcap=softcap)
    np.testing.assert_allclose(to, jo, **TOL)
    _check_lse(tl, jl)
    assert np.all(to[1] == 0.0)  # the empty sequence


def test_paged_int8_pages_match_jax():
    q, kp, vp, table, lens = _case(1)
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(kp), "int8"))
    vq, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(vp), "int8"))
    (jo, jl), (to, tl) = _run_both(q, kq, vq, table, lens, ks, vs,
                                   pos_offset=1)
    np.testing.assert_allclose(to, jo, **TOL)
    _check_lse(tl, jl)


def test_paged_bf16_pages_match_jax():
    q, kp, vp, table, lens = _case(2)
    to_bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    jo, jl = jax_paged(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
                       jnp.asarray(vp, jnp.bfloat16), jnp.asarray(lens),
                       jnp.asarray(table), pos_offset=1, return_lse=True)
    bf = lambda a: torch.from_numpy(to_bf16(a).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    to, tl = paged_attention(bf(q), bf(kp), bf(vp), torch.from_numpy(lens),
                             torch.from_numpy(table), pos_offset=1,
                             return_lse=True)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=1e-2, rtol=1e-2)
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                               atol=1e-3, rtol=1e-3)


def test_flash_attn_with_kvcache_paged_matches_jax():
    from mfa_tpu.interface import flash_attn_with_kvcache as jax_kvcache

    q, kp, vp, table, lens = _case(3)
    q4 = q[:, None]
    # reference pool layout [num_pages, page, hkv, d]
    kr, vr = kp.transpose(1, 2, 0, 3).copy(), vp.transpose(1, 2, 0, 3).copy()
    jo = jax_kvcache(jnp.asarray(q4), jnp.asarray(kr), jnp.asarray(vr),
                     cache_seqlens=jnp.asarray(lens),
                     block_table=jnp.asarray(table))
    to = mfa_tpu_torch.flash_attn_with_kvcache(
        torch.from_numpy(q4), torch.from_numpy(kr), torch.from_numpy(vr),
        cache_seqlens=torch.from_numpy(lens),
        block_table=torch.from_numpy(table))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_paged_rejects_what_is_not_ported(monkeypatch):
    q, kp, vp, table, lens = _case(4)
    args = [torch.from_numpy(a) for a in (q, kp, vp, lens, table)]
    span_q = torch.stack([args[0]] * 4, 1)  # q_span 4
    with pytest.raises(ValueError):  # a window shorter than the span
        paged_attention(span_q, *args[1:], pos_offset=4, window_left=3)
    for fn, t in ((paged_attention, torch.from_numpy),
                  (jax_paged, jnp.asarray)):  # raises in both packages
        with pytest.raises(ValueError):
            fn(*(t(a) for a in (q, kp, vp, lens, table)), logit_softcap=5.0,
               alibi_slopes=t(np.ones(q.shape[1], np.float32)))
    with pytest.raises(ValueError):
        paged_attention(*args, pos_offset=1, window_left=0)
    # the card's route, on meta tensors (nothing built or run): pages of
    # any row count at any head_dim, and fp32 q and pages, are taken (the C
    # launch replaced by a stub that reports success)
    from mfa_tpu_torch.kernels import _build, paged

    monkeypatch.setattr(_build, "function", lambda lib, name, argtypes: lambda *a: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)

    def meta(d, page, dtype):
        q = torch.empty(2, 8, d, dtype=dtype, device="meta")
        pages = torch.empty(2, 5, page, d, dtype=dtype, device="meta")
        ints = torch.empty(2, dtype=torch.int32, device="meta")
        table = torch.empty(2, 2, dtype=torch.int32, device="meta")
        return q, pages, pages, None, None, ints, table, 0.1, -1, 0.0, 0

    for d in (80, 128):
        for page in (1, 4, 12):
            _build.reset_launches()
            out, lse = paged._paged_cuda(*meta(d, page, torch.bfloat16))
            assert out.dtype == torch.bfloat16 and out.shape == (2, 8, d)
            assert _build.launches["paged"] == 1
        _build.reset_launches()
        out, lse = paged._paged_cuda(*meta(d, 16, torch.float32))
        assert out.dtype == torch.float32 and out.shape == (2, 8, d)
        assert _build.launches["paged_fp32"] == 1
    _build.reset_launches()


def _split_case(seed, quant=False):
    """b3 hq8 hkv2 d64, pages of 32, 16 table entries (8 tiles of 64)."""
    q, kp, vp, table, _ = _case(seed, pages=49, page=32, pps=16)
    lens = np.array([500, 0, 200], np.int32)
    if not quant:
        return q, kp, vp, table, lens, None, None
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(kp), "int8"))
    vq, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(vp), "int8"))
    return q, kq, vq, table, lens, ks, vs


@pytest.mark.parametrize("num_splits,window_left,softcap,quant", [
    (1, -1, 0.0, False), (2, 100, 0.0, False), (3, -1, 10.0, False),
    (4, 300, 0.0, False), (4, -1, 0.0, False), (3, 200, 0.0, True),
])
def test_paged_split_route_matches_plain_and_jax(num_splits, window_left,
                                                 softcap, quant):
    """The kernel's split route on the CPU (partials over each split's
    table entries, then the combine) against the one-pass plain version and
    mfa_tpu's paged kernel in interpret mode, fp32 q, pos_offset=1. fp32
    pages: 1e-4 (the same function). int8 pages round p to bf16 before P.V
    after subtracting each split's own max, so outputs agree to 2^-8 (4e-3)
    there; the LSE sums unrounded p and keeps 1e-4."""
    from mfa_tpu_torch.kernels import paged

    q, kp, vp, table, lens, ks, vs = _split_case(5, quant)
    kw = dict(pos_offset=1, window_left=window_left, logit_softcap=softcap)
    (jo, jl), (to, tl) = _run_both(q, kp, vp, table, lens, ks, vs, **kw)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    so, sl = paged._paged_split_plain(t(q), t(kp), t(vp), t(ks), t(vs), t(lens),
                                      t(table), 64 ** -0.5, window_left, softcap,
                                      1, num_splits=num_splits)
    n, _ = paged.decode.split_layout(16 * 32, num_splits)
    assert n == num_splits
    out_tol = dict(atol=4e-3, rtol=0) if quant else TOL
    np.testing.assert_allclose(so.numpy(), to, **out_tol)
    np.testing.assert_allclose(so.numpy(), jo, **out_tol)
    _check_lse(sl.numpy(), tl)
    _check_lse(sl.numpy(), jl)
    assert np.all(so.numpy()[1] == 0.0)  # the empty sequence


def test_paged_split_plan_is_the_launchers():
    """Host arithmetic shared by the launcher and the split route: one split
    where the grid fills the card (the 8B serve step, 128 blocks), more where
    it does not (Gemma3-4B's decode, 40 blocks), split ranges of whole tiles
    whose table entries cover the table, and num_splits=None taking that
    plan."""
    from mfa_tpu_torch.kernels import paged

    assert paged.split_plan(16, 8, 8, 64) == (1, 512)
    n, tps = paged.split_plan(10, 4, 40, 64)
    assert n == 3 and tps % 64 == 0 and (n - 1) * tps < 40 * 64 <= n * tps
    for page, pps in ((8, 51), (16, 25), (64, 40), (128, 20)):
        n, tps = paged.split_plan(2, 2, pps, page)
        spans = [paged.split_pages(s, tps, page, pps) for s in range(n)]
        assert spans[0][0] == 0 and spans[-1][1] == pps
        assert all(a[1] >= b[0] and a[0] <= b[0] for a, b in zip(spans, spans[1:]))
    q, kp, vp, table, lens, _, _ = _split_case(6)
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), None, None, t(lens), t(table), 0.125, -1, 0.0, 1)
    auto = paged._paged_split_plain(*args)
    n, _ = paged.split_plan(3, 2, 16, 32)
    assert n > 1
    explicit = paged._paged_split_plain(*args, num_splits=n)
    assert all(torch.equal(a, b) for a, b in zip(auto, explicit))
