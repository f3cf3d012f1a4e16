"""ALiBi in the port (the mirror of tests/test_alibi.py): the per-head bias
-slope * |i - j| through flash_attn_func, the varlen entry point (packed
and paged routes), the kvcache entry point (contiguous and paged), the
paged kernel's speculative spans and chunked prefill, and the gradient
entry points. Each on the same numpy inputs as mfa_tpu's functions in
interpret mode, fp32, atol = rtol = 1e-4 (gradients 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu
import mfa_tpu_torch
from mfa_tpu.kernels import autodiff as jad
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill
from mfa_tpu_torch.kernels import autodiff as tad
from mfa_tpu_torch.kernels.paged import paged_attention
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
SLOPES4 = np.array([0.25, 0.0625, 0.5, 0.125], np.float32)


def _rn(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _both(fn_t, fn_j, *arrays, **kw):
    """-> (port, mfa_tpu) outputs of one call on the same numpy arrays;
    alibi_slopes passes as each package's tensor."""
    tk = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    jk = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **tk)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **jk)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_func_alibi(causal):
    q, k, v = _rn(0, 2, 200, 4, 64), _rn(1, 2, 200, 2, 64), _rn(2, 2, 200, 2, 64)
    got, want = _both(mfa_tpu_torch.flash_attn_func, mfa_tpu.flash_attn_func,
                      q, k, v, causal=causal, alibi_slopes=SLOPES4)
    np.testing.assert_allclose(got, want, **TOL)
    plain = mfa_tpu_torch.flash_attn_func(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    assert np.abs(plain - want).max() > 1e-4  # the bias matters


def test_varlen_alibi():
    lens = [50, 110, 9]
    cu = np.cumsum([0] + lens).astype(np.int32)
    total = sum(lens)
    q, k, v = _rn(0, total, 4, 64), _rn(1, total, 2, 64), _rn(2, total, 2, 64)
    got, want = _both(
        lambda *a, **kw: mfa_tpu_torch.flash_attn_varlen_func(
            *a, max(lens), max(lens), causal=True, **kw),
        lambda *a, **kw: mfa_tpu.flash_attn_varlen_func(
            *a, max(lens), max(lens), causal=True, **kw),
        q, k, v, cu, cu, alibi_slopes=SLOPES4)
    np.testing.assert_allclose(got, want, **TOL)
    # the paged route of the same call: the rows in pages of 16, and sinks
    pool_k = np.zeros((16, 16, 2, 64), np.float32)
    pool_v = np.zeros_like(pool_k)
    table = np.zeros((3, 7), np.int32)
    nxt = 1
    for i, (a, n) in enumerate(zip(cu[:-1], lens)):
        for p in range(-(-n // 16)):
            m = min(16, n - 16 * p)
            pool_k[nxt, :m] = k[a + 16 * p:a + 16 * p + m]
            pool_v[nxt, :m] = v[a + 16 * p:a + 16 * p + m]
            table[i, p] = nxt
            nxt += 1
    kw = dict(causal=True, alibi_slopes=SLOPES4, window_size=(20, -1),
              sink_tokens=3)
    got, want = _both(
        lambda *a, **kw: mfa_tpu_torch.flash_attn_varlen_func(
            *a[:5], max(lens), max(lens), block_table=a[5], **kw),
        lambda *a, **kw: mfa_tpu.flash_attn_varlen_func(
            *a[:5], max(lens), max(lens), block_table=a[5], **kw),
        q, pool_k, pool_v, cu, cu, table, **kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_kvcache_alibi_contiguous_and_paged():
    b, page, pps = 2, 16, 10
    lens = np.array([150, 64], np.int32)
    q, kc, vc = _rn(0, b, 1, 4, 64), _rn(1, b, 160, 2, 64), _rn(2, b, 160, 2, 64)
    got, want = _both(
        lambda q, k, v, L, **kw: mfa_tpu_torch.flash_attn_with_kvcache(
            q, k, v, cache_seqlens=L, **kw),
        lambda q, k, v, L, **kw: mfa_tpu.flash_attn_with_kvcache(
            q, k, v, cache_seqlens=L, **kw),
        q, kc, vc, lens, alibi_slopes=SLOPES4)
    np.testing.assert_allclose(got, want, **TOL)
    kp = np.zeros((b * pps + 1, page, 2, 64), np.float32)
    vp = np.zeros_like(kp)
    kp[1:], vp[1:] = kc.reshape(b * pps, page, 2, 64), vc.reshape(b * pps, page, 2, 64)
    table = np.arange(1, b * pps + 1, dtype=np.int32).reshape(b, pps)
    got_p = mfa_tpu_torch.flash_attn_with_kvcache(
        *(torch.from_numpy(a) for a in (q, kp, vp)),
        cache_seqlens=torch.from_numpy(lens), block_table=torch.from_numpy(table),
        alibi_slopes=torch.from_numpy(SLOPES4))
    np.testing.assert_allclose(got_p.numpy(), want, **TOL)


def test_paged_alibi_speculative_span():
    """A multi-query span (row si at lens - span + si), each GQA row with
    its own slope, on the whole and the split route."""
    b, kvh, d, page, pps, span = 2, 2, 64, 16, 8, 3
    n = b * pps + 1
    kp, vp = _rn(1, kvh, n, page, d), _rn(2, kvh, n, page, d)
    table = np.arange(1, b * pps + 1, dtype=np.int32).reshape(b, pps)
    lens = np.array([100, 40], np.int32)
    q = _rn(5, b, span, 4, d)
    got, want = _both(paged_attention, jax_paged, q, kp, vp, lens, table,
                      alibi_slopes=SLOPES4)
    np.testing.assert_allclose(got, want, **TOL)
    from mfa_tpu_torch.kernels import paged
    t = [torch.from_numpy(a) for a in (q, kp, vp, lens, table)]
    split, _ = paged._paged_split_plain(t[0], t[1], t[2], None, None, t[3], t[4],
                                        d ** -0.5, -1, 0.0, 0, num_splits=2,
                                        alibi=torch.from_numpy(SLOPES4))
    np.testing.assert_allclose(split.numpy(), want, **TOL)


def test_paged_prefill_alibi_chunk():
    """A chunk past position 0 (absolute positions) with ALiBi and sinks."""
    b, sq, kvh, d, page, pps = 2, 24, 2, 64, 16, 6
    n = b * pps + 1
    kp, vp = _rn(1, kvh, n, page, d), _rn(2, kvh, n, page, d)
    table = np.arange(1, b * pps + 1, dtype=np.int32).reshape(b, pps)
    q = _rn(3, b, sq, 4, d)
    lens, q_start = np.array([80, 40], np.int32), np.array([56, 16], np.int32)
    got, want = _both(paged_prefill_attention, jax_paged_prefill, q, kp, vp,
                      lens, q_start, table, causal=True, window_left=20,
                      sink_tokens=5, alibi_slopes=SLOPES4)
    for bb in range(b):  # rows past each chunk are unspecified in mfa_tpu
        r = lens[bb] - q_start[bb]
        np.testing.assert_allclose(got[bb, :r], want[bb, :r], **TOL)


def test_gradient_entry_points_alibi():
    """flash_attn_func_grad and flash_attn_varlen_func_grad with ALiBi:
    dq, dk, dv against mfa_tpu's, and a zero gradient for the slopes."""
    q, k, v, w = (_rn(i, 2, 96, 4, 64) for i in range(4))
    k, v = k[:, :, :2], v[:, :, :2]

    def jloss(q, k, v):
        o = jad.flash_attn_func_grad(q, k, v, causal=True,
                                     alibi_slopes=jnp.asarray(SLOPES4))
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    slopes = torch.from_numpy(SLOPES4).requires_grad_()
    out = tad.flash_attn_func_grad(qt, kt, vt, causal=True, alibi_slopes=slopes)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (qt, kt, vt, slopes))
    for name, g, x in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=2e-4,
                                   rtol=1e-4, err_msg=f"d{name}")
    assert not got[3].any()

    lens = [40, 70, 9]
    cu = np.cumsum([0] + lens).astype(np.int32)
    q, k, v, w = _rn(5, 119, 4, 64), _rn(6, 119, 2, 64), _rn(7, 119, 2, 64), \
        _rn(8, 119, 4, 64)

    def jvl(q, k, v):
        o = jad.flash_attn_varlen_func_grad(
            q, k, v, jnp.asarray(cu), jnp.asarray(cu), 70, 70, causal=True,
            alibi_slopes=jnp.asarray(SLOPES4))
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jvl, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tad.flash_attn_varlen_func_grad(qt, kt, vt, cu, cu, 70, 70,
                                          causal=True, alibi_slopes=slopes)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (qt, kt, vt, slopes))
    for name, g, x in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=2e-4,
                                   rtol=1e-4, err_msg=f"varlen d{name}")
    assert not got[3].any()
