"""The port's flash backward (kernels/backward.py, plain version on CPU)
against mfa_tpu's Pallas backward in interpret mode, mirroring
tests/test_backward.py: the same fp32 inputs (numpy, seeded) and the same
forward O and LSE go to both, with fused True and False on both sides;
dq, dk, dv agree to atol = rtol = 1e-4. Also torch.autograd through
kernels/autodiff against jax.grad through mfa_tpu's custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels import autodiff as jad
from mfa_tpu.kernels.backward import flash_attention_bwd as jbwd
from mfa_tpu.kernels.prefill import prefill_attention as jprefill
from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.kernels import autodiff as tad
from mfa_tpu_torch.kernels.backward import flash_attention_bwd as tbwd

TOL = dict(atol=1e-4, rtol=1e-4)


def _case(seed, b, sq, sk, hq, hkv, d, causal, window=(-1, -1), softcap=0.0,
          fused=True):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    out, lse = jprefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window_size=window,
                        logit_softcap=softcap, return_lse=True)
    out, lse = np.array(out), np.array(lse)
    kw = dict(causal=causal, window_size=window, logit_softcap=softcap,
              fused=fused)
    want = jbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)), **kw)
    got = tbwd(*(torch.from_numpy(a) for a in (q, k, v, out, lse, do)), **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1), (4, 2)])
def test_backward_matches_jax(fused, causal, hq, hkv):
    _case(0, 1, 128, 128, hq, hkv, 64, causal, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_arbitrary_lengths(fused):
    _case(1, 2, 100, 37, 2, 2, 64, True, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_causal_short_q_long_k(fused):
    """Key tiles past the last q row must come out as zeros."""
    _case(5, 1, 128, 512, 2, 2, 64, True, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_window_past_short_kv(fused):
    """Dead forward rows (LSE -inf) give finite, zero gradients."""
    _case(6, 1, 300, 8, 2, 2, 64, True, window=(4, -1), fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_window(fused):
    _case(2, 1, 256, 256, 2, 2, 64, False, window=(64, 0), fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_softcap(fused):
    _case(7, 1, 128, 128, 4, 2, 64, True, softcap=30.0, fused=fused)


def test_grad_through_autograd_function_multi_tile():
    """torch.autograd through flash_attention_grad == jax.grad through
    mfa_tpu's custom VJP, over more than one key tile."""
    rng = np.random.RandomState(3)
    q = rng.standard_normal((1, 2, 384, 64)).astype(np.float32)
    k = rng.standard_normal((1, 1, 384, 64)).astype(np.float32)
    v = rng.standard_normal((1, 1, 384, 64)).astype(np.float32)
    w = rng.standard_normal((1, 2, 384, 64)).astype(np.float32)
    want = jax.grad(lambda q, k, v: (jad.flash_attention_grad(q, k, v, True)
                                     * w).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tad.flash_attention_grad(qt, kt, vt, True)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    for g, x, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)


def test_flash_attn_func_grad_matches_jax():
    """The public [b, s, h, d] layout, GQA, causal and a window."""
    rng = np.random.RandomState(4)
    q = rng.standard_normal((2, 96, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)
    w = rng.standard_normal((2, 96, 4, 64)).astype(np.float32)
    kw = dict(causal=True, window_size=(40, -1))
    want = jax.grad(lambda q, k, v: (jad.flash_attn_func_grad(q, k, v, **kw)
                                     * w).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tad.flash_attn_func_grad(qt, kt, vt, **kw)
    assert out.shape == (2, 96, 4, 64)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    for g, x, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)


def test_unported_options_raise():
    q = torch.zeros(1, 2, 8, 64)
    slopes = torch.ones(2)
    with pytest.raises(NotImplementedError):
        tad.flash_attention_grad(q, q, q, True, alibi_slopes=slopes)
    with pytest.raises(NotImplementedError):
        tad.flash_attn_func_grad(q, q, q, alibi_slopes=slopes)
    with pytest.raises(NotImplementedError):
        tad.flash_attn_varlen_func_grad(q[0, 0, :, None], q[0, 0, :, None],
                                        q[0, 0, :, None], [0, 8], [0, 8], 8,
                                        8, alibi_slopes=slopes)
    lse = torch.zeros(1, 2, 8)
    for kw in (dict(alibi_slopes=slopes), dict(sink_tokens=4),
               dict(kv_position_offset=3)):
        with pytest.raises(NotImplementedError):
            tbwd(q, q, q, q, lse, q, **kw)


def test_grad_guard_fires_only_when_a_graph_would_be_recorded():
    """The kernels' CUDA routes refuse inputs that require grad under grad
    mode (a launch builds no graph); this is the predicate they use."""
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    assert _build.needs_grad(y, x)
    assert not _build.needs_grad(y, None)
    with torch.no_grad():
        assert not _build.needs_grad(x)
        _build.refuse_grad("prefill_attention", x)
    with pytest.raises(RuntimeError, match="kernels.autodiff"):
        _build.refuse_grad("prefill_attention", y, x)
