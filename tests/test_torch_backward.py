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
from tests.jax_maps import release_jax_code  # noqa: F401

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
@pytest.mark.parametrize("offset,window", [(64, (-1, 0)), (40, (48, 0))])
def test_backward_kv_position_offset_matches_jax(fused, offset, window):
    """kv_position_offset (the ring's pairs) in the fused kernel and the
    split, against mfa_tpu's backward with the same offset."""
    rng = np.random.RandomState(7)
    q, do = (rng.standard_normal((1, 4, 96, 64)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 160, 64)).astype(np.float32)
            for _ in range(2))
    kw = dict(window_size=window, kv_position_offset=offset)
    out, lse = jprefill(*(jnp.asarray(a) for a in (q, k, v)), return_lse=True,
                        **kw)
    out, lse = np.array(out), np.array(lse)
    want = jbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)),
                fused=fused, **kw)
    got = tbwd(*(torch.from_numpy(a) for a in (q, k, v, out, lse, do)),
               fused=fused, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_alibi_matches_jax(fused):
    """ALiBi recomputed in P, in the fused kernel and the split."""
    rng = np.random.RandomState(8)
    q, k, v, do = (rng.standard_normal((1, 4, 100, 64)).astype(np.float32)
                   for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    slopes = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)
    out, lse = jprefill(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                        alibi_slopes=jnp.asarray(slopes), return_lse=True)
    out, lse = np.array(out), np.array(lse)
    want = jbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)), causal=True,
                alibi_slopes=jnp.asarray(slopes), fused=fused)
    got = tbwd(*(torch.from_numpy(a) for a in (q, k, v, out, lse, do)),
               causal=True, alibi_slopes=torch.from_numpy(slopes), fused=fused)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_alibi_with_offset_is_the_forward_gradient(fused):
    """ALiBi with kv_position_offset: the kernels' gradients against
    autograd of the plain forward (the same bias at row + offset);
    mfa_tpu's backward drops the offset from the bias (ROADMAP Queue 3),
    so it is not the reference here."""
    from mfa_tpu_torch.kernels.prefill import _prefill_plain

    rng = np.random.RandomState(9)
    q, do = (rng.standard_normal((1, 2, 64, 64)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
            for _ in range(2))
    slopes = torch.tensor([0.5, 0.25])
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = _prefill_plain(qt, kt, vt, 64 ** -0.5, -1, 0, 0.0, True, 0, 64,
                              slopes)
    want = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (qt, kt, vt))
    got = tbwd(qt.detach(), kt.detach(), vt.detach(), out.detach(),
               lse.detach(), torch.from_numpy(do), causal=True,
               kv_position_offset=64, alibi_slopes=slopes, fused=fused)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


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


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("causal,window", [(True, (-1, -1)), (True, (40, -1)),
                                           (False, (32, 16))])
def test_backward_head_dim_256(fused, causal, window):
    """Gemma3's head_dim: the kernels' d 256 block shape has its own tuple
    (backward.KERNEL_HEAD_DIMS); the function is the same, GQA 4:2."""
    _case(8, 1, 128, 128, 4, 2, 256, causal, window=window, fused=fused)


def test_kernel_head_dims_checked_without_running():
    """The CUDA route checks its inputs before it looks at a device or a
    kernel (meta tensors typed like a card's): head_dim 96 now passes (the
    kernels run it at D 128 on rows of 96), 256 passes, 257 raises
    ValueError as mfa_tpu does; fp32 passes (the fp32 tile), fp64 is
    refused."""
    from mfa_tpu_torch.kernels import backward

    for d, kernel_dim, dt in ((96, 128, torch.bfloat16), (256, 256, torch.bfloat16),
                              (96, 128, torch.float32)):
        t = torch.empty(1, 2, 8, d, dtype=dt, device="meta")
        plan = backward._check_kernel_inputs("flash_attention_bwd", t, t, t, t, t)
        assert (plan.kernel_dim, plan.stored) == (kernel_dim, d)
    t = torch.empty(1, 2, 8, 257, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        backward._check_kernel_inputs("flash_attention_bwd", t, t, t, t, t)
    t = torch.empty(1, 2, 8, 96, dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="bf16/fp16/fp32"):
        backward._check_kernel_inputs("flash_attention_bwd", t, t, t, t, t)


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
    # sinks, ALiBi and kv_position_offset are ported; what still raises,
    # in both packages: sinks with fused=False or with the offset, ALiBi
    # with a softcap
    qn, lsen = np.zeros((1, 2, 8, 64), np.float32), np.zeros((1, 2, 8), np.float32)
    for fn, t in ((tbwd, torch.from_numpy), (jbwd, jnp.asarray)):
        q, lse, slopes = t(qn), t(lsen), t(np.ones(2, np.float32))
        for kw, err in ((dict(sink_tokens=4, fused=False), NotImplementedError),
                        (dict(sink_tokens=4, kv_position_offset=3),
                         NotImplementedError),
                        (dict(alibi_slopes=slopes, logit_softcap=5.0),
                         ValueError)):
            with pytest.raises(err):
                fn(q, q, q, q, lse, q, window_size=(2, 0), **kw)
    q, slopes = torch.zeros(1, 2, 8, 64), torch.ones(2)
    with pytest.raises(ValueError):
        tad.flash_attention_grad(q, q, q, True, logit_softcap=5.0,
                                 alibi_slopes=slopes)
    with pytest.raises(ValueError):
        tad.flash_attn_varlen_func_grad(q[0, 0, :, None], q[0, 0, :, None],
                                        q[0, 0, :, None], [0, 8], [0, 8], 8,
                                        8, logit_softcap=5.0,
                                        alibi_slopes=slopes)
    qb = q.transpose(1, 2)  # [b, s, h, d]
    out = tad.flash_attn_func_grad(qb, qb, qb, alibi_slopes=slopes)
    assert out.shape == qb.shape


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
