"""torch.autograd through the port's flash_attn_varlen_func_grad (plain
versions on CPU) against jax.grad through mfa_tpu's, mirroring
tests/test_backward.py's varlen cases: the same packed fp32 inputs
(numpy, seeded), loss = sum(out * w); dq, dk, dv agree to atol = rtol =
1e-4. Also varlen_attention_bwd called directly, and a sequence of zero
length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.autodiff import flash_attn_varlen_func_grad as jgrad
from mfa_tpu.kernels.backward import varlen_attention_bwd as jbwd
from mfa_tpu.kernels.varlen import varlen_attention as jvarlen
from mfa_tpu_torch.kernels.autodiff import flash_attn_varlen_func_grad as tgrad
from mfa_tpu_torch.kernels.backward import varlen_attention_bwd as tbwd

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, lens_q, lens_k, hq, hkv, d):
    rng = np.random.RandomState(seed)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    q = rng.standard_normal((sum(lens_q), hq, d)).astype(np.float32)
    k = rng.standard_normal((sum(lens_k), hkv, d)).astype(np.float32)
    v = rng.standard_normal((sum(lens_k), hkv, d)).astype(np.float32)
    w = rng.standard_normal((sum(lens_q), hq, d)).astype(np.float32)
    return cu_q, cu_k, q, k, v, w


def _vl_case(seed, lens_q, lens_k, hq, hkv, d, causal, window=(-1, -1),
             softcap=0.0):
    cu_q, cu_k, q, k, v, w = _inputs(seed, lens_q, lens_k, hq, hkv, d)
    kw = dict(causal=causal, window_size=window, logit_softcap=softcap)
    mq, mk = max(lens_q), max(lens_k)

    def loss(q, k, v):
        return (jgrad(q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k), mq, mk,
                      **kw) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tgrad(qt, kt, vt, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                mq, mk, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    for g, x, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_backward_gqa(causal):
    """Ragged batch over several key tiles, GQA 4:2, mid-tile seams."""
    _vl_case(10, [100, 120, 36], [100, 120, 36], 4, 2, 64, causal)


def test_varlen_backward_unequal_qk():
    """seqlen_q != seqlen_k per sequence (top-left causal)."""
    _vl_case(11, [40, 17], [64, 33], 2, 1, 64, True)


def test_varlen_backward_window():
    _vl_case(12, [200, 56], [200, 56], 2, 2, 64, True, window=(32, -1))


def test_varlen_backward_straddling_pack():
    """Sequences that straddle the kernels' 64-row boxes, one of length 0,
    GQA 8:1, causal with a window: the shapes the packed kernels must get
    right."""
    lens = [65, 1, 127, 0, 200]
    _vl_case(16, lens, lens, 8, 1, 64, True, window=(48, -1))


def test_varlen_backward_softcap():
    _vl_case(14, [128, 64], [128, 64], 2, 2, 64, True, softcap=30.0)


def test_varlen_bwd_direct_with_empty_sequence():
    """varlen_attention_bwd on the saved O and LSE of JAX's forward, with a
    zero-length sequence and a band (10, 6): both backward functions get
    the same inputs."""
    lens_q, lens_k = [30, 0, 45], [20, 0, 50]
    cu_q, cu_k, q, k, v, do = _inputs(15, lens_q, lens_k, 4, 2, 64)
    kw = dict(causal=False, window_size=(10, 6))
    out, lse = jvarlen(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(cu_q), jnp.asarray(cu_k), 45, 50,
                       return_lse=True, **kw)
    out, lse = np.array(out), np.array(lse)
    want = jbwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do, cu_q, cu_k)),
                **kw)
    got = tbwd(*(torch.from_numpy(a) for a in (q, k, v, out, lse, do, cu_q,
                                               cu_k)), **kw)
    for g, x, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)
