"""The port's prefill attention (mfa_tpu_torch, plain path on CPU) against
mfa_tpu's prefill kernel in Pallas interpret mode, and the port's fp32
oracles against the jnp oracles. Inputs come from numpy with a seed.
Tolerance: fp32, atol = rtol = 1e-4 (two fp32 implementations of the same
softmax; only summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu.interface import flash_attn_func as jax_flash_attn_func
from mfa_tpu.kernels.prefill import prefill_attention as jax_prefill
from mfa_tpu.ref import oracle as jax_oracle
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.ref import oracle

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, hq, hkv, sq, sk, d, layout="bhsd"):
    rng = np.random.RandomState(seed)
    if layout == "bhsd":
        shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    else:
        shapes = ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,window,softcap",
    [
        (2, 4, 4, 64, 64, 64, False, (-1, -1), 0.0),   # MHA, non-causal
        (1, 8, 2, 100, 100, 64, True, (-1, -1), 0.0),   # GQA 4:1, causal, ragged
        (1, 4, 1, 37, 93, 32, False, (-1, -1), 0.0),    # MQA, sq != sk, ragged
        (1, 4, 2, 80, 80, 64, True, (16, -1), 0.0),     # sliding window
        (1, 4, 2, 48, 48, 64, False, (5, 9), 0.0),      # two-sided band
        (1, 4, 2, 64, 64, 64, True, (-1, -1), 30.0),    # logit softcap
        (1, 2, 2, 20, 10, 64, False, (-1, 0), 0.0),     # rows past the band
    ],
)
def test_prefill_matches_jax(b, hq, hkv, sq, sk, d, causal, window, softcap):
    q, k, v = _inputs(0, b, hq, hkv, sq, sk, d)
    kw = dict(causal=causal, window_size=window, logit_softcap=softcap,
              return_lse=True)
    jo, jl = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    to, tl = prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[fin], jl[fin], **TOL)


def test_dead_rows_store_zero_and_neg_inf_lse():
    # left window entirely past a shorter kv sequence: rows 40.. see nothing
    q, k, v = _inputs(1, 1, 2, 2, 64, 20, 32)
    o, lse = prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window_size=(8, -1),
                               return_lse=True)
    dead = np.arange(64) > 19 + 8
    assert np.all(o.numpy()[:, :, dead] == 0.0)
    assert np.all(np.isneginf(lse.numpy()[:, :, dead]))
    assert np.all(np.isfinite(lse.numpy()[:, :, ~dead]))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_func_matches_jax(causal):
    q, k, v = _inputs(2, 2, 8, 2, 40, 40, 64, layout="bshd")
    jo = jax_flash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    to = mfa_tpu_torch.flash_attn_func(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_flash_attn_func_validates_inputs():
    q, k, v = (torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16),
               torch.zeros(1, 4, 2, 16))
    with pytest.raises(ValueError):
        mfa_tpu_torch.flash_attn_func(q, k, v)  # 3 q heads over 2 kv heads
    with pytest.raises(NotImplementedError):
        mfa_tpu_torch.flash_attn_func(k, k, v, alibi_slopes=torch.ones(2))


@pytest.mark.parametrize("causal,window", [(False, (-1, -1)), (True, (-1, -1)),
                                           (False, (6, 3))])
def test_attention_oracle_matches_jnp(causal, window):
    q, k, v = _inputs(3, 2, 4, 2, 24, 24, 16, layout="bshd")
    lens = np.array([24, 11], np.int32)
    j = jax_oracle.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, window_size=window,
                                 seqlen_k=jnp.asarray(lens))
    t = oracle.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window_size=window, seqlen_k=torch.from_numpy(lens))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_decode_oracles_match_jnp():
    rng = np.random.RandomState(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    lens = np.array([40, 9], np.int32)
    for wl in (-1, 5):
        j = jax_oracle.decode_ref(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lens),
                                  window_left=wl)
        t = oracle.decode_ref(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(lens),
                              window_left=wl)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    kp = rng.standard_normal((12, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((12, 8, 2, 16)).astype(np.float32)
    table = np.array([[3, 7, 1, 5], [11, 2, 9, 4]], np.int32)
    lens = np.array([30, 17], np.int32)
    j = jax_oracle.paged_decode_ref(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(lens),
                                    jnp.asarray(table))
    t = oracle.paged_decode_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp), torch.from_numpy(lens),
                                torch.from_numpy(table))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
