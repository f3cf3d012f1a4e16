"""The port's packed varlen attention (plain path on CPU) against mfa_tpu's
varlen kernel in Pallas interpret mode and against the torch oracle:
causal, non-causal, a (left, right) band, GQA 4:1, lens_k != lens_q, dead
rows, a zero-length sequence, softcap, the [num_heads, total_q] LSE layout
and the block_table route through the paged prefill kernel with a shuffled
table. Inputs from numpy with a seed; fp32, atol = rtol = 1e-4 (the same
function; only the summation order differs)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu import interface as jax_interface
from mfa_tpu.kernels.varlen import varlen_attention as jax_varlen
from mfa_tpu_torch.kernels.varlen import varlen_attention
from mfa_tpu_torch.ref.oracle import varlen_attention_ref

TOL = dict(atol=1e-4, rtol=1e-4)


def _pack(seed, lens_q, lens_k, hq, hkv, d=64):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((sum(lens_q), hq, d)).astype(np.float32)
    k = rng.standard_normal((sum(lens_k), hkv, d)).astype(np.float32)
    v = rng.standard_normal((sum(lens_k), hkv, d)).astype(np.float32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    return q, k, v, cu_q, cu_k


def _check_lse(tl, jl):
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], **TOL)


CASES = {
    # name: (lens_q, lens_k, hq, hkv, causal, window, softcap)
    "causal_gqa4": ([20, 37, 5], [20, 37, 5], 8, 2, True, (-1, -1), 0.0),
    "noncausal": ([20, 37, 5], [20, 37, 5], 4, 4, False, (-1, -1), 0.0),
    "band_8_4": ([20, 37, 5], [20, 37, 5], 8, 2, False, (8, 4), 0.0),
    "cross_lens_causal": ([7, 30, 12], [20, 16, 12], 4, 2, True, (-1, -1), 0.0),
    "zero_length": ([10, 0, 6], [10, 4, 0], 4, 1, True, (-1, -1), 0.0),
    "softcap": ([17, 9], [17, 9], 4, 2, True, (-1, -1), 5.0),
    # head_dim 256 (Gemma3): the kernel takes it since it runs kernel 1's tile
    "head_dim_256": ([20, 37, 5], [20, 37, 5], 4, 2, True, (-1, -1), 0.0, 256),
}


@pytest.mark.parametrize("name", list(CASES))
def test_varlen_matches_jax(name):
    lens_q, lens_k, hq, hkv, causal, window, softcap, *d = CASES[name]
    q, k, v, cu_q, cu_k = _pack(len(name), lens_q, lens_k, hq, hkv, *d)
    jo, jl = jax_varlen(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(cu_q), jnp.asarray(cu_k), max(lens_q),
                        max(lens_k), causal=causal, window_size=window,
                        logit_softcap=softcap, return_lse=True)
    to, tl = varlen_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(cu_q),
                              torch.from_numpy(cu_k), max(lens_q), max(lens_k),
                              causal=causal, window_size=window,
                              logit_softcap=softcap, return_lse=True)
    assert to.shape == q.shape and tl.shape == (hq, q.shape[0])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _check_lse(tl.numpy(), np.asarray(jl))
    if softcap == 0.0:
        ref = varlen_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), cu_q, cu_k,
                                   causal=causal, window_size=window)
        np.testing.assert_allclose(to.numpy(), ref.numpy(), **TOL)


def test_varlen_dead_rows_under_a_window():
    # one sequence, 30 q rows against 10 keys, causal with left window 3:
    # row r sees columns [r - 3, r] of [0, 10), so rows 13..29 see nothing
    q, k, v, cu_q, cu_k = _pack(5, [30], [10], 4, 2)
    o, lse = varlen_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(cu_q),
                              torch.from_numpy(cu_k), 30, 10, causal=True,
                              window_size=(3, -1), return_lse=True)
    assert torch.isfinite(lse[:, :13]).all()
    assert torch.isneginf(lse[:, 13:]).all()
    assert torch.all(o[13:] == 0) and torch.all(o[:13].abs().sum(-1) > 0)
    ref = varlen_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), cu_q, cu_k, causal=True,
                               window_size=(3, -1))
    np.testing.assert_allclose(o.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("causal,window", [(True, (-1, -1)), (False, (6, 3))])
def test_varlen_block_table_route_matches_jax(causal, window):
    lens_q, lens_k, hq, hkv, d, page = [9, 20, 3], [30, 20, 11], 8, 2, 64, 8
    rng = np.random.RandomState(11)
    q = rng.standard_normal((sum(lens_q), hq, d)).astype(np.float32)
    num_pages, pps = 16, 4
    kp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[: 3 * pps] + 1).reshape(3, pps)
    table = table.astype(np.int32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    jo, jl = jax_varlen(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(cu_q), jnp.asarray(cu_k), max(lens_q),
                        max(lens_k), causal=causal,
                        block_table=jnp.asarray(table), window_size=window,
                        return_lse=True)
    t = torch.from_numpy
    to, tl = varlen_attention(t(q), t(kp), t(vp), t(cu_q), t(cu_k),
                              max(lens_q), max(lens_k), causal=causal,
                              block_table=t(table), window_size=window,
                              return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _check_lse(tl.numpy(), np.asarray(jl))
    public = mfa_tpu_torch.flash_attn_varlen_func(
        t(q), t(kp), t(vp), t(cu_q), t(cu_k), max(lens_q), max(lens_k),
        causal=causal, block_table=t(table), window_size=window)
    np.testing.assert_allclose(public.numpy(), np.asarray(jo), **TOL)


def test_flash_attn_varlen_func_matches_jax_and_oracle():
    lens = [12, 33, 4]
    q, k, v, cu_q, cu_k = _pack(7, lens, lens, 8, 2)
    jo = jax_interface.flash_attn_varlen_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cu_q, cu_k,
        max(lens), max(lens), causal=True)
    to = mfa_tpu_torch.flash_attn_varlen_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cu_q), torch.from_numpy(cu_k), max(lens), max(lens),
        causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    ref = varlen_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), cu_q, cu_k, causal=True)
    np.testing.assert_allclose(to.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("fn", ["flash_attn_func", "flash_attn_varlen_func",
                                "flash_attn_with_kvcache"])
def test_public_functions_take_the_jax_keywords(fn):
    assert fn in mfa_tpu_torch.__all__
    jax_params = list(inspect.signature(getattr(jax_interface, fn)).parameters)
    port_params = list(inspect.signature(getattr(mfa_tpu_torch, fn)).parameters)
    assert port_params == jax_params


def test_unported_options_raise():
    q, k, v, cu_q, cu_k = _pack(8, [4], [4], 2, 2)
    args = [torch.from_numpy(a) for a in (q, k, v, cu_q, cu_k)] + [4, 4]
    with pytest.raises(NotImplementedError):
        mfa_tpu_torch.flash_attn_varlen_func(*args, sink_tokens=2,
                                             window_size=(2, -1))
    with pytest.raises(NotImplementedError):
        mfa_tpu_torch.flash_attn_varlen_func(*args,
                                             alibi_slopes=torch.ones(2))
    qd = torch.zeros((1, 1, 2, 64))
    kc = torch.zeros((1, 8, 2, 64))
    with pytest.raises(NotImplementedError):
        mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, kc, sink_tokens=4)
    with pytest.raises(NotImplementedError):
        mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, kc,
                                              alibi_slopes=torch.ones(2))
