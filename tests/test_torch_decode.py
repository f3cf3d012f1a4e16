"""The port's split-KV decode (plain path on CPU: per-split partials plus
the combine, as the kernel's two launches) against mfa_tpu's decode kernel
in Pallas interpret mode. Inputs from numpy with a seed. Tolerance: fp32,
atol = rtol = 1e-4 (same softmax, other split boundaries and summation
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu_torch
from mfa_tpu.kernels.decode import combine_splits as jax_combine
from mfa_tpu.kernels.decode import decode_attention as jax_decode
from mfa_tpu_torch.dispatch.config import num_splits_heuristic
from mfa_tpu_torch.kernels.decode import (combine_splits, decode_attention,
                                          split_layout)

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _both(q, k, v, lens, **kw):
    jo, jl = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens), return_lse=True, **kw)
    to, tl = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens),
                              return_lse=True, **kw)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


@pytest.mark.parametrize("num_splits", [1, 2, 3, 0])
def test_decode_splits_sweep_matches_jax(num_splits):
    q, k, v = _inputs(0, 2, 8, 2, 640, 64)
    lens = np.array([640, 130], np.int32)
    (jo, jl), (to, tl) = _both(q, k, v, lens, num_splits=num_splits)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_decode_boundary_256_257():
    q, k, v = _inputs(1, 2, 4, 4, 512, 64)
    lens = np.array([256, 257], np.int32)
    (jo, _), (to, _) = _both(q, k, v, lens, num_splits=2)
    np.testing.assert_allclose(to, jo, **TOL)


def test_decode_window_and_softcap_match_jax():
    q, k, v = _inputs(2, 2, 4, 2, 300, 64)
    lens = np.array([300, 77], np.int32)
    (jo, jl), (to, tl) = _both(q, k, v, lens, window_left=40,
                               logit_softcap=20.0, num_splits=2)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_zero_length_rows_give_zeros_and_neg_inf_lse():
    q, k, v = _inputs(3, 3, 4, 2, 200, 32)
    lens = np.array([0, 5, 0], np.int32)
    to, tl = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens),
                              num_splits=3, return_lse=True)
    assert np.all(to.numpy()[[0, 2]] == 0.0)
    assert np.all(np.isneginf(tl.numpy()[[0, 2]]))
    assert np.all(np.isfinite(tl.numpy()[1]))
    (jo, _), _ = _both(q, k, v, lens, num_splits=3)
    np.testing.assert_allclose(to.numpy()[1], jo[1], **TOL)


def test_combine_matches_jax_with_empty_splits():
    rng = np.random.RandomState(4)
    parts = rng.standard_normal((2, 2, 4, 3, 16)).astype(np.float32)
    lse = rng.standard_normal((2, 2, 4, 3)).astype(np.float32)
    lse[0, 1, 2] = -np.inf      # one empty split
    lse[1, 0, :, 1] = -np.inf   # a row with every split empty
    jo, jl = jax_combine(jnp.asarray(parts), jnp.asarray(lse), axis=2,
                         return_lse=True)
    to, tl = combine_splits(torch.from_numpy(parts), torch.from_numpy(lse),
                            axis=2, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()),
                                  np.isneginf(np.asarray(jl)))
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin], **TOL)


def test_flash_attn_with_kvcache_contiguous_matches_jax():
    from mfa_tpu.interface import flash_attn_with_kvcache as jax_kvcache

    rng = np.random.RandomState(5)
    q = rng.standard_normal((2, 1, 8, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 200, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((2, 200, 2, 64)).astype(np.float32)
    lens = np.array([200, 51], np.int32)
    jo = jax_kvcache(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                     cache_seqlens=jnp.asarray(lens), num_splits=2)
    to = mfa_tpu_torch.flash_attn_with_kvcache(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        cache_seqlens=torch.from_numpy(lens), num_splits=2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    with pytest.raises(ValueError):
        mfa_tpu_torch.flash_attn_with_kvcache(
            torch.zeros(2, 2, 8, 64), torch.from_numpy(kc),
            torch.from_numpy(vc), cache_seqlens=10)


def test_split_heuristic_follows_waves():
    # a grid that already fills 80% of two blocks per SM needs no split
    assert num_splits_heuristic(32, 8, 8192, 64) == 1
    # a small grid splits until the wave efficiency passes 0.9
    assert num_splits_heuristic(16, 8, 8192, 64) == 2
    assert num_splits_heuristic(1, 1, 8192, 64) > 1
    # never more splits than KV blocks
    assert num_splits_heuristic(1, 1, 100, 64) <= 2
    # split ranges are whole tiles and every split has work
    for s, ns in ((640, 3), (65, 8), (8192, 2)):
        n, tps = split_layout(s, ns)
        assert tps % 64 == 0 and (n - 1) * tps < s <= n * tps
