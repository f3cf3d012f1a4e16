"""The port's image-block prefill (kernel 9's plain version on CPU) against
mfa_tpu's Pallas kernel in interpret mode, on inputs made with numpy from a
seed: fp32 outputs within 1e-4 (both are exact softmax attention under the
same mask; only the summation order differs), run bounds equal, and the
model-level dense reference equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels import blockmask as jb
from mfa_tpu.models import llama as jl
from mfa_tpu_torch.kernels import blockmask as tb
from mfa_tpu_torch.models import llama as tl
from tests.jax_maps import release_jax_code  # noqa: F401


def _ids(b, s, runs):
    """[b, s] int32 ids: runs[i] lists row i's (start, end) runs, inclusive;
    every other token is text (-1)."""
    out = -np.ones((b, s), np.int32)
    for i, row in enumerate(runs):
        for gi, (a, z) in enumerate(row):
            out[i, a:z + 1] = gi
    return out


def test_image_run_bounds_match_jax():
    rng = np.random.RandomState(0)
    for s in (10, 64, 131):
        ids = _ids(3, s, [[(1, 4), (6, 7)], [(0, s - 1)],
                          [(s // 3, s // 3 + rng.randint(1, s // 3))]])
        want = jb.image_run_bounds(jnp.asarray(ids))
        got = tb.image_run_bounds(torch.from_numpy(ids))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("wl", [-1, 0, 16, 100])
def test_kv_tile_bounds_cover_every_visible_column(wl):
    """Each q tile's [kv_first, kv_last] holds every column its rows see,
    and its last tile is the one the furthest run end or diagonal needs."""
    s, tile = 300, tb.TILE
    ids = torch.from_numpy(_ids(2, s, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]]))
    first, last = tb.kv_tile_bounds(ids, wl)
    vis = tb.block_mask(ids, wl)
    for b in range(2):
        for i in range(first.shape[1]):
            rows = vis[b, i * tile:(i + 1) * tile]
            cols = torch.nonzero(rows.any(0)).flatten()
            assert int(first[b, i]) == int(cols.min()) // tile
            assert int(last[b, i]) == int(cols.max()) // tile


@pytest.mark.parametrize("kv_tile", [64, 128])
@pytest.mark.parametrize("wl", [-1, 0, 16, 100])
def test_kv_tile_bounds_at_the_kernels_kv_tile(kv_tile, wl):
    """The kernel's spans: q tiles of 64 rows (one consumer warpgroup), KV
    tiles of its BN keys (128 at head_dim <= 128, 64 at 256). Each holds
    exactly the KV tiles with a column its rows see, and equals the rule the
    kernel applies (csrc/flash_fwd_sm90.cuh, kind IMAGE): the tile's first
    row bounds every row's run start, its last row every run end."""
    s, tile = 300, tb.TILE
    ids = torch.from_numpy(_ids(2, s, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]]))
    first, last = tb.kv_tile_bounds(ids, wl, tile, kv_tile)
    assert first.shape == (2, -(-s // tile))
    vis = tb.block_mask(ids, wl)
    run_start, run_end = tb.image_run_bounds(ids)
    for b in range(2):
        for i in range(first.shape[1]):
            cols = torch.nonzero(vis[b, i * tile:(i + 1) * tile].any(0)).flatten()
            assert int(first[b, i]) == int(cols.min()) // kv_tile
            assert int(last[b, i]) == int(cols.max()) // kv_tile
            lo, hi = i * tile, min(i * tile + tile - 1, s - 1)
            col_lo = min(max(lo - wl, 0), int(run_start[b, lo])) if wl >= 0 else 0
            assert (col_lo // kv_tile, int(run_end[b, hi]) // kv_tile) == (
                int(first[b, i]), int(last[b, i]))


@pytest.mark.parametrize("b,hq,hkv,s,d,runs,wl", [
    (2, 4, 2, 100, 64, [[], []], -1),                               # no image
    (2, 4, 2, 150, 64, [[(20, 60)], [(5, 9)]], -1),                 # one run
    (1, 4, 2, 200, 64, [[(10, 40), (100, 170)]], -1),               # two runs
    (2, 4, 2, 300, 64, [[(60, 140)], [(120, 260)]], -1),            # tile edges
    (1, 4, 2, 129, 64, [[(30, 90)]], 16),                           # window cuts a run
    (1, 4, 2, 96, 256, [[(10, 50)]], 32),                           # head_dim 256
    (1, 2, 2, 77, 64, [[(0, 5), (70, 76)]], 8),                     # s % 8 != 0
])
def test_image_block_prefill_matches_jax(b, hq, hkv, s, d, runs, wl):
    rng = np.random.RandomState(s + d)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    ids = _ids(b, s, runs)
    want = jb.image_block_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(ids), window_left=wl,
                                  block_q=128, block_k=128)
    got = tb.image_block_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(ids),
                                 window_left=wl)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_attention_dense_masked_matches_jax():
    from mfa_tpu.models.vision import image_bidir_mask
    from mfa_tpu_torch.models.vision import image_bidir_mask as t_mask

    jcfg = jl.LlamaConfig.tiny(dim=64, heads=4, kv_heads=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dim=64, heads=4, kv_heads=2, dtype=torch.float32)
    b, s, d = 2, 40, 16
    toks = np.full((b, s), 3, np.int32)
    toks[0, 5:13] = 7
    toks[1, 20:28] = 7
    rng = np.random.RandomState(1)
    q = rng.standard_normal((b, s, 4, d)).astype(np.float32)
    k = rng.standard_normal((b, s, 2, d)).astype(np.float32)
    v = rng.standard_normal((b, s, 2, d)).astype(np.float32)
    for wl in (-1, 6):
        want = jl._attention_dense_masked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, wl,
            image_bidir_mask(jnp.asarray(toks), 7))
        t = [torch.from_numpy(x) for x in (q, k, v)]
        mask = t_mask(torch.from_numpy(toks), 7)
        got = tl._attention_dense_masked(*t, tcfg, wl, mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        ids = torch.from_numpy(np.asarray(toks == 7, np.int32) - 1)
        flash = tl._attention_blockmask(*t, tcfg, wl, ids)
        np.testing.assert_allclose(flash.numpy(), got.numpy(), atol=1e-5, rtol=1e-5)
