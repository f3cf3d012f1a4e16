"""The port's per-layer paged KV cache (mfa_tpu_torch/cache/paged_cache.py:
PagedKVCache, create_cache, write_prompt, append_token, map_page,
release_slot, cache_from_numpy) and llama.prefill_step against mfa_tpu's,
mirroring tests/test_cache.py on the same numpy inputs:

- the allocator: the same pages in the same order;
- a prompt, then decode tokens appended one by one, for fp32,
  int8, fp8 and int4 pages at head_dim 64 (pages of 16) and 80 (pages of
  8): the payload values (int4: mfa_tpu's token pairs unpacked beside the
  port's feature pairs; fp8 byte for byte) equal over the true features,
  the scales equal (see _assert_same_cache), the tables and
  lengths equal, and decode through both
  packages' paged_attention (mfa_tpu's Pallas kernel in interpret mode,
  the port's plain version) within atol = rtol = 1e-4 (fp32 q: the same
  function on the same values, as tests/test_torch_kv_formats.py holds
  it);
- cache_from_numpy of mfa_tpu's cache: pages, tables and lengths equal to
  the port's own writes bit for bit, scales to mfa_tpu's;
- release_slot, batched release_slots, map_page; int4 on odd pages refused;
- prefill_step's last logits against mfa_tpu's at atol = rtol = 1e-3
  (tests/test_torch_model.py's limits), and the stacked cache it wrote,
  carried over by cache_from_numpy, within 1e-4 of the port's.

shard_cache on a per-layer cache needs ranks: tests/test_torch_serve_sharded.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.cache import paged_cache as jc
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.quant import unpack_int4_pairs
from mfa_tpu.models import llama as jl
from mfa_tpu_torch.cache import paged_cache as tc
from mfa_tpu_torch.kernels.paged import paged_attention
from mfa_tpu_torch.kernels.quant import page_values
from mfa_tpu_torch.models import llama as tl
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
HKV, HEADS, PPS = 2, 4, 4


def _jax_values(pages, quant, d):
    """mfa_tpu's stored pages -> payload values [hkv, P, page, d] (int4
    token pairs unpacked, fp8 as its bytes)."""
    if quant == "int4":
        pages = unpack_int4_pairs(pages)
    a = np.asarray(pages)[..., :d]
    return a.view(np.uint8) if quant == "fp8" else a.astype(np.float32)


def _port_values(pages, quant, d):
    v = page_values(pages, quant)[..., :d]
    return v.view(torch.uint8).numpy() if quant == "fp8" else v.float().numpy()


def _bits(t):
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t


def _assert_same_cache(j, t, quant, d):
    np.testing.assert_array_equal(_port_values(t.k_pages, quant, d),
                                  _jax_values(j.k_pages, quant, d))
    np.testing.assert_array_equal(_port_values(t.v_pages, quant, d),
                                  _jax_values(j.v_pages, quant, d))
    if quant is None:
        assert t.k_scales is None and j.k_scales is None
    else:
        # each writer takes the scale rule of mfa_tpu's: jitted append_token
        # absmax * f32(1 / qmax), eager write_prompt absmax / qmax
        for a, b in ((t.k_scales, j.k_scales), (t.v_scales, j.v_scales)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t.block_tables.numpy(), np.asarray(j.block_tables))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))


def test_allocator_matches_jax():
    a, b = jc.PageAllocator(8), tc.PageAllocator(8)
    assert a.free_pages == b.free_pages == 7  # page 0 reserved
    p = a.alloc(3)
    assert b.alloc(3) == p and 0 not in p
    a.free(p[1:])
    b.free(p[1:])
    assert a.alloc(4) == b.alloc(4)
    with pytest.raises(MemoryError):
        b.alloc(100)


@pytest.mark.parametrize("d,page", [(64, 16), (80, 8)])
@pytest.mark.parametrize("quant", [None, "int8", "fp8", "int4"])
def test_prompt_then_decode_matches_jax(quant, d, page):
    rng = np.random.RandomState(d + page)
    kw = dict(num_pages=16, page_size=page, num_kv_heads=HKV, head_dim=d,
              max_seqs=2, pages_per_seq=PPS, quant_dtype=quant)
    jcache = jc.create_cache(dtype=jnp.float32, **kw)
    tcache = tc.create_cache(dtype=torch.float32, device="cpu", **kw)
    assert (tcache.num_kv_heads, tcache.num_pages, tcache.max_seqs,
            tcache.pages_per_seq, tcache.head_dim) == (HKV, 16, 2, PPS, d)
    L = 2 * page + 5
    k, v = (rng.standard_normal((L, HKV, d)).astype(np.float32) for _ in range(2))
    pages = [5, 2, 9, 11]
    jcache = jc.write_prompt(jcache, 1, pages, jnp.asarray(k), jnp.asarray(v))
    assert tc.write_prompt(tcache, 1, pages, torch.from_numpy(k),
                           torch.from_numpy(v)) is tcache
    for _ in range(3):  # the third append crosses into a new page's row 0
        nk, nv = (rng.standard_normal((1, HKV, d)).astype(np.float32)
                  for _ in range(2))
        jcache = jc.append_token(jcache, jnp.asarray([1], jnp.int32),
                                 jnp.asarray(nk), jnp.asarray(nv))
        tc.append_token(tcache, [1], torch.from_numpy(nk), torch.from_numpy(nv))
    assert int(tcache.lengths[1]) == L + 3
    _assert_same_cache(jcache, tcache, quant, d)
    carried = tc.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert isinstance(carried, tc.PagedKVCache) and carried.head_dim == d
    for f in ("k_pages", "v_pages", "block_tables", "lengths"):
        a, b = getattr(carried, f), getattr(tcache, f)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f
    for f in ("k_scales", "v_scales"):
        a, b = getattr(carried, f), getattr(jcache, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    q = rng.standard_normal((1, HEADS, d)).astype(np.float32)
    jo = jax_paged(jnp.asarray(q), jcache.k_pages, jcache.v_pages,
                   jcache.lengths[1:], jcache.block_tables[1:],
                   k_scales=jcache.k_scales, v_scales=jcache.v_scales,
                   quant_dtype=quant)
    to = paged_attention(torch.from_numpy(q), tcache.k_pages, tcache.v_pages,
                         tcache.lengths[1:], tcache.block_tables[1:],
                         k_scales=tcache.k_scales, v_scales=tcache.v_scales,
                         quant_dtype=quant)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo, np.float32), **TOL)


def test_release_slot_and_map_page_match_jax():
    kw = dict(num_pages=8, page_size=16, num_kv_heads=1, head_dim=64,
              max_seqs=2, pages_per_seq=2)
    ones = np.ones((20, 1, 64), np.float32)
    j = jc.write_prompt(jc.create_cache(dtype=jnp.float32, **kw), 1, [3, 4],
                        jnp.asarray(ones), jnp.asarray(ones))
    t = tc.write_prompt(tc.create_cache(dtype=torch.float32, device="cpu", **kw),
                        1, [3, 4], torch.from_numpy(ones), torch.from_numpy(ones))
    assert int(t.lengths[1]) == 20
    j = jc.map_page(j, 0, 1, 6)
    assert tc.map_page(t, 0, 1, 6) is t
    _assert_same_cache(j, t, None, 64)
    j = jc.release_slot(j, 1)
    assert tc.release_slot(t, 1) is t
    assert int(t.lengths[1]) == 0 and not t.block_tables[1].any()
    _assert_same_cache(j, t, None, 64)


def test_release_slots_batched_is_release_slot_repeated():
    kw = dict(num_pages=8, page_size=4, num_kv_heads=4, head_dim=16,
              max_seqs=4, pages_per_seq=4, device="cpu")

    def filled():
        c = tc.create_cache(**kw)
        c.block_tables.copy_(torch.arange(16, dtype=torch.int32).reshape(4, 4) % 7)
        c.lengths.copy_(torch.tensor([5, 9, 3, 7], dtype=torch.int32))
        return c

    a = tc.release_slots(filled(), [1, 3])
    b = tc.release_slot(tc.release_slot(filled(), 1), 3)
    assert torch.equal(a.block_tables, b.block_tables)
    assert torch.equal(a.lengths, b.lengths)
    assert a.lengths.tolist() == [5, 0, 3, 0]


def test_int4_odd_pages_refused_like_jax():
    kw = dict(num_pages=4, page_size=7, num_kv_heads=1, head_dim=64,
              max_seqs=1, pages_per_seq=2, quant_dtype="int4")
    with pytest.raises(ValueError, match="even page_size"):
        jc.create_cache(**kw)
    with pytest.raises(ValueError, match="even page_size"):
        tc.create_cache(device="cpu", **kw)
    with pytest.raises(ValueError, match="needs 3 pages"):
        tc.write_prompt(tc.create_cache(**dict(kw, page_size=8, pages_per_seq=4),
                                        device="cpu"), 0, [1, 2],
                        torch.zeros(17, 1, 64), torch.zeros(17, 1, 64))


JCFG = jl.LlamaConfig.tiny(vocab=64, dim=256, layers=2, heads=4, kv_heads=2,
                           ffn=256, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=256, layers=2, heads=4, kv_heads=2,
                           ffn=256, dtype=torch.float32)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_prefill_step_matches_jax(quant):
    jp = jl.init_params(jax.random.key(0), JCFG)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    toks = np.random.RandomState(3).randint(0, 64, 13)
    jcache = jl.build_kv_caches(JCFG, 16, 8, 2, 8, quant)
    tcache = tl.build_kv_caches(TCFG, 16, 8, 2, 8, quant, device="cpu")
    jcache, jlog = jl.prefill_step(jp, JCFG, jcache, 1, [4, 7],
                                   jnp.asarray(toks, jnp.int32))
    tcache, tlog = tl.prefill_step(tp, TCFG, tcache, 1, [4, 7], toks)
    assert tlog.shape == (64,)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-3, rtol=1e-3)
    carried = tc.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert isinstance(carried, tc.StackedKVCache) and carried.layers == 2
    assert carried.head_dim == TCFG.head_dim
    for f in ("n_layers", "num_kv_heads", "num_pages", "max_seqs", "pages_per_seq",
              "head_dim"):
        assert getattr(tcache, f) == getattr(jcache, f), f
    assert tcache.page_width == (TCFG.head_dim // 2 if quant else TCFG.head_dim)
    assert torch.equal(carried.block_tables, tcache.block_tables)
    assert torch.equal(carried.lengths, tcache.lengths)
    d = TCFG.head_dim
    for f in ("k_pages", "v_pages"):
        a = page_values(getattr(carried, f), quant)[..., :d].float()
        b = page_values(getattr(tcache, f), quant)[..., :d].float()
        if quant is None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        else:  # a K/V value near a rounding boundary may take the next step
            assert float((a - b).abs().max()) <= 1.0
            assert float((a != b).float().mean()) < 0.01
