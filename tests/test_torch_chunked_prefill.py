"""Chunked prefill and the prefix cache of the port (plain kernels on CPU)
against mfa_tpu on the same tiny fp32 model (2 layers, head_dim 64, JAX
params carried over by params_from_numpy):

- prefill_chunk_batch: logits at atol = rtol = 1e-3 and the written K/V
  rows of every valid token (fp32 at 1e-4; int8 payloads equal, scales at
  1e-4), with and without int8 KV;
- PrefixCache: the unit behaviour of mfa_tpu's (hits, divergence,
  refcounts, idle LRU, eviction), and the engine evicting idle prefix
  pages under allocation pressure;
- the Engine with prefill_chunk=16 and prefix_cache=True (int8 KV), and
  with prefix_cache=True alone (suffix-only chunks): greedy tokens
  identical to mfa_tpu's Engine, logprobs at 1e-3, and every page back in
  the allocator or held by the prefix cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.cache.paged_cache import PageAllocator
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from mfa_tpu_torch.serve.scheduler import PrefixCache, Request
from tests.jax_maps import release_jax_code  # noqa: F401

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)
PAGE = 8


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(2), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_chunk_batch_matches_jax(params, quant):
    jp, tp = params
    d = TCFG.head_dim
    jc = jl.build_kv_caches(JCFG, 16, PAGE, 2, 4, quant)
    tc = tl.build_kv_caches(TCFG, 16, PAGE, 2, 4, quant, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, 64, 29)), list(rng.randint(0, 64, 21))]
    pages = [[3, 1, 7, 5], [2, 9, 4]]
    # two chunks of 16 for both rows: offsets 0, then 16 (both finish)
    for off in (0, 16):
        toks = [p[off:off + 16] for p in prompts]
        args = ([0, 1], pages, toks, [off, off], [29, 21], 16)
        jc, jlog = jl.prefill_chunk_batch(jp, JCFG, jc, *args)
        tc, tlog = tl.prefill_chunk_batch(tp, TCFG, tc, *args)
        assert tc.lengths.tolist() == ([0, 0] if off == 0 else [29, 21])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    P = tc.num_pages
    for layer in range(TCFG.n_layers):
        for i, prompt in enumerate(prompts):
            for tok in range(len(prompt)):
                phys = layer * P + pages[i][tok // PAGE]
                at = (slice(None), phys, tok % PAGE)
                for tpool, jpool in ((tc.k_pages, jc.k_pages),
                                     (tc.v_pages, jc.v_pages)):
                    t_row = tpool[at].numpy()
                    j_row = np.asarray(jpool[at])[..., :d]
                    if quant:
                        np.testing.assert_array_equal(t_row, j_row)
                    else:
                        np.testing.assert_allclose(t_row, j_row, atol=1e-4,
                                                   rtol=1e-4)
                if quant:
                    for tsc, jsc in ((tc.k_scales, jc.k_scales),
                                     (tc.v_scales, jc.v_scales)):
                        np.testing.assert_allclose(tsc[at].numpy(),
                                                   np.asarray(jsc[at]),
                                                   atol=1e-6, rtol=1e-4)


def test_prefill_chunk_equals_whole_prefill(params):
    # fp32 pages, no quantization: chunk by chunk == the whole prompt at
    # once (logits, lengths and every valid K row)
    _, tp = params
    prompt = [int(t) for t in np.random.RandomState(5).randint(0, 64, 29)]
    pages = [4, 2, 6, 1]
    whole = tl.build_kv_caches(TCFG, 16, PAGE, 2, 4, device="cpu")
    whole, ref = tl.prefill_batch(tp, TCFG, whole, [1], [pages], [prompt])
    cc = tl.build_kv_caches(TCFG, 16, PAGE, 2, 4, device="cpu")
    for pos in range(0, len(prompt), 16):
        cc, logits = tl.prefill_chunk(tp, TCFG, cc, 1, pages,
                                      prompt[pos:pos + 16], pos, len(prompt))
        assert (logits is None) == (pos + 16 < len(prompt))
    np.testing.assert_allclose(logits.numpy(), ref[0].numpy(), atol=2e-4,
                               rtol=1e-4)
    assert cc.lengths.tolist() == whole.lengths.tolist() == [0, 29]
    for tok in range(len(prompt)):
        for layer in range(TCFG.n_layers):
            at = (slice(None), layer * cc.num_pages + pages[tok // PAGE],
                  tok % PAGE)
            np.testing.assert_allclose(cc.k_pages[at].numpy(),
                                       whole.k_pages[at].numpy(), atol=2e-5)


def test_prefix_cache_unit():
    pc = PrefixCache(page_size=4)
    alloc = PageAllocator(16)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]  # 2 full pages (last token held out)
    keys, pages = pc.match(prompt)
    assert keys == [] and pages == []
    req = Request(0, prompt, 4)
    req.pages = alloc.alloc(3)
    pc.register(req)
    assert len(req.prefix_keys) == 2
    keys2, pages2 = pc.match(prompt)  # an identical prompt hits both pages
    assert pages2 == req.pages[:2]
    other = prompt[:4] + [9, 9, 9, 9, 9]  # divergent second page
    keys3, pages3 = pc.match(other)
    assert pages3 == req.pages[:1]
    pc.release(keys2)
    pc.release(keys3)
    assert not pc.idle  # req still holds both keys
    pc.release(req.prefix_keys)
    assert list(pc.idle) == list(reversed(req.prefix_keys))  # tail first
    assert pc.evict(10, alloc) == 2 and not pc.pages
    assert alloc.free_pages == 15 - 1  # one page of req never registered


def test_prefix_cache_evicts_idle_pages_under_pressure(params):
    _, tp = params
    eng = Engine(tp, TCFG, num_pages=10, page_size=PAGE, max_seqs=2,
                 pages_per_seq=8, prefix_cache=True, device="cpu")
    rng = np.random.RandomState(6)
    eng.submit([int(t) for t in rng.randint(0, 64, 17)], 2)
    eng.run()
    assert len(eng.sched.prefix.pages) == 2  # idle, retained
    assert eng.sched.allocator.free_pages == 7
    # 56 tokens need 7 pages + 1 for decode: one idle page is evicted
    r2 = eng.submit([int(t) for t in rng.randint(0, 64, 56)], 2)
    eng.run()
    assert len(r2.generated) == 2
    assert len(eng.sched.prefix.pages) == 1 + 6  # the survivor + r2's pages
    assert eng.sched.allocator.free_pages + len(eng.sched.prefix.pages) == 9


def _run_engine(eng, waves):
    """Submit each wave after the previous one has finished (a prefix
    registers only when its prefill completes)."""
    reqs = []
    for wave in waves:
        reqs += [eng.submit(p, n) for p, n in wave]
        eng.run()
    return reqs


# (prefill_chunk, quant, waves): each wave is submitted after the previous
# one finished. Chunk mode: both first-wave prompts exceed the chunk and
# the second wave's prefix hits take the chunked suffix path (one batch
# shape for both waves). Suffix-only mode: the first prompt prefills whole,
# the hits (3 pages and 1 page) share one suffix chunk.
ENGINE_CASES = {
    "chunk16_prefix_int8": (16, "int8", [[("long", 4), ("shared+5", 3)],
                                         [("shared+6", 4), ("shared+999", 3)]]),
    "prefix_suffix_only": (None, None, [[("shared+5", 3)],
                                        [("shared+6", 4), ("shared[:10]", 2)]]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_chunked_and_prefix_match_jax(params, case):
    jp, tp = params
    chunk, quant, named_waves = ENGINE_CASES[case]
    rng = np.random.RandomState(4)
    shared = [int(t) for t in rng.randint(0, 64, 24)]
    prompts = {"long": [int(t) for t in rng.randint(0, 64, 37)],
               "shared+5": shared + [5], "shared+6": shared + [6],
               "shared+999": shared + [9, 9, 9], "shared[:10]": shared[:10]}
    waves = [[(prompts[name], n) for name, n in wave] for wave in named_waves]
    kw = dict(num_pages=40, page_size=PAGE, max_seqs=4, pages_per_seq=6,
              quant_dtype=quant, prefill_chunk=chunk, prefix_cache=True)
    jreqs = _run_engine(JaxEngine(jp, JCFG, **kw), waves)
    eng = Engine(tp, TCFG, device="cpu", **kw)
    free0 = eng.sched.allocator.free_pages
    reqs = _run_engine(eng, waves)
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == jr.generated, (r.uid, r.generated, jr.generated)
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-3)
    # no page leaked: free + retained by the prefix cache == initial
    retained = len(eng.sched.prefix.pages)
    assert eng.sched.allocator.free_pages + retained == free0 == 39
    assert not eng.sched.active and not eng._prefilling
    # registered: (len - 1) // PAGE pages of each first-wave prompt (the
    # last prompt token is never cached); the second wave hits 3 and 3
    # (or 1) of them and prefills only the rest
    assert retained == sum((len(p) - 1) // PAGE for p, _ in waves[0])
    hits = sum(min(len(p) - 1, 24) // PAGE for p, _ in waves[1])
    prompt_tokens = sum(len(p) for wave in waves for p, _ in wave)
    assert eng.stats.prefill_tokens == prompt_tokens - hits * PAGE
    assert eng.stats.chunk_batches == (4 if chunk else 1)
