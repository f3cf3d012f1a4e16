"""fp8 (e4m3) and int4 KV caches of the port (plain kernels on CPU) against
mfa_tpu's, on the same payloads:

- quantize_rows: fp8 payloads byte-equal to JAX's (and torch's e4m3 cast
  equal to jnp's on 10,001 clipped values), int4 values equal (zero rows,
  round half to even), scales equal; pack_int4 / unpack_int4 exact;
- paged_attention and paged_prefill_attention on fp8 and int4 pages
  against mfa_tpu's kernels in Pallas interpret mode, the JAX pages built
  by JAX's own packer (token pairs, kernels/quant.py:pack_int4_pairs) from
  the same payload: fp32 q, atol = rtol = 1e-4 (the same function on the
  same values; paged prefill's output atol 5e-4, see PREFILL_TOL); the
  split route 4e-3 (p rounded to bf16 after each split's own max, as for
  int8);
- the Engine at the tiny config with quant_dtype "fp8" and "int4", plain,
  and int4 with chunked prefill + the prefix cache (fp8 shares its write
  and read code but for the kernel): greedy tokens identical to
  mfa_tpu's Engine, logprobs within 1e-3, and the page pools its writes
  left (prompt waves, chunks, deferred appends) dequantizing equal to
  JAX's (layer 0 to fp32 rounding; deeper layers within one quantization
  step, see _same_pools);
  "auto" resolving as JAX's Engine resolves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill
from mfa_tpu.kernels.quant import pack_int4_pairs, unpack_int4_pairs
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.dispatch.config import (INT4_KV_CROSSOVER_TOKENS,
                                           recommend_kv_quant)
from mfa_tpu_torch.kernels import paged
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.quant import (FP8, pack_int4, quantize_rows,
                                         unpack_int4)
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
# Paged prefill on quantized pages rounds p to bf16 before P.V: where the
# two frameworks' fp32 exp2 differ by an ulp, p can round one bf16 ulp
# (2^-8) apart, which moves an output by up to ~2e-4 (1.7e-4 measured for
# int8 pages on this file's prefill inputs). The LSE sums unrounded p.
PREFILL_TOL = dict(atol=5e-4, rtol=1e-4)
JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)


def _bytes(a):
    return np.asarray(a).view(np.uint8)


def test_fp8_cast_matches_jnp_byte_for_byte():
    x = np.linspace(-448.0, 448.0, 10001).astype(np.float32)
    x[::7] *= 2.0 ** -12  # subnormals and values that round to zero
    t = torch.from_numpy(x).to(FP8).view(torch.uint8).numpy()
    np.testing.assert_array_equal(t, _bytes(jnp.asarray(x).astype(jnp.float8_e4m3fn)))


@pytest.mark.parametrize("quant", ["fp8", "int4"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_payload_and_scales_match_jax(quant, dtype):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32) * 3.0
    x[0, 4] = 0.0  # an all-zero row keeps scale 1
    x[1, 2, :3] = [80.0, 0.5 * 80 / 7, -1.5 * 80 / 7]  # int4 half steps
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x)
    if dtype != np.float32:
        tx = tx.to(torch.bfloat16)
    jq, js = jax_quantize(jx, quant)
    tq, ts = quantize_rows(tx, quant)
    assert ts.dtype == torch.float32
    if quant == "fp8":
        assert tq.dtype == FP8
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), _bytes(jq))
    else:
        assert tq.dtype == torch.int8 and int(tq.abs().max()) <= 7
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 4].item() == 1.0 and not tq[0, 4].float().any()


def test_int4_rounds_half_to_even_and_packs_feature_pairs():
    q, s = quantize_rows(torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0]]), "int4")
    assert s.item() == 1.0 and q.tolist() == [[0, 2, 2, 0, -2, 7]]
    vals = torch.from_numpy(np.random.RandomState(1).randint(-8, 8, (5, 3, 64))
                            ).to(torch.int8)
    packed = pack_int4(vals)
    assert packed.shape == (5, 3, 32) and packed.dtype == torch.int8
    assert torch.equal(unpack_int4(packed), vals)
    b = packed.to(torch.int16) & 0xFF  # byte c: feature 2c low, 2c + 1 high
    assert torch.equal(((b & 0xF) ^ 8) - 8, vals[..., 0::2].to(torch.int16))
    assert torch.equal(((b >> 4) ^ 8) - 8, vals[..., 1::2].to(torch.int16))


def _payloads(kf, vf, quant):
    """-> JAX's pages and the port's from one quantization: (jax k, v),
    (torch k, v), scales (numpy). int4: JAX packs token pairs, the port
    feature pairs, from the same unpacked values."""
    (kq, ks), (vq, vs) = (jax_quantize(jnp.asarray(a), quant) for a in (kf, vf))
    ks, vs = np.asarray(ks), np.asarray(vs)
    if quant == "fp8":
        tk, tv = (torch.from_numpy(_bytes(a).copy()).view(FP8) for a in (kq, vq))
        return (kq, vq), (tk, tv), ks, vs
    hkv, P, page, d = kq.shape
    jk, jv = (pack_int4_pairs(a.reshape(hkv, P * page, d)).reshape(
        hkv, P, page // 2, d) for a in (kq, vq))
    tk, tv = (pack_int4(torch.from_numpy(np.asarray(a))) for a in (kq, vq))
    return (jk, jv), (tk, tv), ks, vs


def _decode_case(seed, quant, b=3, hq=4, hkv=2, pages=20, page=16, d=64, pps=5):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(pages - 1)[: b * pps] + 1).reshape(b, pps)
    lens = np.array([70, 0, 33][:b], np.int32)
    return (q, table.astype(np.int32), lens) + _payloads(kf, vf, quant)


@pytest.mark.parametrize("quant", ["fp8", "int4"])
def test_paged_decode_matches_jax(quant):
    """The deferred-append query (pos_offset=1) with a window and a softcap,
    one pass and the kernel's split route (3 splits)."""
    q, table, lens, (jk, jv), (tk, tv), ks, vs = _decode_case(3, quant)
    kw = dict(pos_offset=1, window_left=20, logit_softcap=15.0)
    jo, jl_ = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                        jnp.asarray(table), k_scales=jnp.asarray(ks),
                        v_scales=jnp.asarray(vs), quant_dtype=quant,
                        return_lse=True, **kw)
    t = torch.from_numpy
    to, tl_ = paged.paged_attention(t(q), tk, tv, t(lens), t(table),
                                    k_scales=t(ks), v_scales=t(vs),
                                    quant_dtype=quant, return_lse=True, **kw)
    jo, jl_ = np.asarray(jo, np.float32), np.asarray(jl_)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_array_equal(np.isneginf(tl_.numpy()), np.isneginf(jl_))
    fin = np.isfinite(jl_)
    np.testing.assert_allclose(tl_.numpy()[fin], jl_[fin], **TOL)
    assert np.all(to.numpy()[1] == 0.0)  # the empty sequence
    so, sl = paged._paged_split_plain(t(q), tk, tv, t(ks), t(vs), t(lens),
                                      t(table), 64 ** -0.5, 20, 15.0, 1,
                                      num_splits=3, quant_dtype=quant)
    np.testing.assert_allclose(so.numpy(), jo, atol=4e-3, rtol=0)
    np.testing.assert_allclose(sl.numpy()[fin], jl_[fin], **TOL)


@pytest.mark.parametrize("quant,window_left", [("fp8", -1), ("int4", 20)])
def test_paged_prefill_matches_jax(quant, window_left):
    rng = np.random.RandomState(5)
    b, sq, hq, hkv, d, page, pps = 2, 32, 8, 2, 128, 16, 6
    num_pages = b * pps + 3
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps)
    table = table.astype(np.int32)
    (jk, jv), (tk, tv), ks, vs = _payloads(kf, vf, quant)
    q_start, lens = np.array([32, 0], np.int32), np.array([64, 20], np.int32)
    jo, jl_ = jax_paged_prefill(
        jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.asarray(q_start),
        jnp.asarray(table), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        quant_dtype=quant, window_left=window_left, return_lse=True)
    t = torch.from_numpy
    to, tl_ = paged_prefill_attention(
        t(q), tk, tv, t(lens), t(q_start), t(table), k_scales=t(ks),
        v_scales=t(vs), quant_dtype=quant, window_left=window_left,
        return_lse=True)
    jo, jl_ = np.asarray(jo, np.float32), np.asarray(jl_)
    real = lens - q_start
    for i in range(b):
        r = int(real[i])
        np.testing.assert_allclose(to.numpy()[i, :r], jo[i, :r], **PREFILL_TOL)
        np.testing.assert_allclose(tl_.numpy()[i, :, :r], jl_[i, :, :r], **TOL)


def _dequant_jax(pages, scales, quant, d):
    if quant == "int4":
        hkv, P, rows, w = pages.shape
        pages = unpack_int4_pairs(pages.reshape(hkv, P * rows, w)).reshape(
            hkv, P, 2 * rows, w)
    return np.asarray(pages, np.float32)[..., :d] * np.asarray(scales)[..., None]


def _dequant_torch(pages, scales, quant):
    vals = unpack_int4(pages) if quant == "int4" else pages
    return (vals.float() * scales[..., None]).numpy()


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(3), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _submit(eng, reqs):
    return [eng.submit(p, n) for p, n in reqs]


def _same_pools(cache, jcache, quant, pages):
    """Pages `pages` of every layer dequantize equal. Layer 0's rows come
    from the embeddings alone: equal to the fp32 rounding of the scales.
    Deeper rows come from hidden states that went through attention, which
    rounds p to bf16 (PREFILL_TOL): they agree to 1e-4, so a value on a
    rounding edge may land one quantization step apart (int4: the row's
    scale; fp8: one e4m3 step of the value, at most 1/8 of it)."""
    d = TCFG.head_dim
    for tp_, ts_, jp_, js_ in ((cache.k_pages, cache.k_scales, jcache.k_pages,
                                jcache.k_scales),
                               (cache.v_pages, cache.v_scales, jcache.v_pages,
                                jcache.v_scales)):
        td, jd = _dequant_torch(tp_, ts_, quant), _dequant_jax(jp_, js_, quant, d)
        sc = np.asarray(js_)[..., None]
        for layer in range(TCFG.n_layers):
            at = [layer * cache.num_pages + p for p in pages]
            if layer == 0:
                np.testing.assert_allclose(td[:, at], jd[:, at], rtol=1e-5, atol=1e-6)
                continue
            step = sc[:, at] if quant == "int4" else np.exp2(
                np.floor(np.log2(np.maximum(np.abs(jd[:, at]) / sc[:, at], 2.0 ** -6))) - 3
            ) * sc[:, at]
            assert np.all(np.abs(td[:, at] - jd[:, at]) <= 1.001 * step + 1e-4 * np.abs(jd[:, at]))


@pytest.mark.parametrize("quant,chunk", [("fp8", None), ("int4", None),
                                         ("int4", 16)])
def test_engine_and_cache_writes_match_jax(params, quant, chunk):
    """Plain engines over three prompts of one page bucket (a prompt wave,
    then deferred-append decode steps); with chunk 16 the prefix cache too,
    in two waves (two long prompts by chunks and a short one whole; the
    second wave hits the first's shared pages and prefills its suffix
    through the chunked path). Tokens, logprobs, pages back, and the page
    pools written."""
    jp, tp = params
    rng = np.random.RandomState(7)
    shared = [int(t) for t in rng.randint(0, 64, 20)]
    waves = [[([int(t) for t in rng.randint(0, 64, n)], 4) for n in (9, 12, 15)]]
    kw = dict(num_pages=16, page_size=8, max_seqs=4, pages_per_seq=4,
              quant_dtype=quant)
    if chunk:
        waves = [[(shared + [5], 3), ([int(t) for t in rng.randint(0, 64, 27)], 3),
                  ([int(t) for t in rng.randint(0, 64, 11)], 3)],
                 [(shared + [6, 6], 3)]]
        kw.update(prefill_chunk=chunk, prefix_cache=True)
    jeng = JaxEngine(jp, JCFG, **kw)
    eng = Engine(tp, TCFG, device="cpu", **kw)
    free0 = eng.sched.allocator.free_pages
    jreqs, reqs = [], []
    for wave in waves:
        jreqs += _submit(jeng, wave)
        jeng.run()
        reqs += _submit(eng, wave)
        eng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == jr.generated, (r.uid, r.generated, jr.generated)
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-3)
    held = len(eng.sched.prefix.pages) if chunk else 0
    assert eng.sched.allocator.free_pages + held == free0
    if chunk:
        # the pages the prefix cache holds: whole pages of the shared
        # prompt, written by chunks (the rest of a chunked pool holds rows
        # past a length, whose deeper layers each framework leaves its own)
        pages = sorted(eng.sched.prefix.pages.values())
        assert eng.stats.chunk_batches > 0 and pages
        assert pages == sorted(jeng.sched.prefix.pages.values())
    else:
        # every page but the null page 0, where the padding rows of both
        # engines land: the wave's rows, then the deferred appends
        pages = range(1, eng.cache.num_pages)
    _same_pools(eng.cache, jeng.cache, quant, pages)


def test_engine_auto_resolves_like_jax(params):
    """"auto" takes recommend_kv_quant(pages_per_seq * page_size), as the
    JAX Engine does: both pick int8 at this capacity (whose engine is held
    to JAX's in test_torch_engine.py), and the port's auto engine gives the
    tokens of its engine with that format named."""
    jp, tp = params
    kw = dict(num_pages=16, page_size=8, max_seqs=4, pages_per_seq=4)
    jeng = JaxEngine(jp, JCFG, quant_dtype="auto", **kw)
    toks = []
    for quant in ("auto", jeng.quant_dtype):
        eng = Engine(tp, TCFG, device="cpu", quant_dtype=quant, **kw)
        assert eng.quant_dtype == jeng.quant_dtype == "int8"
        reqs = _submit(eng, [(list(range(3, 12)), 4), (list(range(1, 20)), 3)])
        eng.run()
        toks.append([r.generated for r in reqs])
    assert toks[0] == toks[1]
    big = Engine(tp, TCFG, device="cpu", quant_dtype="auto", num_pages=4,
                 page_size=8, max_seqs=1,
                 pages_per_seq=INT4_KV_CROSSOVER_TOKENS // 8)
    assert big.quant_dtype == "int4" and big.cache.k_pages.shape[-1] == 32


def test_recommend_kv_quant_rule():
    n = INT4_KV_CROSSOVER_TOKENS
    assert recommend_kv_quant(n) == "int4" and recommend_kv_quant(n - 1) == "int8"
    assert recommend_kv_quant(n - 1, outlier_tolerant=True) == "fp8"
    assert recommend_kv_quant(1, memory_bound=True) == "int4"
    assert recommend_kv_quant(10 * n, quality_floor=True) == "int8"
    assert recommend_kv_quant(10 * n, quality_floor=True,
                              outlier_tolerant=True) == "fp8"
