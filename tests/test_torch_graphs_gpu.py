"""The decode graphs (mfa_tpu_torch/serve/graphs.py) on the card, at 2
layers of Llama-3-8B's width: a replayed step against the eager
decode_step on the same inputs (logits, KV page bytes, scales and lengths),
a capture that leaves the cache as the eager step left it, replays across a
page boundary and the paged kernel's split point, launch counts through
replays, and recover() dropping the graphs. Needs a CUDA device and nvcc:
on the GPU machine run
`python -m pytest tests/test_torch_graphs_gpu.py -m gpu -q --noconftest -o addopts=""`;
elsewhere every test skips."""

import collections
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

PAGE, PPS = 64, 64


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from mfa_tpu_torch.models import llama, wquant

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0, device="cuda")
    return cfg, {"bf16": params, "int8": wquant.quantize_params(params)}


def _clone(cache):
    return dataclasses.replace(cache, **{
        f: getattr(cache, f).clone()
        for f in ("k_pages", "v_pages", "k_scales", "v_scales",
                  "block_tables", "lengths") if getattr(cache, f) is not None})


def _assert_same_state(a, b):
    from mfa_tpu_torch.kernels.quant import as_bytes

    for f in ("k_pages", "v_pages", "k_scales", "v_scales", "block_tables",
              "lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:  # fp8 pages compare as their bytes
            assert torch.equal(as_bytes(x), as_bytes(y)), f


def _prefilled(cfg, params, quant, lens, page=PAGE, pps=PPS):
    """A cache with len(lens) rows prefilled to `lens` tokens, every table
    entry of every row mapped; -> (cache, slots, first tokens)."""
    from mfa_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(1)
    n = len(lens)
    cache = llama.build_kv_caches(cfg, n * pps + 1, page, 4, pps, quant,
                                  device="cuda")
    pages = [list(range(1 + i * pps, 1 + (i + 1) * pps)) for i in range(n)]
    prompts = [torch.randint(0, cfg.vocab_size, (ln,), generator=gen).tolist()
               for ln in lens]
    cache, logits = llama.prefill_batch(params, cfg, cache, list(range(n)),
                                        pages, prompts)
    slots = torch.arange(n, device="cuda")
    return cache, slots, logits.argmax(-1)


def _graphs(cfg, params):
    from mfa_tpu_torch.serve.engine import EngineStats
    from mfa_tpu_torch.serve.graphs import DecodeGraphs

    return DecodeGraphs(params, cfg, torch.device("cuda"), EngineStats())


def _split_lens():
    """Row 0 one token before a page boundary, row 1 one before the paged
    kernel's first split boundary (the grid of batch 2 at PPS pages)."""
    from mfa_tpu_torch.kernels import paged

    splits, tps = paged.split_plan(2, 8, PPS, PAGE)
    assert splits > 1
    return [PAGE - 1, tps - 1]


@pytest.mark.parametrize("weights,quant", [("bf16", "int8"), ("bf16", None),
                                           ("int8", "int8")])
def test_capture_leaves_the_cache_unchanged(model, weights, quant):
    """The bucket's first step runs eagerly, then the capture: afterwards
    the cache equals a clone after one eager decode_step."""
    from mfa_tpu_torch.models import llama

    cfg, ps = model
    params = ps[weights]
    cache, slots, tokens = _prefilled(cfg, params, quant, _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    toks, _ = g.burst(cache, slots, tokens, 1)
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    torch.cuda.synchronize()
    assert g.stats.captures == 1 and list(g.buckets) == [2]
    assert torch.equal(toks[0], logits.argmax(-1))
    _assert_same_state(cache, ref)


@pytest.mark.parametrize("weights,quant", [("bf16", "int8"), ("bf16", None),
                                           ("int8", "int8"), ("bf16", "int4"),
                                           ("bf16", "fp8")])
def test_replay_matches_eager(model, weights, quant):
    """Four replays crossing a page boundary (row 0) and the paged
    kernel's split point (row 1) against eager steps on a clone: tokens,
    logits and the cache's bytes equal bit for bit (int4 and fp8 pages
    too); the launch counts of the replays are four times the eager
    step's."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.kernels.paged import launch_name
    from mfa_tpu_torch.models import llama

    cfg, ps = model
    params = ps[weights]
    cache, slots, tokens = _prefilled(cfg, params, quant, _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    diffs = []
    for step in range(4):
        _build.reset_launches()
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        eager = collections.Counter(_build.launches)
        _build.reset_launches()
        toks, lps = g.burst(cache, slots, tok, 1)
        replayed = collections.Counter(_build.launches)
        torch.cuda.synchronize()
        ref_tok = logits.argmax(-1)
        tok = toks[0]
        diffs.append(float((g.buckets[2].logits - logits).abs().max()))
        assert torch.equal(tok, ref_tok), step
        assert replayed == eager
        assert eager[launch_name("paged", quant)] == cfg.n_layers
        if weights == "int8":
            assert eager["wmatmul"] == 7 * cfg.n_layers + 1
        _assert_same_state(cache, ref)
    print(f"max |graph - eager| logits per replay: {diffs}")
    assert diffs == [0.0] * 4
    assert cache.lengths[:2].tolist() == [PAGE + 4, _split_lens()[1] + 5]


@pytest.mark.parametrize("quant", ["int8", None])
def test_split_merge_replays_stay_bit_equal(model, quant):
    """100 replays from row 1 one token before the paged kernel's first
    split boundary: the kernel merges its splits in its one launch through
    ticket counters that each launch leaves at zero, so a replay needs no
    memset node. Every replay's tokens and logits equal an eager step's
    bit for bit, the caches end equal, one paged launch a layer and no
    other, and the counters end at zero."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.kernels.paged import launch_name
    from mfa_tpu_torch.models import llama

    cfg, ps = model
    params = ps["bf16"]
    cache, slots, tokens = _prefilled(cfg, params, quant, _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    for step in range(100):
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        _build.reset_launches()
        toks, _ = g.burst(cache, slots, tok, 1)
        replayed = dict(_build.launches)
        ref_tok, tok = logits.argmax(-1), toks[0]
        assert torch.equal(g.buckets[2].logits, logits), step
        assert torch.equal(tok, ref_tok), step
        assert replayed.get(launch_name("paged", quant)) == cfg.n_layers
        assert "combine" not in replayed
    _assert_same_state(cache, ref)
    assert cache.lengths[:2].tolist() == [PAGE + 100, _split_lens()[1] + 101]
    assert not _build.split_counters(torch.device("cuda", 0), 1).any()


@pytest.mark.parametrize("quant,page", [("int8", 12), (None, 12), ("int8", 1)])
def test_page_rows_replay_matches_eager(model, quant, page):
    """Pages of 12 rows (boxes of 4) and of 1 row (int8: rows and scales by
    cp.async), pages a sequence scaled so that a sequence spans 4096
    tokens as at PAGE: four replays, row 0 crossing a page boundary and row
    1 the paged kernel's split point, equal the eager steps bit for bit
    (tokens, logits, the cache's bytes)."""
    from mfa_tpu_torch.kernels import _build, paged
    from mfa_tpu_torch.kernels.paged import launch_name
    from mfa_tpu_torch.models import llama

    cfg, ps = model
    params = ps["bf16"]
    pps = PAGE * PPS // page + 1
    splits, tps = paged.split_plan(2, 8, pps, page)
    assert splits > 1
    lens = [5 * page - 1 if page > 1 else 100, tps - 1]
    cache, slots, tokens = _prefilled(cfg, params, quant, lens, page, pps)
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    for step in range(4):
        _build.reset_launches()
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        eager = collections.Counter(_build.launches)
        _build.reset_launches()
        toks, _ = g.burst(cache, slots, tok, 1)
        replayed = collections.Counter(_build.launches)
        torch.cuda.synchronize()
        ref_tok, tok = logits.argmax(-1), toks[0]
        assert torch.equal(g.buckets[2].logits, logits), step
        assert torch.equal(tok, ref_tok) and replayed == eager
        assert eager[launch_name("paged", quant)] == cfg.n_layers
        _assert_same_state(cache, ref)
    del cache, ref, g
    torch.cuda.empty_cache()


def test_moe_replay_matches_eager():
    """Two layers of Mixtral-8x7B's widths with int8 weights and banks:
    replayed decode steps (the dense MoE form: three expert launches a
    layer, no atomics) equal the eager steps bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=2)
    params = llama.init_params(cfg, seed=0, device="cuda", quantize="int8")
    cache, slots, tokens = _prefilled(cfg, params, "int8", _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    for step in range(3):
        _build.reset_launches()
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        eager = collections.Counter(_build.launches)
        _build.reset_launches()
        toks, _ = g.burst(cache, slots, tok, 1)
        replayed = collections.Counter(_build.launches)
        torch.cuda.synchronize()
        ref_tok, tok = logits.argmax(-1), toks[0]
        assert torch.equal(g.buckets[2].logits, logits), step
        assert torch.equal(tok, ref_tok) and replayed == eager
        assert eager["wmatmul_bank"] == 3 * cfg.n_layers
        _assert_same_state(cache, ref)
    del params, cache, ref, g
    torch.cuda.empty_cache()


def test_sinks_replay_matches_eager():
    """Two layers of Mistral-7B's widths with 4 attention sinks and a
    window of 128 (rows past it: the sink pages are read apart from the
    band, across the paged kernel's split point): replayed decode steps
    equal the eager steps bit for bit, int8 KV."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.mistral_7b(), n_layers=2,
                              sliding_window=128, attn_sinks=4)
    params = llama.init_params(cfg, seed=0, device="cuda")
    cache, slots, tokens = _prefilled(cfg, params, "int8", _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    for step in range(4):
        _build.reset_launches()
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        eager = collections.Counter(_build.launches)
        _build.reset_launches()
        toks, _ = g.burst(cache, slots, tok, 1)
        replayed = collections.Counter(_build.launches)
        torch.cuda.synchronize()
        ref_tok, tok = logits.argmax(-1), toks[0]
        assert torch.equal(g.buckets[2].logits, logits), step
        assert torch.equal(tok, ref_tok) and replayed == eager
        assert eager["paged"] == cfg.n_layers
        _assert_same_state(cache, ref)
    del params, cache, ref, g
    torch.cuda.empty_cache()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_head_dim_80_replay_matches_eager(quant):
    """Two layers of H2O-Danube-1.8B's widths (head_dim 80, 4 q heads a kv
    head, window 4096): replayed decode steps equal the eager steps bit for
    bit, on int8 KV (80-byte rows) and int4 KV (rows widened to 48 bytes,
    q padded to 96 features inside the graph), across a page boundary and
    the paged kernel's split point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.kernels.quant import row_width
    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.h2o_danube_1_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0, device="cuda")
    cache, slots, tokens = _prefilled(cfg, params, quant, _split_lens())
    assert cache.k_pages.shape[-1] == row_width(quant, 80)
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)  # eager first step + capture
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok, ref_tok = g.buckets[2].tokens.clone(), logits.argmax(-1)
    name = "paged_int4" if quant == "int4" else "paged"
    for step in range(4):
        _build.reset_launches()
        _, logits = llama.decode_step(params, cfg, ref, slots, ref_tok)
        eager = collections.Counter(_build.launches)
        _build.reset_launches()
        toks, _ = g.burst(cache, slots, tok, 1)
        replayed = collections.Counter(_build.launches)
        torch.cuda.synchronize()
        ref_tok, tok = logits.argmax(-1), toks[0]
        assert torch.equal(g.buckets[2].logits, logits), step
        assert torch.equal(tok, ref_tok) and replayed == eager
        assert eager[name] == cfg.n_layers
        _assert_same_state(cache, ref)
    del params, cache, ref, g
    torch.cuda.empty_cache()


def test_burst_counts_and_chains(model):
    """One 5-step burst from the graph: its tokens equal five eager steps
    chained on the host, and the counts are five times one step's."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    cfg, ps = model
    params = ps["bf16"]
    cache, slots, tokens = _prefilled(cfg, params, "int8", _split_lens())
    ref = _clone(cache)
    g = _graphs(cfg, params)
    g.burst(cache, slots, tokens, 1)
    _, logits = llama.decode_step(params, cfg, ref, slots, tokens)
    tok = logits.argmax(-1)
    _build.reset_launches()
    want = []
    for _ in range(5):
        _, logits = llama.decode_step(params, cfg, ref, slots, tok)
        tok = logits.argmax(-1)
        want.append(tok)
    eager = collections.Counter(_build.launches)
    _build.reset_launches()
    toks, lps = g.burst(cache, slots, g.buckets[2].tokens.clone(), 5)
    torch.cuda.synchronize()
    assert collections.Counter(_build.launches) == eager
    assert torch.equal(toks, torch.stack(want))
    assert torch.isfinite(lps).all() and g.stats.captures == 1
    _assert_same_state(cache, ref)


def test_recover_drops_and_recaptures(model):
    from mfa_tpu_torch.serve.engine import Engine

    cfg, ps = model
    eng = Engine(ps["bf16"], cfg, num_pages=64, page_size=PAGE, max_seqs=4,
                 pages_per_seq=8, quant_dtype="int8", device="cuda")
    gen = torch.Generator().manual_seed(2)
    reqs = [eng.submit(torch.randint(0, cfg.vocab_size, (n,),
                                     generator=gen).tolist(), 12)
            for n in (100, 150, 70)]
    for _ in range(4):
        eng.step()
    assert list(eng.graphs.buckets) == [4] and eng.stats.captures == 1
    old_cache = eng.cache
    assert eng.recover() == 3
    assert not eng.graphs.buckets and eng.cache is not old_cache
    eng.run(burst=4)
    assert eng.stats.captures == 2 and eng.stats.recoveries == 1
    assert all(len(r.generated) == 12 for r in reqs)
    assert eng.sched.allocator.free_pages == 63


def test_sampled_replay_matches_eager(model):
    """A sampling engine's graph (per-row vectors, presence rows, the
    engine's top-k) against eager steps from the same generator state:
    tokens, logprobs, presence rows and the cache bit-equal over a 4-step
    burst; each replay draws its noise eagerly, so the generators end in
    the same state."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import EngineStats
    from mfa_tpu_torch.serve.graphs import DecodeGraphs
    from mfa_tpu_torch.serve.sampling import SamplingParams

    cfg, ps = model
    params = ps["bf16"]
    cache, slots, tokens = _prefilled(cfg, params, "int8", _split_lens())
    ref = _clone(cache)
    sp = SamplingParams(top_k=50)
    vecs = torch.tensor([[0.8, 0.0], [0.9, 1.0], [0.0, 0.0], [1.0, 1.3]],
                        device="cuda")
    pres = torch.zeros(2, cfg.vocab_size, dtype=torch.bool, device="cuda")
    pres[1, tokens[1]] = True
    pres_ref = pres.clone()
    g = DecodeGraphs(params, cfg, torch.device("cuda"), EngineStats(), sp)
    gen_g = torch.Generator(device="cuda").manual_seed(5)
    gen_e = torch.Generator(device="cuda").manual_seed(5)
    toks, lps = g.burst(cache, slots, tokens, 4, pres, vecs, gen_g)
    _, etoks, elps = llama.decode_burst(params, cfg, ref, slots, tokens, 4, sp,
                                        gen_e, pres_ref, vecs)
    torch.cuda.synchronize()
    assert g.stats.captures == 1 and list(g.buckets) == [(2, True, True)]
    assert torch.equal(toks, etoks) and torch.equal(lps, elps)
    assert torch.equal(pres, pres_ref)
    assert torch.equal(gen_g.get_state(), gen_e.get_state())
    _assert_same_state(cache, ref)


def test_speculative_replay_matches_eager(model):
    """A greedy speculative iteration (k 4: draft steps, verify, accept,
    both caches' lengths) replayed from its graph twice against eager
    iterations on clones: every output and both caches bit-equal, and the
    replays' launch counts those of the eager iterations (paged_span one
    per target layer)."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import EngineStats
    from mfa_tpu_torch.serve.graphs import SpeculativeGraphs

    cfg, ps = model
    params = ps["bf16"]
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    draft = dict(params, layers=params["layers"][:1])
    cache, slots, tokens = _prefilled(cfg, params, "int8", _split_lens())
    dcache, _, _ = _prefilled(draft_cfg, draft, "int8", _split_lens())
    ref, dref = _clone(cache), _clone(dcache)
    g = SpeculativeGraphs(params, draft, cfg, draft_cfg, torch.device("cuda"),
                          EngineStats())
    g.burst(cache, dcache, slots, tokens, 4, 1)  # eager iteration + capture
    *_, nxt = llama.speculative_iteration(params, draft, cfg, draft_cfg, ref,
                                          dref, slots, tokens, 4)
    tok = g.buckets[(2, 4)].tokens.clone()
    assert torch.equal(tok, nxt)
    _build.reset_launches()
    want = llama.speculative_burst(params, draft, cfg, draft_cfg, ref, dref,
                                   slots, nxt, 4, 2)
    eager = collections.Counter(_build.launches)
    _build.reset_launches()
    got = g.burst(cache, dcache, slots, tok, 4, 2)
    torch.cuda.synchronize()
    assert collections.Counter(_build.launches) == eager
    assert eager["paged_span"] == 2 * cfg.n_layers
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _assert_same_state(cache, ref)
    _assert_same_state(dcache, dref)
