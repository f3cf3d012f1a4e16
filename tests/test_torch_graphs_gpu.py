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
    for f in ("k_pages", "v_pages", "k_scales", "v_scales", "block_tables",
              "lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


def _prefilled(cfg, params, quant, lens):
    """A cache with len(lens) rows prefilled to `lens` tokens, every table
    entry of every row mapped; -> (cache, slots, first tokens)."""
    from mfa_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(1)
    n = len(lens)
    cache = llama.build_kv_caches(cfg, n * PPS + 1, PAGE, 4, PPS, quant,
                                  device="cuda")
    pages = [list(range(1 + i * PPS, 1 + (i + 1) * PPS)) for i in range(n)]
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
                                           ("int8", "int8")])
def test_replay_matches_eager(model, weights, quant):
    """Four replays crossing a page boundary (row 0) and the paged
    kernel's split point (row 1) against eager steps on a clone: tokens,
    logits and the cache's bytes equal bit for bit; the launch counts of
    the replays are four times the eager step's."""
    from mfa_tpu_torch.kernels import _build
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
        assert replayed == eager and eager["paged"] == cfg.n_layers
        if weights == "int8":
            assert eager["wmatmul"] == 7 * cfg.n_layers + 1
        _assert_same_state(cache, ref)
    print(f"max |graph - eager| logits per replay: {diffs}")
    assert diffs == [0.0] * 4
    assert cache.lengths[:2].tolist() == [PAGE + 4, _split_lens()[1] + 5]


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
