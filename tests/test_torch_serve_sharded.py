"""The port's tensor-parallel serving and training (Engine(mesh=),
llama.decode_step / loss_fn / train_step with a mesh, shard_params,
shard_cache) against mfa_tpu (tests/test_serve_sharded.py, case by case).

The port runs SPMD in 4 gloo ranks on the CPU, spawned once for this file
(tests/torch_rank_fns.py holds their functions, free of JAX): every rank
builds an Engine over its own shard and gets the same submits. The
engines must be token-identical to mfa_tpu's engine on the same fp32
weights (mfa_tpu's own test holds its TP engine token-identical to its
unsharded one, which is the cheaper reference here); logits, losses and
updated weights within 1e-4."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfa_tpu.models import llama as jl
from mfa_tpu.models import wquant as jw
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.shard.launch import Ranks
from tests import torch_rank_fns as R
from tests.jax_maps import release_jax_code  # noqa: F401

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11] * 12]
KW = dict(vocab=128, dim=64, layers=2, heads=8, kv_heads=4, ffn=96)
EKW = dict(num_pages=48, page_size=16, max_seqs=4, pages_per_seq=8)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, device="cpu", threads=1, timeout_s=300) as r:
        yield r


def _jcfg(**kw):
    return jl.LlamaConfig.tiny(dtype=jnp.float32, **{**KW, **kw})


def _jax_gens(params, cfg, quant=None):
    eng = JaxEngine(params, cfg, quant_dtype=quant, **EKW)
    reqs = [eng.submit(p, 4) for p in PROMPTS]
    eng.run()
    return [r.generated for r in reqs]


def _port(ranks, axes, params, kw, quant=None):
    outs = [o for o in ranks.run(R.tp_engine, axes, R.plain(params), {**KW, **kw},
                                 dict(EKW, quant_dtype=quant), PROMPTS, 4)
            if o is not None]
    assert len(outs) == int(np.prod(list(axes.values())))
    return outs


@pytest.fixture(scope="module")
def plain():
    """The fp32 model of seed 0 and mfa_tpu's engine's tokens."""
    cfg = _jcfg()
    params = jl.init_params(jax.random.key(0), cfg)
    return params, _jax_gens(params, cfg)


def test_sharded_engine_matches_unsharded(ranks, plain):
    params, want = plain
    for out in _port(ranks, {"model": 4}, params, {}):
        assert out["gens"] == want
        assert out["kv_heads"] == KW["kv_heads"] // 4  # the rank's kv heads
        assert out["captures"] == 0  # gloo: the steps run eagerly


def test_sharded_engine_recovers(ranks, plain):
    """A decode step that fails on every rank: recover() rebuilds each
    rank's pools of its kv heads, and the re-prefilled requests finish
    with mfa_tpu's tokens."""
    params, want = plain
    outs = [o for o in ranks.run(R.tp_engine, {"model": 2}, R.plain(params), KW,
                                 EKW, PROMPTS, 4, None, True,
                                 dict(max_retries=1)) if o is not None]
    assert len(outs) == 2
    for out in outs:
        assert out["gens"] == want and out["recoveries"] == 1


@pytest.mark.parametrize("pipeline", [False, True])
def test_sharded_engine_bursts(ranks, plain, pipeline):
    """Decode bursts of 4 under TP, stepped and pipelined (two bursts in
    flight): every rank checks each burst's tokens, which equal mfa_tpu's
    stepwise engine's."""
    params, want = plain
    outs = [o for o in ranks.run(R.tp_engine, {"model": 2}, R.plain(params), KW,
                                 EKW, PROMPTS, 4,
                                 run_kw=dict(burst=4, pipeline=pipeline))
            if o is not None]
    assert len(outs) == 2
    for out in outs:
        assert out["gens"] == want


def test_sharded_speculative_engine(ranks, plain):
    """A 1-layer draft sharded on the same mesh: greedy speculative output
    is the target's greedy output (mfa_tpu's engine's tokens)."""
    params, want = plain
    dkw = dict(KW, layers=1)
    draft = jl.init_params(jax.random.key(11), _jcfg(layers=1))
    outs = [o for o in ranks.run(R.tp_engine, {"model": 2}, R.plain(params), KW,
                                 dict(EKW, spec_tokens=2), PROMPTS, 4,
                                 (R.plain(draft), dkw)) if o is not None]
    assert len(outs) == 2
    for out in outs:
        assert out["gens"] == want


def test_sharded_chunked_prefix_engine(ranks):
    """Chunked prefill (chunks of 16) and the prefix cache under TP (kernel
    8's plain version on the rank's kv heads, the chunk's K/V written to
    its pages first) against mfa_tpu's engine with the same options."""
    cfg = _jcfg()
    params = jl.init_params(jax.random.key(12), cfg)
    system = list(range(3, 35))  # two pages shared by the last three
    prompts = [list(range(40, 90)), system + [7, 8], system + [9],
               system + [10, 11, 12]]
    ekw = dict(EKW, prefill_chunk=16, prefix_cache=True)
    eng = JaxEngine(params, cfg, **ekw)
    first = [eng.submit(p, 4) for p in prompts[:2]]
    eng.run()
    rest = [eng.submit(p, 4) for p in prompts[2:]]
    eng.run()
    want = [r.generated for r in first + rest]
    outs = [o for o in ranks.run(R.tp_engine, {"model": 2}, R.plain(params), KW,
                                 ekw, prompts, 4, first_wave=2) if o is not None]
    assert len(outs) == 2
    for out in outs:
        assert out["gens"] == want
        # the two later prompts skipped the two cached system-prompt pages
        assert out["prefill_tokens"] == eng.stats.prefill_tokens
        assert out["prefill_tokens"] == sum(map(len, prompts)) - 2 * 32


def test_sharded_engine_quantized_runs(ranks):
    cfg = _jcfg()
    params = jl.init_params(jax.random.key(1), cfg)
    want = _jax_gens(params, cfg, "int8")
    for out in _port(ranks, {"model": 2}, params, {}, "int8"):
        assert out["gens"] == want and all(len(g) == 4 for g in out["gens"])
        assert out["kv_heads"] == 2


def test_sharded_engine_int8_weights(ranks):
    """int8 weights (kernel 10's plain version) on the rank's columns of
    wq/wk/wv/w_gate/w_up and rows of wo/w_down, their scales cut by
    wquant.adapt."""
    cfg = _jcfg()
    params = jw.quantize_params(jl.init_params(jax.random.key(6), cfg),
                                include_embed=False)
    want = _jax_gens(params, cfg)
    for out in _port(ranks, {"model": 2}, params, {}):
        assert out["gens"] == want


def test_cache_shardings_validates_divisibility(ranks):
    cfg = _jcfg()
    params = jl.init_params(jax.random.key(0), cfg)
    outs = [o for o in ranks.run(R.tp_engine_refusals, {"model": 4},
                                 R.plain(params), KW) if o is not None]
    assert len(outs) == 4
    for o in outs:
        assert "divide" in o["cache"]  # 3 kv heads over 4 ranks
        assert "divide" in o["layer_cache"]  # the per-layer cache too
        assert "shard" in o["full_params"]  # Engine(mesh=) takes a shard


def test_shard_cache_takes_a_layer_cache(ranks):
    """shard_cache on a per-layer PagedKVCache (mfa_tpu's cache_shardings on
    a create_cache): each rank keeps its kv heads' pages and scales, and
    the whole tables and lengths."""
    rng = np.random.RandomState(4)
    k, v = (rng.standard_normal((20, 4, 32)).astype(np.float32) for _ in range(2))
    outs = [o for o in ranks.run(R.layer_cache_shard, {"model": 2}, k, v)
            if o is not None]
    assert len(outs) == 2
    for part, want, kind in outs:
        assert kind == "PagedKVCache" and part["k_pages"].shape[0] == 2
        for f, a in part.items():
            np.testing.assert_array_equal(a, want[f], err_msg=f)


def test_decode_step_sharded_matches_dense(ranks):
    """decode_step with a mesh on the rank's shard of the cache == mfa_tpu's
    decode_step without one, on the same cache state."""
    cfg = _jcfg()
    params = jl.init_params(jax.random.key(2), cfg)
    cache = jl.build_kv_caches(cfg, 16, 16, 2, 4)
    cache, _ = jl.prefill_step(params, cfg, cache, 0, [1],
                               jnp.asarray([3, 1, 4], jnp.int32))
    c_ref, logits_ref = jl.decode_step(params, cfg, cache,
                                       jnp.asarray([0], jnp.int32),
                                       jnp.asarray([5], jnp.int32))
    outs = [o for o in ranks.run(R.tp_decode_step, {"model": 4}, R.plain(params),
                                 KW, [3, 1, 4], 5) if o is not None]
    assert len(outs) == 4
    for logits, lengths in outs:
        np.testing.assert_allclose(logits, np.asarray(logits_ref), **TOL)
        np.testing.assert_array_equal(lengths, np.asarray(c_ref.lengths))


def test_sharded_gemma2_style_matches_unsharded(ranks):
    """The family knobs (alternating windows, post-norms, softcaps, q/k/v
    bias) under TP."""
    kw = dict(sliding_window=16, alt_window=True, post_norms=True,
              norm_offset=True, embed_scale=True, hidden_act="gelu_tanh",
              attn_softcap=50.0, logit_softcap=30.0, qkv_bias=True)
    cfg = _jcfg(**kw)
    params = jl.init_params(jax.random.key(2), cfg)
    params["layers"]["bq"] = (jax.random.normal(
        jax.random.key(3), params["layers"]["bq"].shape) * 0.1).astype(cfg.dtype)
    params["layers"]["post_attn_norm"] = jax.random.normal(
        jax.random.key(4), params["layers"]["post_attn_norm"].shape) * 0.1
    want = _jax_gens(params, cfg)
    for out in _port(ranks, {"model": 4}, params, kw):
        assert out["gens"] == want


@pytest.mark.parametrize("axes", [{"model": 4}, {"expert": 2, "model": 2}])
def test_sharded_moe_matches_unsharded(ranks, axes):
    """Mixtral-style MoE: banks on the ffn dim under TP; with an "expert"
    axis, expert-parallel (the dense local form in decode steps, the
    grouped one in waves)."""
    kw = dict(n_experts=4, n_active_experts=2)
    cfg = _jcfg(**kw)
    params = jl.init_params(jax.random.key(5), cfg)
    want = _jax_gens(params, cfg)
    for out in _port(ranks, axes, params, kw):
        assert out["gens"] == want


def test_sharded_train_step_matches_unsharded(ranks):
    """loss_fn and train_step under {"data": 2, "model": 2}: each data rank
    takes its rows, each model rank its heads and ffn columns; the loss and
    every updated weight (gathered back) equal mfa_tpu's unsharded SGD
    step (qk norms and q/k/v biases included)."""
    kw = dict(qk_norm=True, qkv_bias=True)
    cfg = _jcfg(**kw)
    params = jl.init_params(jax.random.key(7), cfg)
    params["layers"]["bq"] = (jax.random.normal(
        jax.random.key(8), params["layers"]["bq"].shape) * 0.1).astype(cfg.dtype)
    tokens = np.asarray(jax.random.randint(jax.random.key(9), (4, 17), 0, 128),
                        np.int32)
    lr = 1e-2
    new, loss = jl.train_step(params, jnp.asarray(tokens), cfg, lr=lr)
    from mfa_tpu_torch.models import llama as tl

    order = [k for k in tl._LAYER_KEYS + tl._GEMMA_KEYS + tl._BIAS_KEYS
             if k in new["layers"]]
    want = [np.asarray(new["layers"][k][i]) for i in range(cfg.n_layers)
            for k in order] + [np.asarray(new[k]) for k in
                               ("embed", "final_norm", "lm_head")]
    outs = [o for o in ranks.run(R.tp_train, {"data": 2, "model": 2},
                                 R.plain(params), {**KW, **kw}, tokens, lr)
            if o is not None]
    assert len(outs) == 4
    for got_loss, step_loss, full in outs:
        np.testing.assert_allclose(got_loss, float(loss), **TOL)
        np.testing.assert_allclose(step_loss, float(loss), **TOL)
        for g, w in zip(full, want):
            np.testing.assert_allclose(g, w, **TOL)
