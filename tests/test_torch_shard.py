"""The port's sharding layer (mfa_tpu_torch/shard/mesh.py, attention.py,
ring.py) against mfa_tpu's (tests/test_sharding.py, case by case).

The port runs SPMD in 8 gloo ranks on the CPU, spawned once for this file
(shard/launch.py; their functions live in tests/torch_rank_fns.py, which
imports no JAX). The JAX side runs in this process on tests/conftest.py's
8-device mesh, Pallas in interpret mode, on the same numpy inputs from a
seed. Tolerances: fp32 attention and ring outputs atol 2e-5 (what
tests/test_sharding.py holds JAX's context-parallel and ring outputs to);
gradients and losses 1e-4; int8 pages 1e-4 (the same payloads and scales
on both sides, q in fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.quant import quantize_rows
from mfa_tpu.models import llama as jl
from mfa_tpu.shard import attention as ja
from mfa_tpu.shard import ring as jr
from mfa_tpu.shard.mesh import make_mesh
from mfa_tpu_torch.shard.launch import Ranks
from tests import torch_rank_fns as R
from tests.jax_maps import release_jax_code  # noqa: F401

ATOL = 2e-5
GRAD = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(8, device="cpu", threads=1, timeout_s=300) as r:
        yield r


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _assemble(outs, shape, spec):
    """Full array from the ranks' (coord, block) results under spec (one
    axis name or None per dim)."""
    full = np.zeros(shape, np.float32)
    for res in outs:
        if res is None:
            continue
        coord, block = res
        idx = []
        for dim, axis in enumerate(spec):
            n = block.shape[dim]
            i = 0 if axis is None else coord[axis]
            idx.append(slice(i * n, (i + 1) * n))
        full[tuple(idx)] = block
    return full


def _ring_full(outs, shape):
    """The ranks' chunks of [b, h, s, d] along s, in ring order."""
    return _assemble([({"ctx": r[0]}, r[1]) for r in outs if r is not None],
                     shape, (None, None, "ctx", None))


def test_mesh_construction(ranks):
    axes = {"data": 2, "model": 4}
    jmesh = make_mesh(axes)
    infos = ranks.run(R.mesh_info, axes)
    for rank, info in enumerate(infos):
        assert dict(zip(info["names"], info["sizes"])) == dict(jmesh.shape)
        assert list(info["coord"]) == [rank // 4, rank % 4]
        # psum of the ranks over each axis: data pairs r and r + 4
        assert info["sums"]["data"] == (rank % 4) * 2 + 4
        assert info["sums"]["model"] == sum(range(4)) + 16 * (rank // 4)
        assert info["rank"] == rank
    default = ranks.run(R.mesh_info, None)[0]
    assert default["names"] == ("data",) and default["sizes"] == [8]
    err = ranks.run(R.make_mesh_error, {"data": 16})[0]
    assert err and "needs 16 ranks" in err


@pytest.mark.parametrize("n", [2, 4, 8])
def test_collectives_on_a_ring(ranks, n):
    outs = [o for o in ranks.run(R.collectives, {"ctx": n}) if o is not None]
    assert len(outs) == n
    x = [np.arange(4, dtype=np.float32) + 10 * i for i in range(n)]
    for o in outs:
        i = o["me"]
        np.testing.assert_array_equal(o["psum"], sum(x))
        np.testing.assert_array_equal(o["pmax"], x[-1])
        np.testing.assert_array_equal(o["fwd"], x[(i - 1) % n])
        np.testing.assert_array_equal(o["back"], x[(i + 1) % n])
        np.testing.assert_array_equal(o["a2a"][:, 0],
                                      [i + 10 * j for j in range(n)])
        np.testing.assert_array_equal(o["gathered"], np.stack(x))
        if i == n - 1:
            np.testing.assert_array_equal(o["recv"], x[0] * 2)
        np.testing.assert_array_equal(o["g_reduce"], np.full(3, i + 1.0))
        np.testing.assert_array_equal(o["g_copy"],
                                      np.full(3, n * (n + 1) / 2))


def test_sharded_prefill_tp_dp(ranks):
    axes = {"data": 2, "model": 4}
    q, k, v = _rand(0, 4, 256, 8, 64), _rand(1, 4, 256, 4, 64), _rand(2, 4, 256, 4, 64)
    want = ja.sharded_flash_attn(make_mesh(axes), causal=True)(q, k, v)
    outs = ranks.run(R.sharded_prefill, axes, q, k, v, True)
    got = _assemble(outs, q.shape, ("data", None, "model", None))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _paged_inputs(batch, heads, kvh, d, page, pps, seed):
    num_pages = batch * pps + 2
    q = _rand(seed, batch, heads, d)
    kp = _rand(seed + 1, kvh, num_pages, page, d)
    vp = _rand(seed + 2, kvh, num_pages, page, d)
    table = np.random.RandomState(seed + 3).permutation(num_pages)[
        : batch * pps].reshape(batch, pps).astype(np.int32)
    return q, kp, vp, table


def test_sharded_paged_decode_tp(ranks):
    axes = {"data": 2, "model": 4}
    q, kp, vp, table = _paged_inputs(4, 8, 4, 64, 16, 4, 3)
    lens = np.asarray([64, 30, 17, 50], np.int32)
    want = ja.sharded_paged_decode(make_mesh(axes))(q, kp, vp, lens, table)
    outs = ranks.run(R.sharded_paged, axes, q, kp, vp, lens, table)
    got = _assemble(outs, q.shape, ("data", "model", None))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_sharded_paged_decode_quantized(ranks, quant):
    """int8 / fp8 / int4 pages with their scales, the same quantization on
    both sides (int4: JAX packs token pairs, the port feature pairs, from
    the same values; fp8: the same bytes)."""
    from mfa_tpu.kernels.quant import pack_int4_pairs
    from mfa_tpu_torch.kernels.quant import pack_int4

    axes = {"data": 1, "model": 2}
    batch, d, page = 2, 64, 16
    q = _rand(7, batch, 4, d)
    (kq, ks), (vq, vs) = (quantize_rows(jnp.asarray(_rand(s, 2, 8, page, d)), quant)
                          for s in (8, 9))
    ks, vs = np.asarray(ks), np.asarray(vs)
    if quant == "int4":
        jk, jv = (pack_int4_pairs(a.reshape(2, 8 * page, d)).reshape(
            2, 8, page // 2, d) for a in (kq, vq))
        tk, tv = (pack_int4(torch.from_numpy(np.array(a))).numpy()
                  for a in (kq, vq))
    else:
        jk, jv = kq, vq
        tk, tv = (np.asarray(a).view(np.uint8) if quant == "fp8"
                  else np.asarray(a) for a in (kq, vq))
    table = np.arange(batch * 2, dtype=np.int32).reshape(batch, 2)
    lens = np.asarray([32, 20], np.int32)
    want = ja.sharded_paged_decode(
        make_mesh(axes), quantized="int4" if quant == "int4" else True)(
        q, jk, jv, lens, table, ks, vs)
    outs = ranks.run(R.sharded_paged, axes, q, tk, tv, lens, table, ks, vs, quant)
    got = _assemble(outs, q.shape, ("data", "model", None))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("ctx", [2, 8])
def test_context_parallel_decode(ranks, ctx):
    axes = {"ctx": ctx}
    q, k, v = _rand(10, 2, 4, 64), _rand(11, 2, 2, 512, 64), _rand(12, 2, 2, 512, 64)
    lens = np.asarray([512, 100], np.int32)  # seq 2 lives on the first shards
    want = ja.context_parallel_decode(make_mesh(axes))(q, k, v, lens)
    outs = [o for o in ranks.run(R.cp_decode, axes, q, k, v, lens) if o is not None]
    assert len(outs) == ctx
    for got in outs:  # the combined output on every rank
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_context_parallel_matches_single_device(ranks):
    from mfa_tpu.kernels.decode import decode_attention

    q, k, v = _rand(13, 1, 2, 64), _rand(14, 1, 2, 256, 64), _rand(15, 1, 2, 256, 64)
    lens = np.asarray([256], np.int32)
    want = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens))
    got = ranks.run(R.cp_decode, {"ctx": 4}, q, k, v, lens)[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_prefill(ranks, causal):
    axes = {"ctx": 4}
    q, k, v = (_rand(20 + i, 1, 2, 512, 64) for i in range(3))
    want = jr.ring_attention_prefill(make_mesh(axes), causal=causal)(q, k, v)
    got = _ring_full(ranks.run(R.ring_prefill, axes, q, k, v,
                               dict(causal=causal)), q.shape)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_context_parallel_paged_decode_matches_single_pool(ranks):
    """Page pool sharded over ctx: each rank's pool, local lengths and
    tables, the LSE merge; the same inputs as mfa_tpu's test."""
    n_shards, batch, hkv, group, d, page, pps = 4, 2, 2, 2, 64, 64, 2
    pool = batch * pps + 1
    q = _rand(0, batch, hkv * group, d)
    kp, vp = _rand(1, hkv, n_shards * pool, page, d), _rand(2, hkv, n_shards * pool, page, d)
    local_lens = np.zeros((n_shards, batch), np.int32)
    local_tables = np.zeros((n_shards, batch, pps), np.int32)
    for s in range(n_shards):
        for b in range(batch):
            local_lens[s, b] = [128, 100][b] if s < 3 else [64, 0][b]
            local_tables[s, b] = 1 + b * pps + np.arange(pps)
    axes = {"ctx": n_shards}
    want = ja.context_parallel_paged_decode(make_mesh(axes))(
        q, kp, vp, local_lens, local_tables)
    outs = [o for o in ranks.run(R.cp_paged_decode, axes, q, kp, vp, local_lens,
                                 local_tables) if o is not None]
    assert len(outs) == n_shards
    for got in outs:
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _ring_grads_both(ranks, axes, shape, seed, jkw, tkw):
    q, k, v, w = (_rand(seed + i, *shape) for i in range(4))
    f = jr.ring_attention_grad(make_mesh(axes), **jkw)
    want = jax.grad(lambda q, k, v: (f(q, k, v) * w).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    outs = [o for o in ranks.run(R.ring_grad, axes, q, k, v, w, tkw) if o]
    for i, name in enumerate(("dq", "dk", "dv")):
        got = _ring_full([(c, g[i]) for c, g in outs], shape)
        np.testing.assert_allclose(got, np.asarray(want[i]), err_msg=name,
                                   **GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grad(ranks, causal):
    _ring_grads_both(ranks, {"ctx": 4}, (1, 2, 256, 64), 30,
                     dict(causal=causal), dict(causal=causal))


def test_ring_grad_sliding_window(ranks):
    _ring_grads_both(ranks, {"ctx": 4}, (1, 2, 128, 64), 3,
                     dict(causal=True, window_left=40),
                     dict(causal=True, window_left=40))


def test_ring_grad_refuses_a_noncausal_window(ranks):
    from mfa_tpu_torch.shard.ring import ring_attention_grad

    with pytest.raises(NotImplementedError, match="inference-only"):
        ring_attention_grad(None, causal=False, window_left=8)


@pytest.mark.parametrize("wl", [10, 40, 100])
def test_ring_prefill_sliding_window(ranks, wl):
    axes = {"ctx": 4}
    q, k, v = (_rand(40 + i, 1, 2, 128, 64) for i in range(3))
    want = jr.ring_attention_prefill(make_mesh(axes), causal=True,
                                     window_left=wl)(q, k, v)
    got = _ring_full(ranks.run(R.ring_prefill, axes, q, k, v,
                               dict(causal=True, window_left=wl)), q.shape)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("wl,wr", [(10, 20), (40, 10), (-1, 20), (40, -1),
                                   (100, 100)])
def test_ring_prefill_noncausal_band(ranks, wl, wr):
    axes = {"ctx": 4}
    q, k, v = (_rand(50 + i, 1, 2, 128, 64) for i in range(3))
    want = jr.ring_attention_prefill(make_mesh(axes), causal=False,
                                     window_left=wl, window_right=wr)(q, k, v)
    got = _ring_full(ranks.run(R.ring_prefill, axes, q, k, v,
                               dict(causal=False, window_left=wl,
                                    window_right=wr)), q.shape)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _tiny(**kw):
    return dict(vocab=64, dim=64, layers=2, heads=4, kv_heads=2, ffn=128, **kw)


def _jax_tree(kw, seed):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    return jcfg, jl.init_params(jax.random.key(seed), jcfg)


def _sp_case(ranks, kw, seed):
    """sequence_parallel_loss_fn on 4 ctx ranks against mfa_tpu's loss_fn
    value and gradients (mfa_tpu's own test holds its sequence-parallel
    loss equal to loss_fn)."""
    jcfg, jp = _jax_tree(kw, seed)
    tokens = np.random.RandomState(seed + 1).randint(0, 64, (2, 33)).astype(np.int32)
    want, g_want = jax.value_and_grad(jl.loss_fn)(jp, jnp.asarray(tokens), jcfg)
    outs = [o for o in ranks.run(R.sp_loss, {"ctx": 4}, jax.tree.map(np.asarray, jp),
                                 kw, tokens) if o is not None]
    assert len(outs) == 4
    flat_want = [np.asarray(g_want["layers"][k][i])
                 for i in range(jcfg.n_layers) for k in _layer_names(g_want)] + [
        np.asarray(g_want[k]) for k in ("embed", "final_norm", "lm_head")]
    for loss, grads in outs:  # every rank: the loss and the full gradients
        np.testing.assert_allclose(loss, float(want), **GRAD)
        assert len(grads) == len(flat_want)
        for g, w in zip(grads, flat_want):
            np.testing.assert_allclose(g, w, **GRAD)


def _layer_names(tree):
    """param_tensors' order of a dense layer's keys."""
    from mfa_tpu_torch.models import llama as tl

    order = tl._LAYER_KEYS + tl._GEMMA_KEYS + tl._BIAS_KEYS
    return [k for k in order if k in tree["layers"]]


def test_sequence_parallel_loss_and_grads(ranks):
    _sp_case(ranks, _tiny(), 0)


def test_sequence_parallel_sliding_window_model(ranks):
    _sp_case(ranks, _tiny(sliding_window=12), 7)


def test_sequence_parallel_rejects_unsupported_attention(ranks):
    tokens = np.zeros((1, 33), np.int32)
    for kw in ({"attn_softcap": 30.0}, {"attn_sinks": 4}):
        _, jp = _jax_tree(_tiny(), 0)
        msgs = [o for o in ranks.run(R.sp_loss, {"ctx": 4}, jax.tree.map(np.asarray, jp),
                                     _tiny(**kw), tokens) if o is not None]
        assert msgs and all("causal" in m for m in msgs), msgs
    _, jp = _jax_tree(_tiny(), 0)
    msgs = [o for o in ranks.run(R.sp_loss, {"ctx": 4}, jax.tree.map(np.asarray, jp),
                                 _tiny(), np.zeros((1, 34), np.int32)) if o]
    assert msgs and all("must divide" in m for m in msgs), msgs
    msgs = [o for o in ranks.run(R.sp_loss, {"ctx": 4}, jax.tree.map(np.asarray, jp),
                                 _tiny(layer_pattern=(True, False), sliding_window=8),
                                 tokens) if o]
    assert msgs and all("uniform layer stack" in m for m in msgs), msgs
