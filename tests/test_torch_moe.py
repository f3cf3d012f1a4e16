"""The port's mixture-of-experts slice (mfa_tpu_torch/models/llama.py's
_moe_route / _moe / _mlp, models/wquant.py's expert banks and the plain
version of kernel 10's expert launch, kernels/wmatmul.int8_bank_matmul)
against mfa_tpu on the CPU, from the same numpy-seeded weights.

Tolerances: fp32 throughout, 1e-4 (two fp32 contractions and the port's
other summation order: the dense form sums over every expert with zero
weights, the grouped form sums a token's experts in slot order); int8
banks byte-equal to JAX's quantization; greedy tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.models import wquant as jw
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.kernels import wmatmul
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.models import wquant as tw
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
            n_experts=4, n_active_experts=2)
CONFIGS = {
    "mixtral": dict(BASE),
    # expert width of its own, full-softmax weights, per-head q/k norms
    "qwen3_moe": dict(BASE, moe_ffn_dim=48, norm_topk=False, qk_norm=True),
    # a shared expert and its sigmoid gate, q/k/v biases
    "qwen2_moe": dict(BASE, moe_ffn_dim=48, norm_topk=False, shared_expert_dim=80,
                      shared_expert_gate=True, qkv_bias=True),
    # dense layers mixed in: {"moe", "dense"} stacks in JAX
    "hetero": dict(BASE, n_layers=4, moe_ffn_dim=48,
                   moe_layer_pattern=(True, False, False, True)),
}
KW = dict(num_pages=40, page_size=8, max_seqs=2, pages_per_seq=12)


def _noisy(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _model(name, quant=False, seed=0):
    """-> (jcfg, tcfg, JAX params, the port's params): the same fp32 weights
    (int8 banks and projections by JAX's quantize_params(include_experts=True)
    under quant; the embedding stays fp32, since a quantized table's rows
    come out in bf16 and would turn every activation bf16)."""
    kw = CONFIGS[name]
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    tree = jax.tree.map(jnp.asarray, _noisy(jl.init_params(jax.random.key(seed), jcfg), 1))
    if quant:
        tree = jw.quantize_params(tree, include_embed=False, include_experts=True)
    host = jax.tree.map(np.asarray, tree)
    return jcfg, tcfg, tree, tl.params_from_numpy(host, tcfg, "cpu")


def _jax_layer(jcfg, jp, i):
    """Layer i's params of mfa_tpu's tree (its hetero stacks by the pattern)."""
    layers = jp["layers"]
    if jcfg.moe_hetero:
        pat = jcfg.moe_layer_pattern
        kind = "moe" if pat[i] else "dense"
        layers, i = layers[kind], sum(1 for f in pat[:i] if f == pat[i])
    return jax.tree.map(lambda a: a[i], layers)


def _x(seed, t, dim=64):
    return (np.random.RandomState(seed).standard_normal((1, t, dim)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_route_matches_jax(norm_topk):
    rng = np.random.RandomState(3)
    t = rng.standard_normal((50, 64)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    jw_top, jidx = jl._moe_route(jnp.asarray(t), jnp.asarray(w), 2, norm_topk)
    tw_top, tidx = tl._moe_route(torch.from_numpy(t), torch.from_numpy(w), 2, norm_topk)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw_top.numpy(), np.asarray(jw_top), atol=1e-6)
    assert np.allclose(tw_top.sum(-1).numpy(), 1.0) == norm_topk


def test_quantized_bank_matches_jax():
    w = (np.random.RandomState(4).standard_normal((3, 48, 32)) * 0.2).astype(np.float32)
    w[1, :, 5] = 0.0  # a zero column of one expert: scale 1
    got = tw.quantize_weight(torch.from_numpy(w), axis=-2)
    want = jw.quantize_weight(jnp.asarray(w), axis=-2)
    assert got.qw.shape == (3, 48, 32) and got.scale.shape == (3, 32)
    np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want.qw))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), atol=1e-7, rtol=0)


@pytest.mark.parametrize("form,t", [("dense", 32), ("dense", 96), ("grouped", 32),
                                    ("grouped", 96)])
def test_int8_bank_forms_match_jax(form, t, monkeypatch):
    """Each form of the port on the include_experts bank against JAX's two
    routes of the same bank: _moe_dense_int8 at T <= 64, the ragged _moe
    (dequantized at entry) above (tests/test_wquant.py:213)."""
    jcfg, tcfg, jp, tp = _model("mixtral", quant=True)
    x = _x(5, t)
    want = jl._mlp(jnp.asarray(x), _jax_layer(jcfg, jp, 0), jcfg)
    used = []
    for name in ("_moe_dense", "_moe_grouped"):
        monkeypatch.setattr(tl, name, (lambda f, n: lambda *a: used.append(n) or f(*a))(
            getattr(tl, name), name))
    if form == "grouped":
        monkeypatch.setattr(tl, "_MOE_DENSE_MAX_T", 0)
    got = tl._moe(torch.from_numpy(x), tp["layers"][0], tcfg, dense=form == "dense")
    assert used == [f"_moe_{form}"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [20, 150])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mlp_matches_jax(name, t):
    """_mlp of every layer (dense layers of the hetero model included): at 20
    rows the dense form, at 150 the grouped one; fp32 banks."""
    jcfg, tcfg, jp, tp = _model(name)
    x = _x(6, t)
    for i in range(tcfg.n_layers):
        assert ("we_gate" in tp["layers"][i]) == tcfg.is_moe_layer(i)
        want = jl._mlp(jnp.asarray(x), _jax_layer(jcfg, jp, i), jcfg)
        got = tl._mlp(torch.from_numpy(x), tp["layers"][i], tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"layer {i}",
                                   **TOL)


@pytest.mark.parametrize("name,quant", [("qwen2_moe", True), ("hetero", False)])
def test_params_from_numpy_layouts(name, quant):
    """JAX's uniform stack and its {"moe", "dense"} stacks -> the port's list
    of per-layer dicts in layer order, each layer with its kind's keys."""
    jcfg, tcfg, jp, tp = _model(name, quant)
    for i, lp in enumerate(tp["layers"]):
        jlp = _jax_layer(jcfg, jp, i)
        assert set(lp) == set(jlp) == set(tl._layer_keys(tcfg, tcfg.is_moe_layer(i)))
        for key, v in lp.items():
            if isinstance(v, tw.QWeight):
                np.testing.assert_array_equal(v.qw.numpy(), np.asarray(jlp[key].qw))
                np.testing.assert_array_equal(v.scale.numpy(), np.asarray(jlp[key].scale))
            else:
                np.testing.assert_array_equal(v.numpy(), np.asarray(jlp[key]), err_msg=key)
    if quant:  # the router and the [d, 1] shared gate stay in full precision
        lp = tp["layers"][0]
        assert isinstance(lp["we_down"], tw.QWeight) and lp["we_down"].qw.shape == (4, 48, 64)
        assert lp["w_router"].dtype == torch.float32
        assert not isinstance(lp["w_shared_gate"], tw.QWeight)


def test_init_params_quantizes_banks_as_quantize_params():
    """init_params(quantize="int8") quantizes each bank one expert at a time
    and gives the weights quantize_params(include_experts=True) gives for
    the bf16 init of the same seed; router and shared gate stay put."""
    from mfa_tpu_torch.utils.checkpoint import _flatten

    cfg = tl.LlamaConfig(dtype=torch.bfloat16, **CONFIGS["qwen2_moe"])
    q = tl.init_params(cfg, seed=2, device="cpu", quantize="int8")
    want = tw.quantize_params(tl.init_params(cfg, seed=2, device="cpu"),
                              include_experts=True)
    got, ref = _flatten(q), _flatten(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    lp = q["layers"][0]
    assert lp["we_gate"].qw.shape == (4, 64, 48) and lp["we_gate"].scale.shape == (4, 48)
    assert lp["w_router"].dtype == torch.float32
    assert lp["w_shared_gate"].dtype == torch.bfloat16


def test_bank_entry_points_plain():
    """kernels/wmatmul.int8_bank_matmul's plain version and wquant's bank
    forms against per-expert products: dense with shared and per-expert x,
    grouped with an empty group and a one-row group; ragged_qmm from group
    sizes; shapes the launch refuses."""
    rng = np.random.RandomState(7)
    E, K, N, T = 4, 48, 32, 9
    w = tw.quantize_weight(torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32)))
    deq = [w.qw[e].float() * w.scale[e] for e in range(E)]
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    xe = torch.from_numpy(rng.standard_normal((E, T, K)).astype(np.float32))
    for got, want in ((tw.bank_dense(x, w), [x @ d for d in deq]),
                      (tw.bank_dense(xe, w), [xe[e] @ deq[e] for e in range(E)])):
        assert got.shape == (E, T, N)
        for e in range(E):
            torch.testing.assert_close(got[e], want[e], atol=1e-5, rtol=1e-5)
    sizes = torch.tensor([3, 0, 1, 5])  # expert 1 empty, expert 2 one row
    offs = torch.tensor([0, 3, 3, 4, 9], dtype=torch.int32)
    got = tw.bank_grouped(x, w, offs, max_rows=5)
    want = torch.cat([x[int(offs[e]):int(offs[e + 1])] @ deq[e] for e in range(E)])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tw.ragged_qmm(x, w, sizes), got, atol=0, rtol=0)
    # a float bank: one matmul an expert
    wf = torch.stack(deq)
    torch.testing.assert_close(tw.bank_grouped(x, wf, offs, 5), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tw.bank_dense(x, wf), torch.stack([x @ d for d in deq]),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        wmatmul.int8_bank_matmul(x, w.qw, w.scale[:, :8])
    with pytest.raises(ValueError):
        wmatmul.int8_bank_matmul(xe[:2], w.qw, w.scale)
    with pytest.raises(ValueError):
        wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs[:3])


def test_graphed_steps_take_the_dense_form(monkeypatch):
    """verify_step (decode and burst steps are verify spans of one) takes the
    dense form at any row count, so it reads nothing on the host; a prefill
    of more than _MOE_DENSE_MAX_T rows takes the grouped form."""
    jcfg, tcfg, jp, tp = _model("mixtral")
    used = []
    for name in ("_moe_dense", "_moe_grouped"):
        monkeypatch.setattr(tl, name, (lambda f, n: lambda *a: used.append(n) or f(*a))(
            getattr(tl, name), name))
    cache = tl.build_kv_caches(tcfg, 40, 8, 2, 12, "int8", device="cpu")
    prompts = [list(range(1, 60)), list(range(3, 40))]
    cache, logits = tl.prefill_batch(tp, tcfg, cache, [0, 1], [list(range(1, 13)),
                                                              list(range(13, 25))], prompts)
    assert used == ["_moe_grouped"] * 2
    used.clear()
    span = np.arange(2 * 40).reshape(2, 40) % 90  # 80 rows
    tl.verify_step(tp, tcfg, cache, [0, 1], span)
    assert used == ["_moe_dense"] * 2


@pytest.mark.parametrize("name,quant", [("mixtral", True), ("qwen2_moe", False)])
def test_engine_matches_jax(name, quant):
    """A tiny MoE Engine gives mfa_tpu's greedy tokens: a wave of 59 + 37
    tokens (grouped form: 128 padded rows), then decode steps (dense form)."""
    jcfg, tcfg, jp, tp = _model(name, quant)
    rng = np.random.RandomState(8)
    prompts = [[int(t) for t in rng.randint(0, 96, n)] for n in (59, 37)]
    jeng = JaxEngine(jp, jcfg, **KW)
    jr = [jeng.submit(p, 5) for p in prompts]
    jeng.run()
    eng = Engine(tp, tcfg, device="cpu", **KW)
    tr = [eng.submit(p, 5) for p in prompts]
    eng.run()
    for t, j in zip(tr, jr):
        assert t.generated == j.generated, (name, t.generated, j.generated)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-3)


def test_sgd_train_steps_match_jax():
    """Two SGD steps on 2 x 40 tokens (80 rows: the grouped form, whose
    gradients reach the router, the banks and the shared expert) against
    mfa_tpu's train_step."""
    jcfg, tcfg, jp, tp = _model("qwen2_moe")
    toks = np.random.RandomState(10).randint(0, 96, (2, 41)).astype(np.int32)
    for _ in range(2):
        jp, jloss = jl.train_step(jp, jnp.asarray(toks), jcfg, lr=0.1)
        tp, tloss = tl.train_step(tp, toks, tcfg, lr=0.1)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for i, lp in enumerate(tp["layers"]):
        for key, t in lp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp["layers"][key][i]),
                                       err_msg=f"layer {i} {key}", **TOL)
    assert tp["layers"][0]["w_router"].grad is not None


def test_mixtral_preset_is_the_published_config():
    cfg = tl.LlamaConfig.mixtral_8x7b()
    assert (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
            cfg.n_experts, cfg.n_active_experts, cfg.vocab_size, cfg.rope_theta,
            cfg.sliding_window) == (32, 4096, 32, 8, 128, 14336, 8, 2, 32000, 1e6, None)
    assert not cfg.moe_hetero and all(cfg.is_moe_layer(i) for i in range(32))
    # the int8 banks alone: 32 layers x 3 x 8 x 4096 x 14336 bytes
    assert 32 * 3 * 8 * 4096 * 14336 == 45_097_156_608
    assert dataclasses.replace(cfg, moe_layer_pattern=(True, False) * 16).moe_hetero
