"""The port's int8 weights (mfa_tpu_torch/models/wquant.py and the plain
version of kernels/wmatmul.py on the CPU) against mfa_tpu's wquant and
int8_matmul (Pallas interpret mode). Mirrors tests/test_wquant.py.

Tolerances: quantization byte-equal (the same fp32 scale rule and
round-half-even), scales equal; fp32 products 1e-5 relative (two
fp32 contractions, summation order only); the fp32 quantized forward 1e-3
on logits, as the port's other model tests; bf16 products 2e-2 of the
output's max, as the JAX kernel test (one bf16 rounding against two)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.wmatmul import int8_matmul as jax_int8_matmul
from mfa_tpu.models import llama as jl
from mfa_tpu.models import wquant as jw
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.kernels import wmatmul
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.models import wquant as tw
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)


def _w(seed, *shape, std=0.3):
    return (np.random.RandomState(seed).standard_normal(shape) * std).astype(np.float32)


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_matches_jax(axis):
    w = _w(0, 96, 48)
    w[:, 5] = 0.0  # a zero column: scale 1, payload 0
    w[7, :] = 0.0  # a zero row
    w[3, 3] = 127.5 * 0.01  # ties round half to even
    got = tw.quantize_weight(torch.from_numpy(w), axis=axis)
    want = jw.quantize_weight(jnp.asarray(w), axis=axis)
    assert got.qw.dtype == torch.int8 and got.axis == want.axis
    np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want.qw))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    deq = tw.dequantize_weight(got, torch.float32).numpy()
    np.testing.assert_allclose(deq, np.asarray(jw.dequantize_weight(want, jnp.float32)),
                               rtol=1e-6, atol=0)
    # symmetric absmax: error <= scale / 2 per entry
    amax = np.abs(w).max(axis=axis, keepdims=True)
    assert np.all(np.abs(deq - w) <= amax / 127.0 * 0.5 + 1e-7)


def test_quantize_weight_in_slices_is_the_same(monkeypatch):
    # a large 2-D tensor quantizes in slices along the axis it keeps
    w = torch.from_numpy(_w(1, 64, 40))
    whole = tw.quantize_weight(w, axis=-2)
    calls = []
    orig = tw._quantize_body

    def spy(piece, axis):
        calls.append(piece.shape)
        return orig(piece, axis)

    monkeypatch.setattr(tw, "_quantize_body", spy)
    monkeypatch.setattr(tw.torch.Tensor, "numel", lambda self: 10 ** 9)
    sliced = tw.quantize_weight(w, axis=-2)
    assert len(calls) > 1
    assert torch.equal(sliced.qw, whole.qw) and torch.equal(sliced.scale, whole.scale)


def test_qmm_scale_commutes():
    x = torch.from_numpy(_w(2, 4, 64, std=1.0))
    w = torch.from_numpy(_w(3, 64, 32, std=1.0))
    qw = tw.quantize_weight(w)
    ref = x @ tw.dequantize_weight(qw, torch.float32)
    torch.testing.assert_close(tw.qmm(x, qw), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tw.qmm(x, w), x @ w, rtol=1e-6, atol=0)
    x3 = x.reshape(2, 2, 64)  # leading dims flatten through the kernel's 2-D entry
    torch.testing.assert_close(tw.qmm(x3, qw), ref.reshape(2, 2, 32))


def test_qtake_rows():
    w = _w(4, 96, 64, std=1.0)
    got = tw.qtake(tw.quantize_weight(torch.from_numpy(w), axis=-1),
                   torch.tensor([[0, 5], [95, 7]]))
    want = jw.qtake(jw.quantize_weight(jnp.asarray(w), axis=-1),
                    jnp.asarray([[0, 5], [95, 7]]))
    assert got.dtype == torch.bfloat16  # whatever the table's dtype, as in JAX
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("m,K,N", [(3, 256, 384), (16, 512, 1152), (130, 384, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_jax(m, K, N, dtype):
    x = _w(m, m, K, std=1.0)
    qw = jw.quantize_weight(jnp.asarray(_w(m + 1, K, N, std=1.0)))
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_int8_matmul(jx, qw.qw, qw.scale), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = wmatmul.int8_matmul(tx, torch.from_numpy(np.array(qw.qw)),
                              torch.from_numpy(np.array(qw.scale)))
    assert got.dtype == tx.dtype and got.shape == (m, N)
    d = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert d < (1e-5 if dtype == "float32" else 2e-2), d


def test_split_k_fills_the_card():
    # decode-sized m: N / 128 tiles cannot fill 132 SMs, so K is split, over
    # at most one cluster (8 blocks) a tile and no more blocks than the SMs
    # (one block an SM); w_gate's 112 tiles need no split, nor do a prefill
    # wave's
    for K, N, want in ((4096, 1024, 8), (4096, 4096, 4), (14336, 4096, 4),
                       (4096, 14336, 1)):
        splits, per = wmatmul.split_k(16, K, N)
        tiles = N // 128
        assert splits == want and (splits - 1) * per < K // 64 <= splits * per
        assert tiles * splits <= 132
    assert wmatmul.split_k(16, 4096, 128256) == (1, 64)
    assert wmatmul.split_k(3601, 4096, 14336) == (1, 64)
    # rows a block follow m: wgmma's n side is 16, 32, 64, 128 or 256
    assert [wmatmul.block_m(m) for m in (1, 16, 17, 33, 64, 65, 255, 256, 3601)] == \
        [16, 16, 32, 64, 64, 128, 128, 256, 256]
    # two output tiles of m 255 split twice, one tile of m 256 eight times
    assert wmatmul.split_k(255, 14336, 4096) == (2, 112)
    assert wmatmul.split_k(256, 4096, 128) == (8, 8)


@pytest.fixture(scope="module")
def qparams():
    jp = jw.quantize_params(jl.init_params(jax.random.key(0), JCFG))
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def test_params_from_numpy_of_a_quantized_tree(qparams):
    jp, tp = qparams
    for i in range(TCFG.n_layers):
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            got, want = tp["layers"][i][k], jp["layers"][k]
            assert isinstance(got, tw.QWeight) and got.axis == -2
            np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want.qw)[i])
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale)[i])
        assert tp["layers"][i]["attn_norm"].dtype == torch.float32
    assert tp["embed"].axis == -1 and tp["lm_head"].axis == -2
    np.testing.assert_array_equal(tp["lm_head"].qw.numpy(), np.asarray(jp["lm_head"].qw))


@pytest.mark.parametrize("include_embed", [False, True])
def test_forward_parity_quantized(include_embed):
    jp = jl.init_params(jax.random.key(1), JCFG)
    jq = jw.quantize_params(jp, include_embed=include_embed)
    tq = tl.params_from_numpy(jax.tree.map(np.asarray, jq), TCFG, "cpu")
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    assert tw.params_nbytes(tq) < 0.62 * tw.params_nbytes(tp)
    toks = np.random.RandomState(2).randint(0, 64, (2, 24))
    want = np.asarray(jl.forward(jq, jnp.asarray(toks), JCFG))
    got = tl.forward(tq, torch.from_numpy(toks), TCFG).numpy()
    # with the table quantized, qtake returns bf16 rows and the whole model
    # runs in bf16 on both sides (mfa_tpu's qtake): bf16 rounding order
    tol = 5e-2 if include_embed else 1e-3
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_init_params_quantizes_each_layer_as_built():
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    q = tl.init_params(cfg, seed=5, device="cpu", quantize="int8")
    ref = tw.quantize_params(tl.init_params(cfg, seed=5, device="cpu"))
    for a, b in ((q["layers"][1]["w_down"], ref["layers"][1]["w_down"]),
                 (q["embed"], ref["embed"]), (q["lm_head"], ref["lm_head"])):
        assert isinstance(a, tw.QWeight) and a.axis == b.axis
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scale, b.scale)
    assert q["layers"][0]["attn_norm"].dtype == torch.float32
    with pytest.raises(ValueError):
        tl.init_params(cfg, device="cpu", quantize="int4")


def test_engine_serves_quantized_params(qparams):
    # greedy tokens: the port's Engine == mfa_tpu's Engine == the port's
    # full-forward rollout, on the same int8 weights
    jp, tp = qparams
    kw = dict(num_pages=32, page_size=8, max_seqs=4, pages_per_seq=8,
              quant_dtype="int8")
    prompt = [3, 11, 7, 2, 9]
    jeng = JaxEngine(jp, JCFG, **kw)
    jreq = jeng.submit(prompt, max_new_tokens=6)
    jeng.run()
    eng = Engine(tp, TCFG, device="cpu", **kw)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    assert req.generated == jreq.generated
    toks = list(prompt)
    for _ in range(6):
        logits = tl.forward(tp, torch.tensor([toks]), TCFG)
        toks.append(int(logits[0, -1].argmax()))
    assert req.generated == toks[len(prompt):]
    assert eng.sched.allocator.free_pages == 31


def test_train_step_refuses_qweights(qparams):
    _, tp = qparams
    toks = np.random.RandomState(3).randint(0, 64, (1, 9))
    with pytest.raises(NotImplementedError, match="QWeight"):
        tl.train_step(tp, toks, TCFG)
    with pytest.raises(NotImplementedError, match="QWeight"):
        tl.loss_fn(tp, torch.from_numpy(toks), TCFG)
