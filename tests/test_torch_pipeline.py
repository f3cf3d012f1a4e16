"""The port's pipeline parallelism (mfa_tpu_torch/shard/pipeline.py: a GPipe
schedule of send / recv between stage ranks) against mfa_tpu's
(tests/test_pipeline.py, case by case): the loss equals mfa_tpu's loss_fn,
and the gradients and an SGD step equal the unsharded ones, which
mfa_tpu's own test holds its pipelined loss and gradients to.

The port runs in 4 gloo ranks on the CPU, spawned once for this file
(tests/torch_rank_fns.py holds their functions, free of JAX); the same
numpy weights from a seed go to both sides. Tolerance: fp32, 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfa_tpu.models import llama as jl
from mfa_tpu_torch.shard.launch import Ranks
from tests import torch_rank_fns as R
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(vocab=64, dim=64, layers=4, heads=4, kv_heads=2, ffn=128)
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, **KW)
PIPE = "pipe"


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, device="cpu", threads=1, timeout_s=300) as r:
        yield r


@pytest.fixture(scope="module")
def setup():
    params = jl.init_params(jax.random.key(0), JCFG)
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (8, 24), 0,
                                           JCFG.vocab_size), np.int32)
    loss, grads = jax.value_and_grad(jl.loss_fn)(params, jnp.asarray(tokens), JCFG)
    return params, tokens, float(loss), grads


def _losses(outs):
    return [o for o in outs if o is not None]


def test_pipeline_loss_matches_unsharded(ranks, setup):
    params, tokens, want, _ = setup
    for n_micro in (4, 8):  # 8: more microbatches than stages
        got = _losses(ranks.run(R.pipeline, {PIPE: 4}, R.plain(params), KW,
                                tokens, n_micro, "loss"))
        assert len(got) == 4
        np.testing.assert_allclose(got, [want] * 4, **TOL)


def test_pipeline_sliding_window_matches_unsharded(ranks):
    kw = dict(KW, sliding_window=8)
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    params = jl.init_params(jax.random.key(2), cfg)
    tokens = np.asarray(jax.random.randint(jax.random.key(3), (4, 24), 0,
                                           cfg.vocab_size), np.int32)
    want = float(jl.loss_fn(params, jnp.asarray(tokens), cfg))
    got = _losses(ranks.run(R.pipeline, {PIPE: 4}, R.plain(params), kw, tokens,
                            4, "loss"))
    np.testing.assert_allclose(got, [want] * 4, **TOL)


def test_pipeline_grads_match_unsharded(ranks, setup):
    """The backward schedule: each stage's layers' gradients, and the
    embedding's and head's summed over "pipe" on every rank."""
    params, tokens, want, g_want = setup
    outs = _losses(ranks.run(R.pipeline, {PIPE: 4}, R.plain(params), KW, tokens,
                             4, "grad"))
    seen = set()
    for loss, grads in outs:
        np.testing.assert_allclose(loss, want, **TOL)
        for i, lg in grads["layers"].items():
            seen.add(i)
            for k, g in lg.items():
                np.testing.assert_allclose(g, np.asarray(g_want["layers"][k][i]),
                                           err_msg=f"layer {i} {k}", **TOL)
        for k in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(grads[k], np.asarray(g_want[k]),
                                       err_msg=k, **TOL)
    assert seen == set(range(JCFG.n_layers))  # each stage its own layer


def test_pipeline_rank_holds_only_its_stage(ranks, setup):
    """params_from_numpy(mesh=) under "pipe" keeps a rank's own layers only
    (stage p of 4 holds layer p); the schedule refuses a whole tree, and
    the unpipelined forward a stage's tree."""
    params, tokens, _, _ = setup
    outs = _losses(ranks.run(R.pipeline, {PIPE: 4}, R.plain(params), KW, tokens,
                             4, "held"))
    assert [o[0] for o in outs] == [[0], [1], [2], [3]]
    wq = np.asarray(params["layers"]["wq"]).shape[1:]
    for held, shapes, (whole, stage) in outs:
        assert shapes == [wq]
        assert "params hold 4 layers, the stage 1" in whole
        assert "params hold 1 of 4 layers" in stage


def test_pipeline_train_step(ranks, setup):
    """One SGD step at pipe 2: the loss, and every updated weight equal to
    the unsharded step's (p - lr * g); mfa_tpu's test checks that its
    params moved."""
    params, tokens, want, g_want = setup
    lr = 1e-3
    outs = _losses(ranks.run(R.pipeline, {PIPE: 2}, R.plain(params), KW, tokens,
                             4, "step", lr))
    assert len(outs) == 2
    for loss, new in outs:
        np.testing.assert_allclose(loss, want, **TOL)
        for i, lp in new["layers"].items():
            for k, w in lp.items():
                old = np.asarray(params["layers"][k][i])
                np.testing.assert_allclose(
                    w, old - lr * np.asarray(g_want["layers"][k][i]), **TOL)
                assert np.abs(w - old).max() > 0
        for k in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(
                new[k], np.asarray(params[k]) - lr * np.asarray(g_want[k]), **TOL)


def test_pipeline_rejects_bad_shapes(ranks, setup):
    params, tokens, _, _ = setup
    msgs = _losses(ranks.run(R.pipeline, {PIPE: 3}, R.plain(params), KW, tokens,
                             4, "loss"))  # 4 layers / 3 stages
    assert len(msgs) == 3 and all("must divide into 3 stages" in m for m in msgs)
    msgs = _losses(ranks.run(R.pipeline, {PIPE: 4}, R.plain(params), KW, tokens,
                             3, "loss"))  # batch 8 % 3 != 0
    assert len(msgs) == 4 and all("microbatches" in m for m in msgs)
    msgs = _losses(ranks.run(R.pipeline, {PIPE: 2}, R.plain(params),
                             dict(KW, layer_pattern=(True, False), sliding_window=8),
                             tokens, 4, "loss"))
    assert len(msgs) == 2 and all("uniform layer stack" in m for m in msgs)
