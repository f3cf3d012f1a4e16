"""The port's training path (models/llama.forward, loss_fn, train_step on
the plain kernels) against mfa_tpu's on a tiny fp32 Llama (the config of
tests/test_model.py), the JAX weights carried over by params_from_numpy:
logits, loss, and every updated weight after SGD and AdamW steps agree to
atol = rtol = 1e-4 (loss to 1e-4 as well)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu_torch.models import llama as tl
from tests.jax_maps import release_jax_code  # noqa: F401

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=128, dtype=torch.float32)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.key(0), JCFG)


def _port(jp):
    """Fresh port weights (train_step updates them in place)."""
    return tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 64, shape).astype(np.int32)


def _assert_params_close(tp, jp):
    for i, lp in enumerate(tp["layers"]):
        for name, t in lp.items():
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(jp["layers"][name][i]),
                err_msg=f"layer {i} {name}", **TOL)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(tp[name].detach().numpy(),
                                   np.asarray(jp[name]), err_msg=name, **TOL)


def test_forward_and_loss_match_jax(jparams):
    tp = _port(jparams)
    toks = _tokens(1, (2, 17))
    want = jl.forward(jparams, jnp.asarray(toks[:, :-1]), JCFG)
    got = tl.forward(tp, torch.from_numpy(toks[:, :-1]).long(), TCFG)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_loss = jl.loss_fn(jparams, jnp.asarray(toks), JCFG)
    got_loss = tl.loss_fn(tp, torch.from_numpy(toks).long(), TCFG)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


def test_unported_forward_inputs_raise(jparams):
    """input_embeds and image_block_ids (Gemma3 vision) are ported: an
    all-text run-id map over the embedded tokens is the causal forward, and
    an id map of the wrong shape raises."""
    tp = _port(jparams)
    toks = torch.from_numpy(_tokens(6, (1, 9))).long()
    plain = tl.forward(tp, toks, TCFG)
    ids = torch.full((1, 9), -1, dtype=torch.int32)
    got = tl.forward(tp, toks, TCFG, input_embeds=tl._embed(tp, toks, TCFG),
                     image_block_ids=ids)
    np.testing.assert_allclose(got.detach().numpy(), plain.detach().numpy(),
                               **TOL)
    with pytest.raises(ValueError):
        tl.forward(tp, toks, TCFG, image_block_ids=torch.zeros(1, 4))


@pytest.mark.parametrize("steps", [1, 2])
def test_sgd_train_steps_match_jax(jparams, steps):
    tp, jp = _port(jparams), jparams
    toks = _tokens(2, (2, 24))
    for _ in range(steps):
        jp, jloss = jl.train_step(jp, jnp.asarray(toks), JCFG, lr=0.1)
        tp, tloss = tl.train_step(tp, toks, TCFG, lr=0.1)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_params_close(tp, jp)


def test_remat_matches_plain(jparams):
    """Checkpointed layers take the same loss and the same update."""
    toks = _tokens(3, (2, 24))
    p1, l1 = tl.train_step(_port(jparams), toks, TCFG)
    p2, l2 = tl.train_step(_port(jparams), toks, TCFG, remat=True)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(tl.param_tensors(p1), tl.param_tensors(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_adamw_matches_optax(jparams):
    hp = dict(b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01)
    tx = optax.adamw(3e-3, **hp)
    jp, state = jparams, tx.init(jparams)
    tp = _port(jparams)
    opt = torch.optim.AdamW(tl.param_tensors(tp), lr=3e-3,
                            betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                            weight_decay=hp["weight_decay"])
    toks = _tokens(4, (2, 24))
    for _ in range(3):
        jp, state, jloss = jl.train_step(jp, jnp.asarray(toks), JCFG,
                                         optimizer=tx, opt_state=state)
        tp, tloss = tl.train_step(tp, toks, TCFG, optimizer=opt)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_params_close(tp, jp)


def test_train_step_reduces_loss(jparams):
    tp = _port(jparams)
    toks = _tokens(5, (4, 32))
    losses = [float(tl.train_step(tp, toks, TCFG, lr=0.2)[1])
              for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
