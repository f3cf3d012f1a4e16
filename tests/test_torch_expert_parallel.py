"""The port's expert parallelism (mfa_tpu_torch/shard/expert.py, and
models/llama._moe under an "expert" axis) against mfa_tpu's
(tests/test_expert_parallel.py, case by case).

The port runs SPMD in 8 gloo ranks on the CPU, spawned once for this file
(tests/torch_rank_fns.py holds their functions, free of JAX); the JAX side
runs in this process on tests/conftest.py's 8-device mesh. The same numpy
weights from a seed go to both. Tolerances: fp32, 1e-4 (outputs, and
gradients relative to their largest entry as mfa_tpu's test holds its own);
int8 banks: the same payloads and scales on both sides, 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfa_tpu.models import llama as jl
from mfa_tpu.models import wquant as jw
from mfa_tpu.shard.expert import expert_parallel_moe, expert_parallel_moe_a2a
from mfa_tpu.shard.mesh import make_mesh
from mfa_tpu_torch.shard.launch import Ranks
from tests import torch_rank_fns as R
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(8, device="cpu", threads=1, timeout_s=300) as r:
        yield r


def _bank_inputs(seed, E, d, f, T):
    rng = np.random.RandomState(seed)
    t = rng.standard_normal((T, d)).astype(np.float32)
    w_router = (rng.standard_normal((d, E)) * 0.2).astype(np.float32)
    banks = [(rng.standard_normal(s) * 0.1).astype(np.float32)
             for s in ((E, d, f), (E, d, f), (E, f, d))]
    return t, w_router, banks


def _cfgs(E, k, norm_topk):
    jcfg = jl.LlamaConfig.tiny()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "n_experts": E, "n_active_experts": k,
                         "norm_topk": norm_topk})
    return jcfg, dict(n_experts=E, n_active_experts=k, norm_topk=norm_topk)


@pytest.mark.parametrize("T", [24, 96])  # the dense local form, the grouped one
@pytest.mark.parametrize("axes,norm_topk", [
    ({"expert": 4}, True),
    ({"expert": 8}, False),
    ({"expert": 4, "model": 2}, True),
])
def test_expert_parallel_matches_dense(ranks, axes, norm_topk, T):
    E, d, f, k = 8, 64, 96, 2
    t, w_router, banks = _bank_inputs(0, E, d, f, T)
    jcfg, kw = _cfgs(E, k, norm_topk)
    want = jax.jit(expert_parallel_moe(make_mesh(axes), jcfg))(t, w_router, *banks)
    outs = [o for o in ranks.run(R.ep_moe, axes, kw, t, w_router, *banks,
                                 False, None, False) if o is not None]
    assert len(outs) == int(np.prod(list(axes.values())))
    for _, got in outs:  # the combined output on every rank
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [16, 96])
def test_expert_parallel_int8_banks(ranks, T):
    """int8 banks (kernel 10's expert launch; its plain version here) on
    the local experts against mfa_tpu's unsharded _moe of the same bank
    (_moe_dense_int8 at T <= 64, the ragged path above)."""
    E, d, f = 8, 64, 96
    kw = dict(vocab=64, dim=d, layers=1, n_experts=E, n_active_experts=2,
              moe_ffn_dim=f)
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tree = jw.quantize_params(jl.init_params(jax.random.key(4), jcfg),
                              include_embed=False, include_experts=True)
    x = (np.random.RandomState(5).standard_normal((1, T, d)) * 0.5).astype(np.float32)
    want = jl._moe(jnp.asarray(x), jax.tree.map(lambda a: a[0], tree["layers"]), jcfg)
    outs = [o for o in ranks.run(R.moe_layer, {"expert": 4, "model": 2},
                                 R.plain(tree), kw, x) if o is not None]
    assert len(outs) == 8
    for got in outs:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_expert_parallel_matches_unsharded_moe(ranks):
    """EP through the model layer (_moe under an "expert" axis) == mfa_tpu's
    unsharded _moe, fp32 (mfa_tpu's test holds its EP _moe to it)."""
    E, d, f, T = 4, 64, 80, 12
    kw = dict(dim=d, layers=1, n_experts=E, n_active_experts=2, moe_ffn_dim=f)
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    jp = jl.init_params(jax.random.key(1), jcfg)
    x = np.asarray(jax.random.normal(jax.random.key(2), (2, T // 2, d), jnp.float32))
    want = jl._moe(jnp.asarray(x), jax.tree.map(lambda a: a[0], jp["layers"]), jcfg)
    outs = [o for o in ranks.run(R.moe_layer, {"expert": 4}, R.plain(jp), kw, x)
            if o is not None]
    assert len(outs) == 4
    for got in outs:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("axes,norm_topk", [
    ({"expert": 4}, True),
    ({"expert": 8}, False),
    ({"expert": 4, "model": 2}, True),
])
def test_expert_parallel_a2a_matches_dense(ranks, axes, norm_topk):
    """Tokens on the expert axis, all_to_all dispatch and combine, the
    worst-case-skew capacity (every local assignment to one rank)."""
    E, d, f, T, k = 8, 64, 96, 32, 2
    t, w_router, banks = _bank_inputs(3, E, d, f, T)
    jcfg, kw = _cfgs(E, k, norm_topk)
    cap = float(axes["expert"])
    want = jax.jit(expert_parallel_moe_a2a(make_mesh(axes), jcfg,
                                           capacity_factor=cap))(t, w_router, *banks)
    outs = ranks.run(R.ep_moe, axes, kw, t, w_router, *banks, True, cap, False)
    ep = axes["expert"]
    got = np.zeros_like(np.asarray(want))
    for o in outs:
        if o is not None:
            i, block = o
            got[i * (T // ep):(i + 1) * (T // ep)] = block
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_expert_parallel_a2a_drops_past_capacity(ranks):
    """A capacity of one slot a peer drops assignments as mfa_tpu does."""
    E, d, f, T, k = 8, 64, 96, 32, 2
    t, w_router, banks = _bank_inputs(6, E, d, f, T)
    jcfg, kw = _cfgs(E, k, True)
    axes = {"expert": 4}
    cap = 4 / (T // 4 * k)  # cap = 1 slot
    want = jax.jit(expert_parallel_moe_a2a(make_mesh(axes), jcfg,
                                           capacity_factor=cap))(t, w_router, *banks)
    outs = [o for o in ranks.run(R.ep_moe, axes, kw, t, w_router, *banks, True,
                                 cap, False) if o is not None]
    got = np.concatenate([b for _, b in sorted(outs, key=lambda o: o[0])])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (np.abs(got).sum(-1) == 0).any()  # some tokens lost every expert


def test_expert_parallel_a2a_differentiable(ranks):
    """The a2a path is the training path: the gradients of every rank's
    banks through dispatch, the grouped matmuls and the combine equal
    mfa_tpu's a2a gradients (ample capacity, fp32)."""
    E, d, f, T, k = 4, 32, 48, 16, 2
    t, w_router, banks = _bank_inputs(9, E, d, f, T)
    jcfg, kw = _cfgs(E, k, True)
    axes = {"expert": 4}
    fn = expert_parallel_moe_a2a(make_mesh(axes), jcfg, capacity_factor=4.0)
    g_want = jax.grad(lambda a, b, c: jnp.sum(fn(t, w_router, a, b, c) ** 2),
                      argnums=(0, 1, 2))(*banks)
    outs = [o for o in ranks.run(R.ep_a2a_grads, axes, kw, t, w_router, *banks, 4.0)
            if o is not None]
    e_local = E // axes["expert"]
    for i, grads in outs:
        for g, w, name in zip(grads, g_want, ("we_gate", "we_up", "we_down")):
            w = np.asarray(w)[i * e_local:(i + 1) * e_local]
            scale = max(1e-3, float(np.abs(w).max()))
            assert np.abs(g - w).max() / scale < 1e-4, name
