"""The port's SigLIP tower and Gemma3 multimodal glue (models/vision.py)
against mfa_tpu.models.vision on a tiny tower (hidden 64, 2 layers, 4
heads, 28-pixel images in 7-pixel patches, 4 soft tokens an image), the
JAX weights perturbed with numpy noise and carried over: features within
1e-4 in fp32. Then multimodal_forward on a tiny Gemma3 text stack (q/k
norms, post norms, (1 + w) norms, scaled embeddings, head_dim 32 != dim /
heads, pattern sliding, sliding, global over 3 layers with window 16 and
a dual rotary): logits within 1e-3, through kernel 9's plain version and
mfa_tpu's Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.models import vision as jv
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.models import vision as tv
from tests.jax_maps import release_jax_code  # noqa: F401

IMG = 100
JV = jv.SiglipVisionConfig(hidden=64, intermediate=128, n_layers=2, n_heads=4,
                           image_size=28, patch_size=7, mm_tokens_per_image=4)
TV = tv.SiglipVisionConfig(hidden=64, intermediate=128, n_layers=2, n_heads=4,
                           image_size=28, patch_size=7, mm_tokens_per_image=4)
GEMMA = dict(vocab_size=128, dim=64, n_layers=3, n_heads=4, n_kv_heads=2,
             ffn_dim=128, rope_theta=1e6, norm_eps=1e-6, sliding_window=16,
             head_dim_override=32, hidden_act="gelu_tanh", norm_offset=True,
             embed_scale=True, query_scale=16.0 ** -0.5, post_norms=True,
             qk_norm=True, layer_pattern=(True, True, False),
             rope_theta_local=1e4, rope_scale=8.0)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **GEMMA)
TCFG = tl.LlamaConfig(dtype=torch.float32, **GEMMA)


def _noisy(tree, seed):
    """numpy copy of a params pytree with noise on every leaf, so zero
    biases and identity norms take part in the comparison."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32),
                        tree)


@pytest.fixture(scope="module")
def weights():
    vtree = _noisy(jv.init_vision_params(jax.random.key(0), JV, JCFG.dim), 1)
    ttree = _noisy(jl.init_params(jax.random.key(2), JCFG), 3)
    return (jax.tree.map(jnp.asarray, vtree), tv.vision_params_from_numpy(vtree, TV, "cpu"),
            jax.tree.map(jnp.asarray, ttree), tl.params_from_numpy(ttree, TCFG, "cpu"))


def _pixels(n, seed=4):
    return np.random.RandomState(seed).standard_normal((n, 3, 28, 28)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_tower_and_projector_match_jax(weights):
    jvp, tvp, _, _ = weights
    px = _pixels(3)
    j_out = jv.siglip_encode(jvp, jnp.asarray(px), JV)
    t_out = tv.siglip_encode(tvp, torch.from_numpy(px), TV)
    assert t_out.shape == (3, TV.num_patches, TV.hidden)
    _close(t_out, j_out, 1e-4)
    j_feat = jv.project_image_features(jvp, j_out, JV)
    t_feat = tv.project_image_features(tvp, torch.from_numpy(np.array(j_out)), TV)
    assert t_feat.shape == (3, 4, TCFG.dim)
    _close(t_feat, j_feat, 1e-4)
    _close(tv.gemma3_image_features(tvp, torch.from_numpy(px), TV),
           jv.gemma3_image_features(jvp, jnp.asarray(px), JV), 1e-4)


def test_merge_and_run_ids_match_jax():
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 90, (2, 20)).astype(np.int32)
    toks[0, 2:6] = IMG
    toks[0, 9:13] = IMG  # two runs in one row
    toks[1, 15:19] = IMG
    emb = rng.standard_normal((2, 20, 64)).astype(np.float32)
    feats = rng.standard_normal((3, 4, 64)).astype(np.float32)
    want = jv.merge_image_embeds(jnp.asarray(emb), jnp.asarray(toks),
                                 jnp.asarray(feats), IMG)
    got = tv.merge_image_embeds(torch.from_numpy(emb), torch.from_numpy(toks),
                                torch.from_numpy(feats), IMG)
    _close(got, want, 0.0)
    tt, jt = torch.from_numpy(toks), jnp.asarray(toks)
    np.testing.assert_array_equal(tv.image_block_ids_from_tokens(tt, IMG).numpy(),
                                  np.asarray(jv.image_block_ids_from_tokens(jt, IMG)))
    np.testing.assert_array_equal(tv.image_bidir_mask(tt, IMG).numpy(),
                                  np.asarray(jv.image_bidir_mask(jt, IMG)))


def test_multimodal_forward_matches_jax(weights):
    jvp, tvp, jp, tp = weights
    rng = np.random.RandomState(6)
    # row 0: one image after 20 text tokens (past the 16-token window);
    # row 1: two images, the second right before the end
    toks = rng.randint(0, 90, (2, 34)).astype(np.int32)
    toks[0, 20:24] = IMG
    toks[1, 3:7] = IMG
    toks[1, 28:32] = IMG
    px = _pixels(3, 7)
    want = jv.multimodal_forward(jp, jvp, jnp.asarray(toks), jnp.asarray(px), JCFG,
                                 JV, IMG)
    got = tv.multimodal_forward(tp, tvp, torch.from_numpy(toks).long(),
                                torch.from_numpy(px), TCFG, TV, IMG)
    assert got.shape == (2, 34, 128) and got.dtype == torch.float32
    _close(got, want, 1e-3)
    greedy = tv.multimodal_generate_greedy(tp, tvp, torch.from_numpy(toks[:1]).long(),
                                           torch.from_numpy(px[:1]), TCFG, TV, IMG, 3)
    assert greedy[0] == int(np.asarray(want)[0, -1].argmax())
