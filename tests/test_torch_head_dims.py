"""Every head_dim up to 256 in the port's attention (plain versions on the
CPU) against mfa_tpu's kernels in interpret mode, at d 32, 80, 96 and 100:
the entry points, the paged kernels on every page format, the image-block
prefill, the backward's three gradients and a tiny H2O-Danube-shaped model
(d 80, 4 q heads a kv head, a sliding window) through the Engine and one
train step. The head-dim plan (dispatch/config.py:head_dim_plan) is the
host-side arithmetic the CUDA wrappers run: its stored widths, and the
plain versions run through it (rows zero-padded to the stored width, the
true d's softmax scale, outputs sliced) equal to the plain versions at the
true width within 1e-6. Inputs from numpy with a seed, fp32, atol = rtol
= 1e-4 against JAX (the same function; only the summation order differs)
unless stated. The port's pages are at its stored width, JAX's at 128
lanes: they are compared after dequantization."""

import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu
import mfa_tpu_torch
from mfa_tpu.kernels.backward import flash_attention_bwd as jax_bwd
from mfa_tpu.kernels.blockmask import image_block_prefill as jax_image_block
from mfa_tpu.kernels.decode import decode_attention as jax_decode
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.prefill import prefill_attention as jax_prefill
from mfa_tpu.kernels.quant import pack_int4_pairs
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.cache.paged_cache import stored_rows
from mfa_tpu_torch.dispatch.config import (head_dim_plan, pad_features,
                                           unpad_features)
from mfa_tpu_torch.kernels import (backward, blockmask, decode, paged,
                                   paged_prefill, prefill, varlen, wmatmul)
from mfa_tpu_torch.kernels.paged_prefill import _paged_prefill_plain
from mfa_tpu_torch.kernels.quant import FP8, row_width, unpack_int4
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
DIMS = (32, 80, 96, 100)
FORMATS = (None, "int8", "fp8", "int4")


def _rn(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("d,fmt,kernel_dim,stored,width", [
    (80, None, 128, 80, 80),     # H2O-Danube: 160-byte bf16 rows, kept
    (80, "int8", 128, 80, 80),   # 80-byte rows, kept
    (80, "fp8", 128, 80, 80),
    (80, "int4", 128, 96, 48),   # 40-byte rows stored 48 bytes wide
    (100, None, 128, 104, 104),  # 200-byte rows -> 208
    (100, "int8", 128, 112, 112),
    (100, "int4", 128, 128, 64),
    (32, None, 64, 32, 32),
    (32, "int4", 64, 32, 16),
    (96, None, 128, 96, 96),
    (160, None, 256, 160, 160),
    (1, None, 64, 8, 8),
    (64, None, 64, 64, 64),
    (128, "int4", 128, 128, 64),
    (256, None, 256, 256, 256),
    (250, "int8", 256, 256, 256),
])
def test_plan_stored_widths(d, fmt, kernel_dim, stored, width):
    plan = head_dim_plan(d, fmt)
    assert (plan.kernel_dim, plan.stored, plan.padded) == (kernel_dim, stored,
                                                           stored != d)
    assert row_width(fmt, d) == width
    assert (width * (1 if fmt else 2)) % 16 == 0  # TMA's row stride rule


def test_head_dim_257_raises_value_error_in_both_packages():
    q = _rn(0, 1, 8, 2, 257)
    for api, wrap in ((mfa_tpu_torch, torch.from_numpy), (mfa_tpu, jnp.asarray)):
        with pytest.raises(ValueError, match="head_dim"):
            api.flash_attn_func(wrap(q), wrap(q), wrap(q))
    with pytest.raises(ValueError, match="head_dim"):
        head_dim_plan(257)
    with pytest.raises(ValueError, match="head_dim"):
        head_dim_plan(0)


CSRC = pathlib.Path(mfa_tpu_torch.__file__).parent / "csrc"
# each C entry point (source, function) and the argtypes its wrapper binds
ENTRY_POINTS = {
    ("prefill", "mfa_prefill_fwd"): prefill._ARGTYPES,
    ("prefill", "mfa_varlen_fwd"): varlen._ARGTYPES,
    ("bound", "mfa_flagged_fwd"): prefill._ZS_ARGTYPES,
    ("bound", "mfa_repair_fwd"): prefill._ZS_ARGTYPES,
    ("bound", "mfa_bound_fwd"): prefill._ZS_ARGTYPES,
    ("blockmask", "mfa_image_block_fwd"): blockmask._ARGTYPES,
    ("decode", "mfa_decode_partials"): decode._PARTIALS_ARGTYPES,
    ("paged", "mfa_paged_decode"): paged._ARGTYPES,
    ("paged_prefill", "mfa_paged_prefill"): paged_prefill._ARGTYPES,
    ("backward", "mfa_bwd_fused"): backward._FUSED_ARGTYPES,
    ("backward", "mfa_bwd_dkv"): backward._DKV_ARGTYPES,
    ("backward", "mfa_bwd_dq"): backward._DQ_ARGTYPES,
    ("backward", "mfa_varlen_bwd_dkv"): backward._VL_DKV_ARGTYPES,
    ("backward", "mfa_varlen_bwd_dq"): backward._VL_DQ_ARGTYPES,
    ("wmatmul", "mfa_int8_matmul"): wmatmul._ARGTYPES,
    ("wmatmul", "mfa_int8_bank_matmul"): wmatmul._BANK_ARGTYPES,
}


def _c_params(src, name):
    """The (type, name) parameters of `extern "C" int name(...)` in
    csrc/src.cu: type "ptr", "int" or "float"; macro parameter lists
    (bound.cu's MFA_ZS_ARGS) expanded."""
    text = (CSRC / f"{src}.cu").read_text()
    body = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
    macro = re.search(rf"#define {body.strip()}\s+\\\n(.*?)(?<!\\)\n", text, re.S)
    if macro:
        body = macro.group(1).replace("\\\n", " ")
    params = []
    for p in body.split(","):
        words = p.replace("*", " * ").split()
        params.append(("ptr" if "*" in words else words[-2], words[-1]))
    return params


@pytest.mark.parametrize("src,name", list(ENTRY_POINTS))
def test_c_entry_points_match_their_argtypes(src, name):
    """Each wrapper binds its C function's parameters one for one; every
    attention launch takes the plan's kernel D as `kd` right after the
    stored width `d` (the C side only checks that the rows fit)."""
    ctype = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    params = _c_params(src, name)
    assert [ctype[t] for t, _ in params] == ENTRY_POINTS[(src, name)]
    names = [n for _, n in params]
    if src != "wmatmul":
        assert names[names.index("d") + 1] == "kd"


def _padded(plan, *xs):
    return [pad_features(x, plan.stored) for x in xs]


@pytest.mark.parametrize("d", DIMS)
def test_plain_through_the_padded_plan_equals_true_width(d):
    """What a CUDA wrapper does around its kernel, run with the plain
    versions: rows padded to the stored width of the widest plan of this d
    (int4's), the true d's scale, outputs sliced, equal to the plain
    version at d within 1e-6."""
    plan = head_dim_plan(d, "int4")  # the widest stored width of this d
    scale = d ** -0.5
    q, k, v, do = _t(_rn(1, 1, 4, 40, d), _rn(2, 1, 2, 40, d), _rn(3, 1, 2, 40, d),
                     _rn(4, 1, 4, 40, d))
    band = (scale, 12, 0, 0.0, True, 3)
    o, lse = prefill._prefill_plain(q, k, v, *band)
    po, plse = prefill._prefill_plain(*_padded(plan, q, k, v), *band)
    assert po.shape[-1] == plan.stored
    torch.testing.assert_close(unpad_features(po, d), o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    for mode in (None, "prepass"):  # the zero-shift engines' plain versions
        eng, m = prefill.select_engine(mode, torch.float32, d, 0.0)
        assert eng == "bound"  # no d here is a multiple of 128
        a = prefill._engine_plain(eng, m, q, k, v, scale, 12, 0, 3)
        b = prefill._engine_plain(eng, m, *_padded(plan, q, k, v), scale, 12, 0, 3)
        torch.testing.assert_close(unpad_features(b[0], d), a[0], atol=1e-6,
                                   rtol=1e-6)
    grads = backward._bwd_plain(q, k, v, o, lse, do, scale, 12, 0, 0.0, 3)
    pgrads = backward._bwd_plain(*_padded(plan, q, k, v, o), lse,
                                 *_padded(plan, do), scale, 12, 0, 0.0, 3)
    for g, pg in zip(grads, pgrads):
        torch.testing.assert_close(unpad_features(pg, d), g, atol=1e-6, rtol=1e-6)
    # contiguous decode at group 16: partials over 2 splits, combined
    qd, kc, vc = _t(_rn(5, 2, 16, d), _rn(6, 2, 1, 150, d), _rn(7, 2, 1, 150, d))
    lens = torch.tensor([150, 37], dtype=torch.int32)
    ns, tps = decode.split_layout(150, 2)
    ref = decode._decode_partials_plain(qd, kc, vc, lens, scale, ns, tps, 30, 0.0, 2)
    got = decode._decode_partials_plain(*_padded(plan, qd, kc, vc), lens, scale, ns,
                                        tps, 30, 0.0, 2)
    torch.testing.assert_close(unpad_features(got[0], d), ref[0], atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(got[1], ref[1], atol=1e-6, rtol=1e-6)


# -- the entry points against mfa_tpu ----------------------------------------

@pytest.mark.parametrize("d", DIMS)
def test_flash_attn_func_matches_jax(d):
    """flash_attn_func causal and with a window, GQA 4:2; prefill_attention
    with a window and 4 sinks, on the engine each d takes (the bound
    prepass: d % 128 != 0, as mfa_tpu selects it) and the classic one,
    against mfa_tpu's default engine."""
    assert prefill.select_engine(None, torch.bfloat16, d, 0.0)[0] == "bound"
    q, k, v = _rn(d, 1, 90, 4, d), _rn(d + 1, 1, 90, 2, d), _rn(d + 2, 1, 90, 2, d)
    for kw in (dict(causal=True), dict(causal=True, window_size=(20, 5))):
        want = np.asarray(mfa_tpu.flash_attn_func(*_j(q, k, v), **kw))
        got = mfa_tpu_torch.flash_attn_func(*_t(q, k, v), **kw)
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    qt, kt, vt = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    kw = dict(causal=True, window_size=(20, -1), sink_tokens=4)
    want = np.asarray(jax_prefill(*_j(qt, kt, vt), **kw))
    for mode in (None, False):
        got = prefill.prefill_attention(*_t(qt, kt, vt), bound_softmax=mode, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", DIMS)
def test_varlen_packed_and_paged_match_jax(d):
    lens_q, lens_k, hq, hkv, page = [9, 30, 3], [30, 30, 11], 4, 2, 8
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    q = _rn(d, sum(lens_q), hq, d)
    k, v = _rn(d + 1, sum(lens_k), hkv, d), _rn(d + 2, sum(lens_k), hkv, d)
    args = (cu_q, cu_k, max(lens_q), max(lens_k))
    kw = dict(causal=True, window_size=(10, -1))
    want = np.asarray(mfa_tpu.flash_attn_varlen_func(*_j(q, k, v), *args, **kw))
    got = mfa_tpu_torch.flash_attn_varlen_func(*_t(q, k, v, cu_q, cu_k),
                                               *args[2:], **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the block_table route (kernel 8 on a pool of the batch's pages)
    num_pages, pps = 16, 4
    kp, vp = _rn(d + 3, num_pages, page, hkv, d), _rn(d + 4, num_pages, page, hkv, d)
    table = (np.random.RandomState(d).permutation(num_pages - 1)[: 3 * pps] + 1
             ).reshape(3, pps).astype(np.int32)
    want = np.asarray(mfa_tpu.flash_attn_varlen_func(
        *_j(q, kp, vp), *args, block_table=jnp.asarray(table), **kw))
    got = mfa_tpu_torch.flash_attn_varlen_func(
        *_t(q, kp, vp, cu_q, cu_k), *args[2:], block_table=torch.from_numpy(table),
        **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _pools(kf, vf, fmt):
    """One payload (kf, vf [hkv, P, page, d] fp32), as each package stores
    it -> (jax k, v, scales), (port k, v, scales): JAX's rows 128-lane
    padded (int4 token pairs), the port's at its stored width (int4
    feature pairs), both from JAX's quantization (scales over the true
    features)."""
    d = kf.shape[-1]
    lanes = -(-d // 128) * 128
    if fmt is None:
        pad = ((0, 0),) * 3 + ((0, lanes - d),)
        return ((np.pad(kf, pad), np.pad(vf, pad), None, None),
                (*(stored_rows(None, x) for x in _t(kf, vf)), None, None))
    (kq, ks), (vq, vs) = (jax_quantize(jnp.asarray(x), fmt) for x in (kf, vf))
    ks, vs = np.asarray(ks), np.asarray(vs)
    jk, jv = (jnp.pad(x, ((0, 0),) * 3 + ((0, lanes - d),)) for x in (kq, vq))
    if fmt == "int4":
        hkv, P, page, _ = jk.shape
        jk, jv = (pack_int4_pairs(x.reshape(hkv, P * page, lanes)).reshape(
            hkv, P, page // 2, lanes) for x in (jk, jv))
    tk, tv = (torch.from_numpy(np.asarray(x).view(np.uint8 if fmt == "fp8"
                                                  else np.int8).copy())
              for x in (kq, vq))
    tk, tv = (stored_rows(fmt, x.view(FP8) if fmt == "fp8" else x) for x in (tk, tv))
    if fmt == "fp8":
        tk, tv = tk.view(FP8), tv.view(FP8)
    return (jk, jv, ks, vs), (tk, tv, *_t(ks, vs))


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f or "fp32")
@pytest.mark.parametrize("d", DIMS)
def test_kvcache_pages_match_jax(d, fmt):
    """Kernel 6 (paged decode) on every page format with a window, against
    mfa_tpu's paged kernel; the fp32 pool through flash_attn_with_kvcache
    too. The pools dequantize equal."""
    b, hq, hkv, pages, page, pps = 3, 8, 2, 14, 16, 4
    q = _rn(d, b, hq, d)
    kf, vf = _rn(d + 1, hkv, pages, page, d), _rn(d + 2, hkv, pages, page, d)
    table = (np.random.RandomState(d).permutation(pages - 1)[: b * pps] + 1
             ).reshape(b, pps).astype(np.int32)
    lens = np.array([60, 0, 33], np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(kf, vf, fmt)
    assert tk.shape[-1] == row_width(fmt, d)
    jkw = dict(k_scales=None if jks is None else jnp.asarray(jks),
               v_scales=None if jvs is None else jnp.asarray(jvs))
    kw = dict(window_left=40, quant_dtype=fmt)
    want, wlse = jax_paged(jnp.asarray(q), jk, jv, *_j(lens, table), return_lse=True,
                           **jkw, **kw)
    got, lse = paged.paged_attention(*_t(q), tk, tv, *_t(lens, table), k_scales=tks,
                                     v_scales=tvs, return_lse=True, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fin = np.isfinite(np.asarray(wlse))
    np.testing.assert_allclose(lse.numpy()[fin], np.asarray(wlse)[fin], **TOL)
    if fmt is None:  # the public entry point on the pool [P, page, hkv, w]
        got = mfa_tpu_torch.flash_attn_with_kvcache(
            *_t(q[:, None]), tk.permute(1, 2, 0, 3), tv.permute(1, 2, 0, 3),
            cache_seqlens=torch.from_numpy(lens), block_table=torch.from_numpy(table),
            window_size=(40, -1))
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), **TOL)
        return
    vals = unpack_int4(tk) if fmt == "int4" else tk
    np.testing.assert_array_equal(vals.float().numpy()[..., d:], 0.0)  # zero features
    deq = vals.float().numpy()[..., :d] * tks.numpy()[..., None]
    jvals = np.asarray(jax_quantize(jnp.asarray(kf), fmt)[0], np.float32)
    np.testing.assert_allclose(deq, jvals * jks[..., None], rtol=1e-6, atol=0)


@pytest.mark.parametrize("fmt", ("int8", "int4"))
@pytest.mark.parametrize("d", (80, 100))
def test_paged_prefill_pages_match_jax(d, fmt):
    """Kernel 8's plain version on stored-width pages: a chunk at q_start 32
    with a window, against mfa_tpu's paged prefill kernel."""
    from mfa_tpu.kernels.paged_prefill import paged_prefill_attention as jpp

    b, sq, hq, hkv, page, pps = 2, 24, 8, 2, 16, 5
    pages = b * pps + 2
    q = _rn(d, b, sq, hq, d)
    kf, vf = _rn(d + 1, hkv, pages, page, d), _rn(d + 2, hkv, pages, page, d)
    table = (np.random.RandomState(d).permutation(pages - 1)[: b * pps] + 1
             ).reshape(b, pps).astype(np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(kf, vf, fmt)
    q_start, lens = np.array([32, 0], np.int32), np.array([56, 20], np.int32)
    want = np.asarray(jpp(jnp.asarray(q), jk, jv, *_j(lens, q_start, table),
                          k_scales=jnp.asarray(jks), v_scales=jnp.asarray(jvs),
                          quant_dtype=fmt, window_left=20), np.float32)
    got, _ = _paged_prefill_plain(*_t(q), tk, tv, tks, tvs, *_t(lens, q_start),
                                  torch.from_numpy(lens - q_start),
                                  torch.from_numpy(table), d ** -0.5, 20, 0, 0.0, fmt)
    for i, r in enumerate(lens - q_start):  # p rounds to bf16 (test_torch_kv_formats)
        np.testing.assert_allclose(got.numpy()[i, :r], want[i, :r], atol=5e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("d", DIMS)
def test_image_block_prefill_matches_jax(d):
    s = 100
    q, k, v = _rn(d, 1, 4, s, d), _rn(d + 1, 1, 2, s, d), _rn(d + 2, 1, 2, s, d)
    ids = np.full((1, s), -1, np.int32)
    ids[0, 20:60] = 0
    want = jax_image_block(*_j(q, k, v, ids), window_left=16, block_q=128,
                           block_k=128)
    got = blockmask.image_block_prefill(*_t(q, k, v, ids), window_left=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", DIMS)
def test_backward_gradients_match_jax(d):
    """dQ, dK, dV of the fused and the split route, causal with a window,
    GQA 4:2, at the caller's head_dim."""
    q, k, v, do = (_rn(d + i, 1, h, 96, d) for i, h in enumerate((4, 2, 2, 4)))
    out, lse = jax_prefill(*_j(q, k, v), causal=True, window_size=(30, -1),
                           return_lse=True)
    out, lse = np.asarray(out), np.asarray(lse)
    kw = dict(causal=True, window_size=(30, -1))
    want = jax_bwd(*_j(q, k, v, out, lse, do), **kw)
    for fused in (True, False):
        got = backward.flash_attention_bwd(*_t(q, k, v, out, lse, do), fused=fused,
                                           **kw)
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("group", (16, 32))
def test_decode_groups_match_jax(group):
    """Kernel 5's plain version (the split partials and their combine) at
    16 and 32 q heads a kv head, which the kernel runs in 16-row blocks,
    against mfa_tpu's decode_attention, d 80, 2 splits and the heuristic's
    count."""
    b, hkv, s, d = 2, 2, 200, 80
    q = _rn(group, b, group * hkv, d)
    kc, vc = _rn(group + 1, b, hkv, s, d), _rn(group + 2, b, hkv, s, d)
    lens = np.array([200, 77], np.int32)
    kw = dict(window_left=90, sink_tokens=3)
    want = np.asarray(jax_decode(*_j(q, kc, vc, lens), block_k=128, **kw))
    assert decode.row_blocks(group) == group // 16
    for n in (0, 2):
        got = decode.decode_attention(*_t(q, kc, vc, lens), num_splits=n, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- a tiny H2O-Danube-shaped model ------------------------------------------

def _danube_cfgs():
    """2 layers of head_dim 80 (dim 320 / 4 q heads), 1 kv head (group 4),
    a window of 24, untied lm_head: H2O-Danube-1.8B's shape at a tiny
    width."""
    base = dict(vocab=64, dim=320, layers=2, heads=4, kv_heads=1, ffn=96)
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(**base, dtype=jnp.float32),
                               sliding_window=24)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(**base, dtype=torch.float32),
                               sliding_window=24)
    assert jcfg.head_dim == tcfg.head_dim == 80
    return jcfg, tcfg


JCFG, TCFG = _danube_cfgs()


@pytest.fixture(scope="module")
def danube():
    jp = jl.init_params(jax.random.key(11), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


@pytest.mark.parametrize("quant,chunk", [("int8", None), ("int4", 16)])
def test_danube_engine_tokens_match_jax(danube, quant, chunk):
    """Greedy tokens of the Engine equal mfa_tpu's: int8 KV plain (prompt
    waves past the window, deferred-append decode steps); int4 KV (rows
    widened to 48 bytes) with chunked prefill and the prefix cache, in two
    waves, the second hitting the first's shared prompt."""
    jp, tp = danube
    rng = np.random.RandomState(5)
    shared = [int(t) for t in rng.randint(0, 64, 20)]
    waves = [[([int(t) for t in rng.randint(0, 64, n)], 5) for n in (9, 30, 15)]]
    kw = dict(num_pages=24, page_size=8, max_seqs=4, pages_per_seq=6,
              quant_dtype=quant)
    if chunk:
        waves = [[(shared + [5], 4), ([int(t) for t in rng.randint(0, 64, 33)], 4)],
                 [(shared + [6, 6], 4)]]
        kw.update(prefill_chunk=chunk, prefix_cache=True)
    jeng = JaxEngine(jp, JCFG, **kw)
    eng = Engine(tp, TCFG, device="cpu", **kw)
    assert eng.cache.k_pages.shape[-1] == row_width(quant, 80)
    jreqs, reqs = [], []
    for wave in waves:
        jreqs += [jeng.submit(p, n) for p, n in wave]
        jeng.run()
        reqs += [eng.submit(p, n) for p, n in wave]
        eng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == jr.generated, (r.uid, r.generated, jr.generated)
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-3)
    if chunk:
        assert eng.stats.chunk_batches > 0 and eng.sched.prefix.pages


def test_danube_train_step_matches_jax(danube):
    """One SGD step on 2 x 40 tokens (past the window): loss and every
    updated weight within 1e-4 of mfa_tpu's."""
    jp, tp = danube
    toks = np.random.RandomState(3).randint(0, 64, (2, 40)).astype(np.int32)
    jp, jloss = jl.train_step(jp, jnp.asarray(toks), JCFG, lr=0.1)
    tp, tloss = tl.train_step(tp, toks, TCFG, lr=0.1)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for i, lp in enumerate(tp["layers"]):
        for name, t in lp.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jp["layers"][name][i]),
                                       err_msg=f"layer {i} {name}", **TOL)


def test_danube_preset_is_the_published_config():
    """LlamaConfig.h2o_danube_1_8b() equals what both packages' config_from_hf
    derive from h2oai/h2o-danube-1.8b-base's config.json fields."""
    from types import SimpleNamespace

    from mfa_tpu.models.convert import config_from_hf as jax_from_hf
    from mfa_tpu_torch.models.convert import config_from_hf

    hf = SimpleNamespace(
        model_type="mistral", vocab_size=32000, hidden_size=2560,
        intermediate_size=6912, num_hidden_layers=24, num_attention_heads=32,
        num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=4096, max_position_embeddings=16384, hidden_act="silu",
        tie_word_embeddings=False)
    preset = tl.LlamaConfig.h2o_danube_1_8b()
    assert config_from_hf(hf) == preset
    assert preset.head_dim == 80 and preset.n_heads // preset.n_kv_heads == 4
    want = jax_from_hf(hf)
    for f in dataclasses.fields(preset):
        if f.name != "dtype":
            assert getattr(preset, f.name) == getattr(want, f.name), f.name
