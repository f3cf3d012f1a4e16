"""The port's paged prefill attention (plain path on CPU) against mfa_tpu's
paged prefill kernel in Pallas interpret mode: chunks at offset 0 and mid
sequence, fp32, bf16 and int8 pages, a sliding window, a non-causal band,
q_lens shorter than the chunk, GQA 4:1 and the LSE [b, heads, sq], over a
shuffled non-contiguous block table. head_dim 128, so the pages need no
lane padding on the JAX side; and at Gemma3's head_dim 256 (the kernel's
64-key tile, its own head-dim tuple) on bf16 and int8 pages with a
window. Inputs from numpy with a seed; fp32 and
int8 pages (identical payloads and scales on both sides) atol = rtol =
1e-4; bf16 pages 1e-2 (one bf16 rounding of the output on either side).
Only real rows (r < q_lens) are compared with JAX, whose other rows are
unspecified; the port's are O = 0, LSE = -inf."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
B, SQ, HQ, HKV, D, PAGE, PPS = 2, 32, 8, 2, 128, 16, 6


def _case(seed, d=D):
    rng = np.random.RandomState(seed)
    num_pages = B * PPS + 3
    q = rng.standard_normal((B, SQ, HQ, d)).astype(np.float32)
    kp = rng.standard_normal((HKV, num_pages, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((HKV, num_pages, PAGE, d)).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[: B * PPS] + 1).reshape(B, PPS)
    return q, kp, vp, table.astype(np.int32)


CASES = {
    # name: (q_start, lengths, q_lens, causal, window_left, window_right,
    #        pages); row 0 mid sequence, row 1 at offset 0 or mid
    "causal": ([32, 0], [64, 20], None, True, -1, -1, "fp32"),
    "q_lens_short": ([48, 16], [80, 36], [32, 20], True, -1, -1, "fp32"),
    "window": ([32, 64], [64, 96], None, True, 20, -1, "fp32"),
    "noncausal_band": ([16, 0], [48, 70], [32, 32], False, 10, 6, "fp32"),
    "int8": ([0, 64], [32, 96], None, True, -1, -1, "int8"),
    "bf16": ([32, 0], [64, 32], None, True, -1, -1, "bf16"),
}


# Gemma3's head_dim: its sliding layers' window on bf16 and int8 pages
CASES_256 = {
    "int8_window": ([32, 64], [64, 96], None, True, 20, -1, "int8"),
    "bf16_window": ([32, 0], [64, 32], None, True, 24, -1, "bf16"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_paged_prefill_matches_jax(name):
    _check(CASES[name], len(name), D)


@pytest.mark.parametrize("name", list(CASES_256))
def test_paged_prefill_head_dim_256(name):
    _check(CASES_256[name], len(name), 256)


def test_paged_prefill_head_dim_plan_without_running():
    """The card's route checks its inputs before any launch, on meta
    tensors (nothing is built or run): head_dim 96 passes (kernel 8 runs it
    at D 128 on rows of 96), 257 raises ValueError as mfa_tpu does, and so
    does a q head count that is not a multiple of the kv heads'; more than
    64 q heads a kv head and pages of any row count pass."""
    from mfa_tpu_torch.kernels import paged_prefill

    def meta(d, hq=8, hkv=2, page=16):
        q = torch.empty(1, 8, hq, d, dtype=torch.bfloat16, device="meta")
        pages = torch.empty(hkv, 3, page, d, dtype=torch.bfloat16, device="meta")
        return q, pages

    plan = paged_prefill.cuda_plan(*meta(96))
    assert (plan.kernel_dim, plan.stored, plan.padded) == (128, 96, False)
    with pytest.raises(ValueError, match="head_dim"):
        paged_prefill.cuda_plan(*meta(257))
    with pytest.raises(ValueError, match="divisible"):
        paged_prefill.cuda_plan(*meta(96, hq=65, hkv=2))
    for kw in (dict(hq=65, hkv=1), dict(hq=142, hkv=2), dict(page=1),
               dict(page=4), dict(page=12)):
        plan = paged_prefill.cuda_plan(*meta(96, **kw))
        assert (plan.kernel_dim, plan.stored) == (128, 96)


def _check(spec, seed, d):
    q_start, lens, q_lens, causal, wl, wr, pages = spec
    q, kp, vp, table = _case(seed, d)
    jkw, tkw = {}, {}
    tol = TOL
    if pages == "int8":
        kq, ks = (np.array(a) for a in jax_quantize(jnp.asarray(kp), "int8"))
        vq, vs = (np.array(a) for a in jax_quantize(jnp.asarray(vp), "int8"))
        kp, vp = kq, vq
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                   quant_dtype="int8")
        tkw = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
                   quant_dtype="int8")
    if pages == "bf16":
        tol = dict(atol=1e-2, rtol=1e-2)
        jconv = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        tconv = lambda a: torch.from_numpy(  # noqa: E731
            np.asarray(jconv(a)).astype(np.float32)).to(torch.bfloat16)
    else:
        jconv, tconv = jnp.asarray, torch.from_numpy
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    jo, jl = jax_paged_prefill(
        jconv(q), jconv(kp) if pages != "int8" else jnp.asarray(kp),
        jconv(vp) if pages != "int8" else jnp.asarray(vp),
        jnp.asarray(lens, jnp.int32), jnp.asarray(q_start, jnp.int32),
        jnp.asarray(table), q_lens=None if ql is None else jnp.asarray(ql),
        causal=causal, window_left=wl, window_right=wr, return_lse=True,
        **jkw)
    to, tl = paged_prefill_attention(
        tconv(q), tconv(kp) if pages != "int8" else torch.from_numpy(kp),
        tconv(vp) if pages != "int8" else torch.from_numpy(vp),
        torch.tensor(lens), torch.tensor(q_start), torch.from_numpy(table),
        q_lens=None if ql is None else torch.from_numpy(ql), causal=causal,
        window_left=wl, window_right=wr, return_lse=True, **tkw)
    assert to.shape == q.shape and tl.shape == (B, HQ, SQ)
    assert to.dtype == (torch.bfloat16 if pages == "bf16" else torch.float32)
    real = ql if ql is not None else np.maximum(
        np.asarray(lens) - np.asarray(q_start), 0)
    jo, jl = np.asarray(jo, np.float32), np.asarray(jl)
    to, tl = to.float().numpy(), tl.numpy()
    for b in range(B):
        r = int(real[b])
        np.testing.assert_allclose(to[b, :r], jo[b, :r], **tol)
        np.testing.assert_array_equal(np.isneginf(tl[b, :, :r]),
                                      np.isneginf(jl[b, :, :r]))
        fin = np.isfinite(jl[b, :, :r])
        np.testing.assert_allclose(tl[b, :, :r][fin], jl[b, :, :r][fin],
                                   atol=1e-3 if pages == "bf16" else 1e-4,
                                   rtol=1e-3 if pages == "bf16" else 1e-4)
        assert np.all(to[b, r:] == 0) and np.all(np.isneginf(tl[b, :, r:]))


def test_paged_prefill_rejects_what_is_not_ported(monkeypatch):
    q, kp, vp, table = _case(0)
    args = [torch.from_numpy(a) for a in (q, kp, vp)] + [
        torch.tensor([32, 32]), torch.tensor([0, 0]), torch.from_numpy(table)]
    with pytest.raises(ValueError):
        paged_prefill_attention(*args, quant_dtype="int2")
    jargs = [jnp.asarray(np.asarray(a)) for a in args]
    for fn, xs, ones in ((paged_prefill_attention, args, torch.ones(HQ)),
                         (jax_paged_prefill, jargs, jnp.ones(HQ))):
        with pytest.raises(ValueError):  # raises in both packages
            fn(*xs, window_left=8, sink_tokens=4, logit_softcap=5.0,
               alibi_slopes=ones)
    with pytest.raises(ValueError):
        paged_prefill_attention(*args, k_scales=torch.ones(kp.shape[:3]),
                                v_scales=torch.ones(kp.shape[:3]))
    # the card's route, on meta tensors (nothing built or run): more than 64
    # q heads a kv head and pages of any row count are taken at any
    # head_dim, and so are fp32 q and pages (the C launch replaced by a stub
    # that reports success)
    from mfa_tpu_torch.kernels import _build, paged_prefill

    monkeypatch.setattr(_build, "function", lambda lib, name, argtypes: lambda *a: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)

    def meta(d, hq=8, page=16, dtype=torch.bfloat16):
        q = torch.empty(1, 8, hq, d, dtype=dtype, device="meta")
        pages = torch.empty(1, 3, page, d, dtype=dtype, device="meta")
        ints = torch.empty(1, dtype=torch.int32, device="meta")
        table = torch.empty(1, 1, dtype=torch.int32, device="meta")
        return (q, pages, pages, None, None, ints, ints, ints, table, 0.1, -1,
                0, 0.0)

    for d in (80, 128):
        for kw in (dict(hq=65), dict(hq=71), dict(page=1), dict(page=4),
                   dict(page=12)):
            _build.reset_launches()
            out, lse = paged_prefill._paged_prefill_cuda(*meta(d, **kw))
            assert out.shape == (1, 8, kw.get("hq", 8), d)
            assert _build.launches["paged_prefill"] == 1
        _build.reset_launches()
        out, lse = paged_prefill._paged_prefill_cuda(*meta(d, dtype=torch.float32))
        assert out.dtype == torch.float32 and out.shape == (1, 8, 8, d)
        assert _build.launches["paged_prefill_fp32"] == 1
    _build.reset_launches()
