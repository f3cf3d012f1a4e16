"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16/fp16: max abs error < 2e-2, SURVEY.md §4; the plain version runs on
the same inputs upcast to fp32, LSE within 1e-3 with the same -inf rows).
Needs a CUDA device and nvcc: on the GPU machine run
`python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest -o addopts=""`;
elsewhere every test skips."""

import pytest
import torch

pytestmark = pytest.mark.gpu

BF, HF = torch.bfloat16, torch.float16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rn(gen, *shape, dtype=BF):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _close(out, lse, ref, ref_lse):
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max() < 2e-2
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = torch.isfinite(ref_lse)
    if fin.any():
        assert (lse[fin] - ref_lse[fin]).abs().max() < 1e-3


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap,dtype", [
    (2, 8, 2, 100, 130, 128, True, (-1, -1), 0.0, BF),
    (2, 8, 2, 100, 130, 128, False, (9, 4), 0.0, BF),
    (1, 4, 4, 64, 64, 128, True, (-1, -1), 30.0, BF),
    (1, 8, 1, 1, 1, 64, False, (-1, -1), 0.0, BF),      # one row, one column
    (3, 4, 2, 65, 63, 64, True, (0, -1), 0.0, HF),       # window 0: self only
    (1, 16, 2, 200, 50, 64, False, (10, -1), 0.0, HF),   # dead rows past sk
    (2, 2, 2, 300, 300, 128, True, (127, -1), 0.0, HF),
])
def test_prefill_kernel(dev, b, hq, hkv, sq, sk, d, causal, window, softcap,
                        dtype):
    from mfa_tpu_torch.kernels import prefill

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rn(gen, b, hq, sq, d, dtype=dtype), _rn(gen, b, hkv, sk, d, dtype=dtype),
               _rn(gen, b, hkv, sk, d, dtype=dtype))
    o, lse = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                       logit_softcap=softcap, return_lse=True)
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5,
                                    window[0], 0 if causal else window[1],
                                    softcap, True)
    _close(o, lse, ro, rl)


@pytest.mark.parametrize("b,hq,hkv,s,d,lens,splits,window,softcap,dtype", [
    (3, 8, 2, 700, 64, [700, 0, 257], (1, 2, 3, 0), -1, 0.0, BF),
    (2, 8, 8, 65, 128, [65, 1], (1, 2), -1, 0.0, BF),
    (4, 32, 8, 1000, 128, [1000, 999, 64, 63], (0, 5), 100, 0.0, HF),
    (2, 4, 1, 300, 64, [300, 200], (2,), -1, 20.0, BF),
])
def test_decode_kernel(dev, b, hq, hkv, s, d, lens, splits, window, softcap,
                       dtype):
    from mfa_tpu_torch.kernels import decode

    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (_rn(gen, b, hq, d, dtype=dtype), _rn(gen, b, hkv, s, d, dtype=dtype),
               _rn(gen, b, hkv, s, d, dtype=dtype))
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    for ns in splits:
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns,
                                         window_left=window,
                                         logit_softcap=softcap, return_lse=True)
        n, tps = decode.split_layout(s, ns if ns else decode.num_splits_heuristic(
            b, hkv, s, decode.TILE))
        po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L,
                                               d ** -0.5, n, tps, window, softcap)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _close(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
    assert torch.all(o[torch.tensor(lens, device=dev) == 0] == 0)


@pytest.mark.parametrize("hq,hkv,page,d,quant,dtype,pos_offset,window,softcap", [
    (32, 8, 64, 128, True, BF, 1, -1, 0.0),
    (32, 8, 64, 128, False, BF, 1, 50, 0.0),
    (8, 8, 16, 64, True, HF, 0, -1, 0.0),       # fp16 q over int8 pages
    (8, 1, 8, 64, False, HF, 0, 20, 0.0),       # pages smaller than a tile
    (16, 2, 32, 128, True, BF, 1, 1, 0.0),
    (32, 8, 64, 128, True, BF, 1, -1, 15.0),
])
def test_paged_kernel(dev, hq, hkv, page, d, quant, dtype, pos_offset, window,
                      softcap):
    from mfa_tpu_torch.kernels import paged
    from mfa_tpu_torch.kernels.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(2)
    lens = [300, 0, page, 383 // page * page - 1]
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    if quant:
        (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
    else:
        kp, vp, ks, vs = kf, vf, None, None
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=pos_offset,
                                   logit_softcap=softcap, return_lse=True)
    # int8 pages contract in bf16: the kernel rounds fp16 q to bf16 first
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged._paged_plain(q_ref, kp, vp, ks, vs, L, table, d ** -0.5,
                                window, softcap, pos_offset)
    assert o.dtype == dtype
    _close(o, lse, ro, rl)
    assert torch.all(o[1] == 0)


def test_launch_counts_and_misaligned_views(dev):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(3)
    flat = _rn(gen, 1 + 2 * 4 * 80 * 64)
    q = flat[1:].view(2, 4, 80, 64)  # starts 2 bytes past an aligned address
    k = _rn(gen, 2, 4, 80, 64)
    _build.reset_launches()
    o = prefill.prefill_attention(q, k, k, causal=True)
    assert _build.launches["prefill"] == 1
    ro = prefill._prefill_plain(q.float(), k.float(), k.float(), 64 ** -0.5,
                                -1, 0, 0.0, False)
    assert (o.float() - ro).abs().max() < 2e-2


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,causal,window,softcap,dtype", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 32, 8, 128, True, (-1, -1), 0.0, BF),
    ([100, 37, 300], [130, 64, 200], 8, 2, 128, False, (128, 64), 0.0, BF),
    ([30, 5], [10, 0], 4, 2, 64, True, (3, -1), 0.0, HF),   # dead rows
    ([65, 1, 64], [65, 1, 64], 4, 4, 64, True, (-1, -1), 30.0, BF),
])
def test_varlen_kernel(dev, lens_q, lens_k, hq, hkv, d, causal, window, softcap,
                       dtype):
    from mfa_tpu_torch.kernels import _build, varlen

    gen = torch.Generator(device=dev).manual_seed(4)
    q = _rn(gen, sum(lens_q), hq, d, dtype=dtype)
    k, v = (_rn(gen, sum(lens_k), hkv, d, dtype=dtype) for _ in range(2))
    cu_q = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
    cu_k = torch.tensor([0] + lens_k, device=dev).cumsum(0).int()
    _build.reset_launches()
    o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lens_q), max(lens_k),
                                     causal=causal, window_size=window,
                                     logit_softcap=softcap, return_lse=True)
    assert _build.launches["varlen"] == 1
    ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu_q, cu_k,
                                  d ** -0.5, window[0], 0 if causal else window[1],
                                  softcap, True)
    assert o.dtype == dtype and lse.shape == (hq, sum(lens_q))
    _close(o, lse, ro, rl)


@pytest.mark.parametrize(
    "hq,hkv,page,d,quant,dtype,q_start,sq,lens,q_lens,causal,window,softcap", [
        (32, 8, 64, 128, True, BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (8, 2, 16, 128, False, BF, [16, 0], 100, [116, 70], [100, 40], False,
         (10, 6), 0.0),
        (4, 4, 64, 64, False, HF, [64, 0], 130, [194, 100], None, True, (40, -1),
         0.0),
        (16, 2, 32, 128, True, HF, [96, 0], 64, [160, 64], None, True, (-1, -1),
         20.0),
    ])
def test_paged_prefill_kernel(dev, hq, hkv, page, d, quant, dtype, q_start, sq,
                              lens, q_lens, causal, window, softcap):
    from mfa_tpu_torch.kernels import _build, paged_prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(5)
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    if quant:
        (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
    else:
        kp, vp, ks, vs = kf, vf, None, None
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = (L - qs).clamp(min=0) if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device=dev)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs,
        causal=causal, window_left=window[0], window_right=window[1],
        logit_softcap=softcap, return_lse=True)
    assert _build.launches["paged_prefill"] == 1
    # int8 pages contract in bf16: the kernel rounds fp16 q to bf16 first
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, window[0],
        0 if causal else window[1], softcap)
    assert o.dtype == dtype and lse.shape == (b, hq, sq)
    _close(o, lse, ro, rl)


# ---------------- backward kernels (kernels/backward.py) ----------------


def _bwd_close(got, ref, what):
    """Stated limits: max |a - r| <= 2e-2 max |r| and mean |a - r| <= 2e-2
    mean |r| (P and dS round to bf16/fp16 before their products, and the
    fused kernel's dQ atomics change the summation order)."""
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), (what, name)
        d = (g - r).abs()
        assert d.max() <= 2e-2 * r.abs().max() + 1e-6, (what, name, float(d.max()))
        assert d.mean() <= 2e-2 * r.abs().mean() + 1e-6, (what, name, float(d.mean()))


def _bwd_inputs(gen, b, hq, hkv, sq, sk, d, causal, window, softcap, dtype):
    from mfa_tpu_torch.kernels import prefill

    q, k, v = (_rn(gen, b, hq, sq, d, dtype=dtype), _rn(gen, b, hkv, sk, d, dtype=dtype),
               _rn(gen, b, hkv, sk, d, dtype=dtype))
    do = _rn(gen, b, hq, sq, d, dtype=dtype)
    with torch.no_grad():
        o, lse = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                           logit_softcap=softcap, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap,dtype", [
    (2, 8, 2, 300, 300, 128, True, (-1, -1), 0.0, BF),
    (1, 8, 2, 128, 512, 128, True, (-1, -1), 0.0, BF),   # key tiles with no live row
    (1, 4, 4, 300, 8, 64, True, (4, -1), 0.0, BF),       # dead rows
    (2, 4, 1, 100, 37, 64, False, (-1, -1), 0.0, HF),
    (1, 4, 2, 256, 256, 64, False, (64, 0), 0.0, BF),
    (1, 4, 2, 130, 130, 128, True, (-1, -1), 30.0, HF),
])
def test_backward_kernels(dev, b, hq, hkv, sq, sk, d, causal, window, softcap, dtype):
    from mfa_tpu_torch.kernels import _build, backward

    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, o, lse, do = _bwd_inputs(gen, b, hq, hkv, sq, sk, d, causal, window,
                                      softcap, dtype)
    kw = dict(causal=causal, window_size=window, logit_softcap=softcap)
    ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                              do.float(), d ** -0.5, window[0],
                              0 if causal else window[1], softcap)
    _build.reset_launches()
    fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
    split = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert dict(_build.launches) == {"bwd_fused": 1, "bwd_dkv": 1, "bwd_dq": 1}
    assert all(g.dtype == dtype for g in fused + split)
    _bwd_close(fused, ref, "fused")
    _bwd_close(split, ref, "split")
    _bwd_close(fused, split, "fused vs split")
    again = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(split, again))  # deterministic


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,causal,window,softcap,dtype", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 8, 2, 128, True, (-1, -1), 0.0, BF),
    ([100, 37, 300], [130, 64, 200], 8, 2, 128, False, (128, 64), 0.0, BF),
    ([30, 5], [10, 0], 4, 2, 64, True, (3, -1), 0.0, HF),   # dead rows
    ([65, 1, 64], [65, 1, 64], 4, 4, 64, True, (-1, -1), 30.0, BF),
])
def test_varlen_backward_kernels(dev, lens_q, lens_k, hq, hkv, d, causal, window,
                                 softcap, dtype):
    from mfa_tpu_torch.kernels import _build, backward, varlen

    gen = torch.Generator(device=dev).manual_seed(7)
    q = _rn(gen, sum(lens_q), hq, d, dtype=dtype)
    k, v = (_rn(gen, sum(lens_k), hkv, d, dtype=dtype) for _ in range(2))
    do = _rn(gen, sum(lens_q), hq, d, dtype=dtype)
    cu_q = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
    cu_k = torch.tensor([0] + lens_k, device=dev).cumsum(0).int()
    kw = dict(causal=causal, window_size=window, logit_softcap=softcap)
    o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lens_q), max(lens_k),
                                     return_lse=True, **kw)
    _build.reset_launches()
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu_q, cu_k, **kw)
    assert dict(_build.launches) == {"varlen_bwd_dkv": 1, "varlen_bwd_dq": 1}
    ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), cu_q, cu_k, d ** -0.5, window[0],
                                     0 if causal else window[1], softcap)
    _bwd_close(got, ref, "varlen")
    again = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu_q, cu_k, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_autograd_functions_on_the_card(dev):
    """flash_attn_func_grad and flash_attn_varlen_func_grad end to end: the
    card's gradients against the same Functions on the CPU (plain versions)
    from the same bf16 inputs; the bare kernel routes refuse to build a
    detached output for inputs that require grad."""
    from mfa_tpu_torch.kernels import _build, autodiff, prefill

    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = _rn(gen, 2, 256, 8, 128), _rn(gen, 2, 256, 2, 128), _rn(gen, 2, 256, 2, 128)
    w = _rn(gen, 2, 256, 8, 128)
    lens = [100, 256, 0, 156]
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    qv, kv, vv = q.reshape(512, 8, 128), k.reshape(512, 2, 128), v.reshape(512, 2, 128)
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.detach().to(where).requires_grad_() for t in (q, k, v, qv, kv, vv)]
        ww = w.to(where)
        _build.reset_launches()
        o1 = autodiff.flash_attn_func_grad(*leaves[:3], causal=True)
        o2 = autodiff.flash_attn_varlen_func_grad(*leaves[3:], cu.to(where), cu.to(where),
                                                  256, 256, causal=True)
        loss = (o1.float() * ww.float()).sum() + (o2.float() * ww.reshape(512, 8, 128)
                                                  .float()).sum()
        grads[where] = torch.autograd.grad(loss, leaves)
        if where == "cuda":
            assert dict(_build.launches) == {"prefill": 1, "varlen": 1, "bwd_fused": 1,
                                             "varlen_bwd_dkv": 1, "varlen_bwd_dq": 1}
    _bwd_close(grads["cuda"][:3], [g.to(dev) for g in grads["cpu"][:3]], "func")
    _bwd_close(grads["cuda"][3:], [g.to(dev) for g in grads["cpu"][3:]], "varlen")
    with pytest.raises(RuntimeError, match="autodiff"):
        prefill.prefill_attention(q.requires_grad_(), k, v, causal=True)
