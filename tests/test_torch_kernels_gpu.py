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
