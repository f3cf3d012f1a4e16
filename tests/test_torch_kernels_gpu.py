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
    (2, 8, 4, 300, 300, 256, True, (-1, -1), 0.0, BF),   # head_dim 256 (Gemma)
    (1, 8, 4, 200, 200, 256, True, (63, -1), 0.0, HF),
    (2, 4, 2, 100, 130, 256, False, (9, 4), 0.0, BF),
    (1, 4, 4, 64, 64, 256, True, (-1, -1), 30.0, BF),
    (1, 16, 2, 200, 50, 256, False, (10, -1), 0.0, BF),  # dead rows past sk
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
    (2, 8, 4, 700, 256, [700, 1], (1, 3), 100, 0.0, BF),  # head_dim 256
    (3, 8, 1, 300, 256, [300, 0, 129], (2,), -1, 0.0, HF),
    (2, 3, 3, 200, 128, [1, 130], (1, 2, 4), -1, 0.0, BF),          # group 1
    (2, 6, 2, 333, 64, [333, 64], (1, 2, 3, 0), 50, 25.0, HF),      # group 3
    (2, 20, 4, 500, 128, [499, 0], (1, 3, 8), -1, 0.0, BF),         # group 5
    (1, 42, 6, 1000, 256, [1000], (0, 2, 5), 300, 30.0, BF),        # group 7
    (2, 12, 2, 777, 128, [777, 130], (1, 0), 33, 0.0, HF),          # group 6
    (4, 16, 2, 4100, 128, [4100, 65, 4033, 1], (1, 2, 4, 7, 0), 1000, 0.0, BF),
    (1, 32, 8, 32768, 128, [32767], (0, 1), -1, 0.0, BF),           # the long cache
])
def test_decode_kernel(dev, b, hq, hkv, s, d, lens, splits, window, softcap,
                       dtype):
    from mfa_tpu_torch.kernels import _build, decode

    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (_rn(gen, b, hq, d, dtype=dtype), _rn(gen, b, hkv, s, d, dtype=dtype),
               _rn(gen, b, hkv, s, d, dtype=dtype))
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    for ns in splits:
        _build.reset_launches()
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns,
                                         window_left=window,
                                         logit_softcap=softcap, return_lse=True)
        assert dict(_build.launches) == {"decode": 1, "combine": 1}
        n, tps = decode.split_layout(s, ns if ns else decode.default_splits(b, hkv, s))
        po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L,
                                               d ** -0.5, n, tps, window, softcap)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _close(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
    assert torch.all(o[torch.tensor(lens, device=dev) == 0] == 0)


@pytest.mark.parametrize("b,s,d", [(16, 4096, 128), (1, 8192, 64)])
def test_decode_kernel_every_split_count(dev, b, s, d):
    """Splits 1 up to the heuristic's count: each within the limits of its
    plain version, and every count within fp32 rounding of one split (the
    split ranges are whole tiles). Rows past the length hold NaN: the
    kernel must mask them, not multiply them by 0."""
    from mfa_tpu_torch.kernels import decode

    gen = torch.Generator(device=dev).manual_seed(2)
    hq, hkv = 32, 8
    q, k, v = (_rn(gen, b, hq, d), _rn(gen, b, hkv, s, d), _rn(gen, b, hkv, s, d))
    lens = [s - 1 - 37 * i for i in range(b)]
    for i, n in enumerate(lens):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    heur = decode.default_splits(b, hkv, s)
    o1 = None
    for ns in range(1, max(heur, 2) + 1):
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns, return_lse=True)
        n, tps = decode.split_layout(s, ns)
        po, pl = decode._decode_partials_plain(q.float(), k.float().nan_to_num(),
                                               v.float().nan_to_num(), L, d ** -0.5, n,
                                               tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _close(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
        o1 = o.float() if o1 is None else o1
        assert (o.float() - o1).abs().max() <= 1e-2


_GEMMA3_LENS = [300 + (1700 * i) // 9 for i in range(10)]  # 300-2000


@pytest.mark.parametrize("hq,hkv,page,d,quant,dtype,pos_offset,window,softcap,lens", [
    (32, 8, 64, 128, True, BF, 1, -1, 0.0, None),
    (32, 8, 64, 128, False, BF, 1, 50, 0.0, None),
    (8, 8, 16, 64, True, HF, 0, -1, 0.0, None),       # fp16 q over int8 pages
    (8, 1, 8, 64, False, HF, 0, 20, 0.0, None),       # pages smaller than a tile
    (16, 2, 32, 128, True, BF, 1, 1, 0.0, None),
    (32, 8, 64, 128, True, BF, 1, -1, 15.0, None),
    (8, 4, 64, 256, True, BF, 1, 50, 0.0, None),      # head_dim 256, group 2 (Gemma3)
    (8, 4, 64, 256, False, BF, 1, 50, 0.0, None),
    (8, 4, 64, 256, True, HF, 1, -1, 0.0, None),
    (16, 2, 32, 256, False, HF, 0, -1, 0.0, None),    # group 8
    (32, 8, 128, 128, True, BF, 1, -1, 0.0, None),    # pages past a tile: 64-row boxes
    (8, 4, 128, 64, False, BF, 1, 100, 0.0, None),
    # more than one split: Gemma3-4B's decode (b10 hkv4: 40 blocks), b1
    (8, 4, 64, 256, True, BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (8, 4, 64, 256, False, BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (32, 8, 64, 128, True, BF, 1, -1, 0.0, [8192]),
])
def test_paged_kernel(dev, hq, hkv, page, d, quant, dtype, pos_offset, window,
                      softcap, lens):
    from mfa_tpu_torch.kernels import _build, paged
    from mfa_tpu_torch.kernels.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(2)
    if lens is None:
        lens = [300, 0, page, 383 // page * page - 1]
        pps = 400 // page + 1
    else:
        pps = max(lens) // page + 1
    b = len(lens)
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
    splits, _ = paged.split_plan(b, hkv, pps, page)
    if b * hkv < 100:  # the grid does not fill the card: the split route runs
        assert splits > 1
    _build.reset_launches()
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=pos_offset,
                                   logit_softcap=softcap, return_lse=True)
    # one launch at one split; the combine launch merges more
    assert dict(_build.launches) == ({"paged": 1} if splits == 1
                                     else {"paged": 1, "combine": 1})
    # int8 pages contract in bf16: the kernel rounds fp16 q to bf16 first
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged._paged_plain(q_ref, kp, vp, ks, vs, L, table, d ** -0.5,
                                window, softcap, pos_offset)
    assert o.dtype == dtype
    _close(o, lse, ro, rl)
    assert (o.float() - ro.float()).abs().mean() < 2e-3
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(o[i] == 0) and torch.isneginf(lse[i]).all()


@pytest.mark.parametrize("quant,page,d,window", [
    (True, 64, 128, -1), (False, 64, 128, -1), (True, 16, 128, 50),
    (False, 8, 64, -1), (True, 32, 256, -1), (False, 128, 256, 70),
])
def test_paged_kernel_ignores_rows_past_lens(dev, quant, page, d, window):
    """Rows past each length hold NaN (16-bit pages), scales of rows past it
    and of unmapped pages NaN (int8 pages), and table entries past each
    length -1 or out of the pool: O and LSE stay finite and equal to the
    plain version on the cleaned inputs, through every split count."""
    from mfa_tpu_torch.kernels import paged
    from mfa_tpu_torch.kernels.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(7)
    hq, hkv = 8, 2
    lens = [1, 70, 0, 333, 129]
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 2
    q = _rn(gen, b, hq, d)
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    if quant:
        (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
    else:
        kp, vp, ks, vs = kf, vf, None, None
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    used = torch.zeros(P, dtype=torch.bool, device=dev)
    for i, n in enumerate(lens):
        n_pages = -(-n // page)
        used[table[i, :n_pages].long()] = True
        if n % page:  # rows past the length in the last page
            last = int(table[i, n_pages - 1])
            for t in ([ks, vs] if quant else [kp, vp]):
                t[:, last, n % page:] = float("nan")
        table[i, n_pages:] = torch.where(
            torch.arange(pps - n_pages, device=dev) % 2 == 0, -1, 10 ** 6).int()
    for t in ([ks, vs] if quant else [kp, vp]):
        t[:, ~used] = float("nan")
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=1, return_lse=True)
    clean = [None if t is None else t.nan_to_num(0.0) for t in (kp, vp, ks, vs)]
    ro, rl = paged._paged_plain(q.float(), *clean, L, table, d ** -0.5, window, 0.0, 1)
    _close(o, lse, ro, rl)
    assert torch.isfinite(lse[L > 0]).all()
    assert paged.split_plan(b, hkv, pps, page)[0] > 1


def test_paged_kernel_refuses_pages_off_8_rows(dev):
    """A page that is not a multiple of 8 rows cannot keep the swizzle in
    one TMA box: the kernel does not take it, and the wrapper says so."""
    from mfa_tpu_torch.kernels import paged

    q = torch.zeros(1, 4, 64, dtype=BF, device=dev)
    pages = torch.zeros(2, 3, 12, 64, dtype=BF, device=dev)
    lens = torch.tensor([10], dtype=torch.int32, device=dev)
    table = torch.tensor([[1]], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        paged.paged_attention(q, pages, pages, lens, table)


def test_launch_counts_and_misaligned_views(dev):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(3)
    flat = _rn(gen, 1 + 2 * 4 * 80 * 64)
    q = flat[1:].view(2, 4, 80, 64)  # starts 2 bytes past an aligned address
    k = _rn(gen, 2, 4, 80, 64)
    ro = prefill._prefill_plain(q.float(), k.float(), k.float(), 64 ** -0.5,
                                -1, 0, 0.0, False)
    # bf16 at head_dim 64: the default is the bound engine; False is kernel 1
    for mode, kernel in ((None, "bound"), (False, "prefill")):
        _build.reset_launches()
        o = prefill.prefill_attention(q, k, k, causal=True, bound_softmax=mode)
        assert dict(_build.launches) == {kernel: 1}
        assert (o.float() - ro).abs().max() < 2e-2


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,causal,window,softcap,dtype", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 32, 8, 128, True, (-1, -1), 0.0, BF),
    ([100, 37, 300], [130, 64, 200], 8, 2, 128, False, (128, 64), 0.0, BF),
    ([30, 5], [10, 0], 4, 2, 64, True, (3, -1), 0.0, HF),   # dead rows
    ([65, 1, 64], [65, 1, 64], 4, 4, 64, True, (-1, -1), 30.0, BF),
    ([100, 37, 300], [130, 64, 200], 8, 4, 256, False, (127, 32), 0.0, BF),  # d 256
    ([64, 130, 77], [64, 130, 77], 8, 2, 128, True, (-1, -1), 0.0, HF),  # last 77 rows
    ([50, 70], [0, 70], 4, 2, 128, True, (-1, -1), 0.0, BF),   # sq > 0, sk == 0
    ([70, 50], [70, 0], 8, 8, 256, True, (-1, -1), 0.0, HF),   # the last one
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
    assert torch.all(o[torch.isneginf(lse).t()] == 0)  # rows that see no key


@pytest.mark.parametrize("n_seq,s,hq,hkv,d", [(8, 512, 32, 8, 128), (4, 2048, 8, 4, 256)])
def test_varlen_equals_prefill_bit_for_bit(dev, n_seq, s, hq, hkv, d):
    """Equal lengths: kernel 7 runs kernel 1's code over the same tiles in
    the same order, so O and LSE agree bit for bit."""
    from mfa_tpu_torch.kernels import prefill, varlen

    gen = torch.Generator(device=dev).manual_seed(19)
    q = _rn(gen, n_seq * s, hq, d)
    k, v = _rn(gen, n_seq * s, hkv, d), _rn(gen, n_seq * s, hkv, d)
    cu = torch.arange(0, n_seq * s + 1, s, device=dev, dtype=torch.int32)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, s, s, causal=True, return_lse=True)

    def batched(t):  # [n * s, h, d] -> [n, h, s, d]
        return t.view(n_seq, s, t.shape[1], d).transpose(1, 2).contiguous()

    o1, l1 = prefill.prefill_attention(batched(q), batched(k), batched(v), causal=True,
                                       return_lse=True, bound_softmax=False)
    assert torch.equal(batched(o), o1)
    assert torch.equal(lse.view(hq, n_seq, s).transpose(0, 1), l1)


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


@pytest.mark.parametrize(
    "hq,hkv,page,d,quant,dtype,q_start,sq,lens,q_lens,window", [
        (8, 8, 64, 128, True, BF, [0, 100], 200, [200, 300], None, (-1, -1)),  # group 1
        (32, 4, 16, 64, True, BF, [16, 0, 50], 150, [166, 90, 200], None,
         (-1, -1)),                                                    # group 8, int8 pages of 16
        (16, 4, 16, 128, True, HF, [0, 40], 129, [129, 169], None, (33, -1)),  # int8 pages of 16
        (16, 4, 32, 128, False, BF, [0, 64, 10], 256, [256, 64, 10], [256, 0, 0],
         (-1, -1)),                                                    # q_lens 0: dead blocks
        (8, 2, 64, 64, False, HF, [5, 0], 300, [305, 77], [300, 77], (-1, -1)),
    ])
def test_paged_prefill_edges(dev, hq, hkv, page, d, quant, dtype, q_start, sq, lens,
                             q_lens, window):
    """NaN in every key and value row past lens of each sequence's last page,
    in the pages its unmapped table entries clamp to, and (int8) in their
    scales: the kernel never lets them reach O or the LSE. Rows past q_lens,
    and whole blocks of them, come out O = 0, LSE = -inf. Held to the plain
    version on the same pages with those rows zeroed (the plain version
    multiplies them by p = 0, which keeps a NaN)."""
    from mfa_tpu_torch.kernels import _build, paged_prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(6)
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3  # pages 0 and P - 1 are never mapped
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    if quant:
        (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
    else:
        kp, vp, ks, vs = kf, vf, None, None
    table = (torch.randperm(P - 2, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    poisoned = torch.zeros(hkv, P, page, dtype=torch.bool, device=dev)
    poisoned[:, 0] = poisoned[:, P - 1] = True
    for i, n in enumerate(lens):
        last = (n - 1) // page if n else -1
        if n % page:
            poisoned[:, int(table[i, last]), n % page:] = True
        table[i, last + 1:: 2] = -1        # unmapped: clamps to page 0
        table[i, last + 2:: 2] = 10 ** 6   # and to page P - 1
    clean = [t if t is None else t.clone() for t in (kp, vp, ks, vs)]
    for t in (ks, vs) if quant else (kp, vp):
        t[poisoned] = float("nan")
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = (L - qs).clamp(min=0) if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device=dev)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=True,
        window_left=window[0], return_lse=True)
    assert _build.launches["paged_prefill"] == 1
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, *clean[:2], *clean[2:], L, qs, ql, table, d ** -0.5, window[0], 0, 0.0)
    _close(o, lse, ro, rl)
    dead = torch.arange(sq, device=dev)[None] >= ql[:, None]  # [b, sq]
    assert torch.equal(o.float()[dead], torch.zeros_like(o.float()[dead]))
    assert torch.isneginf(lse.transpose(1, 2)[dead]).all()


def test_paged_prefill_refuses_pages_under_8_rows(dev):
    """A page of fewer than 8 rows cannot be one 128-byte-swizzled TMA box:
    the kernel does not take it, and the wrapper says so."""
    from mfa_tpu_torch.kernels import paged_prefill

    q = torch.zeros(1, 4, 4, 64, dtype=BF, device=dev)
    pages = torch.zeros(2, 3, 4, 64, dtype=BF, device=dev)
    lens = torch.tensor([4], dtype=torch.int32, device=dev)
    table = torch.tensor([[1]], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        paged_prefill.paged_prefill_attention(q, pages, pages, lens, lens * 0, table)


# ---------------- image-block prefill (kernels/blockmask.py) ----------------


def _run_ids(b, s, runs, dev):
    """[b, s] int32 run ids: runs[i] lists (start, end) pairs (inclusive)
    of row i; every other token is text (-1)."""
    ids = torch.full((b, s), -1, dtype=torch.int32)
    for i, row in enumerate(runs):
        for gi, (a, z) in enumerate(row):
            ids[i, a:z + 1] = gi
    return ids.to(dev)


@pytest.mark.parametrize("b,hq,hkv,s,d,runs,window,dtype", [
    (2, 8, 4, 300, 256, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]], -1, BF),
    (2, 8, 4, 300, 256, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]], 32, BF),
    (1, 4, 2, 517, 128, [[(0, 3), (100, 355)]], 64, HF),  # run across 4 tiles
    (2, 4, 4, 129, 64, [[(60, 70)], []], 16, BF),          # window cuts the run
    (3, 8, 1, 200, 128, [[], [], [(0, 199)]], -1, BF),     # whole prompt one run
    (1, 8, 4, 100, 256, [[(5, 9), (20, 27), (40, 41)]], 7, HF),
    (2, 8, 4, 300, 128, [[(10, 80), (81, 200)], [(0, 299)]], 50, BF),  # adjacent runs
])
def test_image_block_kernel(dev, b, hq, hkv, s, d, runs, window, dtype):
    from mfa_tpu_torch.kernels import _build, blockmask

    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (_rn(gen, b, hq, s, d, dtype=dtype), _rn(gen, b, hkv, s, d, dtype=dtype),
               _rn(gen, b, hkv, s, d, dtype=dtype))
    ids = _run_ids(b, s, runs, dev)
    _build.reset_launches()
    o = blockmask.image_block_prefill(q, k, v, ids, window_left=window)
    assert dict(_build.launches) == {"blockmask": 1}
    ref = blockmask._image_block_plain(q.float(), k.float(), v.float(), ids,
                                       d ** -0.5, window)
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref).abs().max() < 2e-2


@pytest.mark.parametrize("d", [64, 128, 256])
def test_image_block_without_images_is_causal_prefill(dev, d):
    """With no image, kernel 9 runs kernel 1's code over the same tiles in
    the same order: the same bits."""
    from mfa_tpu_torch.kernels import blockmask, prefill

    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v = _rn(gen, 2, 8, 333, d), _rn(gen, 2, 4, 333, d), _rn(gen, 2, 4, 333, d)
    ids = torch.full((2, 333), -1, dtype=torch.int32, device=dev)
    for wl in (-1, 100):
        a = blockmask.image_block_prefill(q, k, v, ids, window_left=wl)
        r = prefill.prefill_attention(q, k, v, causal=True, window_size=(wl, -1),
                                      bound_softmax=False)
        assert torch.equal(a, r), (d, wl)


def test_image_block_visits_only_its_tiles(dev):
    """KV tiles past every run end of a q tile are never read: NaN there
    leaves the rows before them finite (the wrapper's kv_last bound)."""
    from mfa_tpu_torch.kernels import blockmask

    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = _rn(gen, 1, 4, 512, 128), _rn(gen, 1, 2, 512, 128), _rn(gen, 1, 2, 512, 128)
    k[:, :, 384:] = float("nan")
    v[:, :, 384:] = float("nan")
    ids = _run_ids(1, 512, [[(100, 140)]], dev)
    o = blockmask.image_block_prefill(q, k, v, ids)
    assert torch.isfinite(o[:, :, :384].float()).all()


# ---------------- backward kernels (kernels/backward.py) ----------------


def _bwd_close(got, ref, what):
    """Stated limits: max |a - r| <= 2e-2 max |r| and mean |a - r| <= 2e-2
    mean |r| (P and dS round to bf16/fp16 before their products, and the
    fused kernel's dQ additions across blocks change the summation
    order)."""
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
    (1, 32, 8, 2048, 2048, 128, True, (-1, -1), 0.0, BF),  # the train shape at b1
    (1, 32, 4, 512, 512, 128, True, (-1, -1), 0.0, BF),    # a group of 8
    (1, 8, 2, 2049, 2049, 128, True, (-1, -1), 0.0, BF),   # ragged tails
    (1, 8, 2, 200, 1000, 128, False, (32, 0), 0.0, BF),    # key tiles no row sees
    (2, 16, 2, 333, 333, 64, False, (-1, -1), 0.0, HF),    # d 64, group 8
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
    args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (
        d ** -0.5, window[0], 0 if causal else window[1], softcap)
    dkv1, dkv2 = backward._launch_dkv(*args), backward._launch_dkv(*args)
    assert all(torch.equal(a, b_) for a, b_ in zip(dkv1, dkv2))  # kernel 12 alone
    assert all(g.dtype == dtype for g in fused + split)
    _bwd_close(fused, ref, "fused")
    _bwd_close(split, ref, "split")
    _bwd_close(fused, split, "fused vs split")
    again = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(split, again))  # deterministic
    dead = torch.isneginf(lse)
    assert torch.all(fused[0][dead] == 0) and torch.all(split[0][dead] == 0)
    if (causal or window[1] == 0) and sk > sq:  # keys no row sees: zero gradients
        assert torch.all(fused[1][:, :, sq + 1:] == 0) and torch.all(fused[2][:, :, sq + 1:] == 0)


@pytest.mark.parametrize("n,n0", [(64, 0), (32, 0), (32, 32)])
def test_wgmma_transposed_operands(dev, n, n0):
    """The fused backward's dQ product alone: both operands MN-major in
    shared memory (the transposed-A SS wgmma), against torch.matmul."""
    import ctypes

    from mfa_tpu_torch.kernels import _build

    gen = torch.Generator(device=dev).manual_seed(20)
    a, b = _rn(gen, 64, 64), _rn(gen, 64, 64)
    d = torch.empty((64, n), dtype=torch.float32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("backward", "mfa_wgmma_ss_t_check", [P, P, P, I, I, P])
    _build.check("backward", fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, n0,
                                _build.stream_of(a)))
    torch.cuda.synchronize()
    ref = a.float().t() @ b.float()[:, n0:n0 + n]
    assert (d - ref).abs().max() < 1e-3


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,causal,window,softcap,dtype", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 8, 2, 128, True, (-1, -1), 0.0, BF),
    ([100, 37, 300], [130, 64, 200], 8, 2, 128, False, (128, 64), 0.0, BF),
    ([30, 5], [10, 0], 4, 2, 64, True, (3, -1), 0.0, HF),   # dead rows
    ([65, 1, 64], [65, 1, 64], 4, 4, 64, True, (-1, -1), 30.0, BF),
    # sequences straddling 64-row boxes, a zero-length one, a group of 8
    ([65, 1, 127, 0, 200], [65, 1, 127, 0, 200], 32, 4, 128, True, (48, 0), 0.0, BF),
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


@pytest.mark.parametrize("n_seq,s,hq,hkv,d,window", [
    (8, 512, 32, 8, 128, (-1, 0)),
    (3, 300, 8, 2, 64, (-1, 0)),      # boxes straddle the sequences
    (4, 200, 32, 4, 128, (48, 0)),
])
def test_varlen_backward_equals_dense_bit_for_bit(dev, n_seq, s, hq, hkv, d, window):
    """Equal lengths: kernel 14 runs kernels 12 and 13's code over the same
    tiles in the same order (only the addressing differs), so dQ, dK and
    dV agree bit for bit with the split on the same data batched."""
    from mfa_tpu_torch.kernels import backward, varlen

    gen = torch.Generator(device=dev).manual_seed(21)
    q, do = _rn(gen, n_seq * s, hq, d), _rn(gen, n_seq * s, hq, d)
    k, v = _rn(gen, n_seq * s, hkv, d), _rn(gen, n_seq * s, hkv, d)
    cu = torch.arange(0, n_seq * s + 1, s, device=dev, dtype=torch.int32)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, s, s, window_size=window,
                                     return_lse=True)
    qp, kp, vp, dop, lsep, delta = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu, cu)
    tail = (d ** -0.5, window[0], window[1], 0.0)
    dk, dv = backward._launch_varlen_dkv(qp, kp, vp, dop, lsep, delta, cu, cu, s, *tail)
    dq = backward._launch_varlen_dq(qp, kp, vp, dop, lsep, delta, cu, cu, s, *tail)

    def batched(t):  # [n * s, h, d] -> [n, h, s, d]
        return t.view(n_seq, s, t.shape[1], d).transpose(1, 2).contiguous()

    def rows(t):  # [h, n * s] -> [n, h, s]
        return t.view(t.shape[0], n_seq, s).transpose(0, 1).contiguous()

    dense = (batched(q), batched(k), batched(v), batched(do), rows(lsep), rows(delta))
    dk1, dv1 = backward._launch_dkv(*dense, *tail)
    dq1 = backward._launch_dq(*dense, *tail)
    assert torch.equal(batched(dq), dq1)
    assert torch.equal(batched(dk), dk1) and torch.equal(batched(dv), dv1)


@pytest.mark.parametrize("packed", [False, True])
def test_split_dq_stores_every_row(dev, packed):
    """The split's dQ launch into memory the caching allocator has just
    freed after filling it with NaN: every row is stored, and rows that
    see no key (a window past a short kv, a sequence with no key: whole
    blocks with no live key tile) come out exactly 0."""
    from mfa_tpu_torch.kernels import backward, prefill, varlen

    gen = torch.Generator(device=dev).manual_seed(22)
    wl, scale = 4, 64 ** -0.5
    if packed:
        lens_q, lens_k = [30, 5, 300], [10, 0, 8]
        q, do = _rn(gen, sum(lens_q), 4, 64), _rn(gen, sum(lens_q), 4, 64)
        k, v = _rn(gen, sum(lens_k), 2, 64), _rn(gen, sum(lens_k), 2, 64)
        cu_q = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
        cu_k = torch.tensor([0] + lens_k, device=dev).cumsum(0).int()
        o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lens_q), max(lens_k),
                                         window_size=(wl, 0), return_lse=True)
        args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu_q, cu_k)
        torch.full_like(q, float("nan"))  # freed at once, NaN-filled
        dq = backward._launch_varlen_dq(*args, cu_q, cu_k, max(lens_q), scale, wl, 0, 0.0)
        ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), cu_q, cu_k, scale, wl, 0, 0.0)
        dead = torch.isneginf(lse).t()  # [total_q, hq]
    else:
        q, k, v, o, lse, do = _bwd_inputs(gen, 2, 4, 2, 300, 8, 64, True, (wl, -1), 0.0, BF)
        args = backward._dense_cuda_inputs(q, k, v, o, lse, do)
        torch.full_like(q, float("nan"))
        dq = backward._launch_dq(*args, scale, wl, 0, 0.0)
        ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                  do.float(), scale, wl, 0, 0.0)
        dead = torch.isneginf(lse)  # [b, hq, sq]
    assert int(dead.sum()) > 0
    assert torch.all(dq[dead] == 0)
    _bwd_close((dq,), ref[:1], "split dq")


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
            assert dict(_build.launches) == {"flagged": 1, "repair": 1, "varlen": 1,
                                             "bwd_fused": 1, "varlen_bwd_dkv": 1,
                                             "varlen_bwd_dq": 1}
    _bwd_close(grads["cuda"][:3], [g.to(dev) for g in grads["cpu"][:3]], "func")
    _bwd_close(grads["cuda"][3:], [g.to(dev) for g in grads["cpu"][3:]], "varlen")
    with pytest.raises(RuntimeError, match="autodiff"):
        prefill.prefill_attention(q.requires_grad_(), k, v, causal=True)


# ---------------- zero-shift prefill engines (csrc/bound.cu) ----------------


def _zs_inputs(gen, b, hq, hkv, sq, sk, d, kind):
    """bf16 q, k, v: benign N(0, 1); 'overflow' std 1e3; 'flush' N(0, 1)
    with q + 40 and k - 40, every score near -18100 (tests/test_bound_repair.py)."""
    q, k, v = (_rn(gen, b, hq, sq, d).float(), _rn(gen, b, hkv, sk, d).float(),
               _rn(gen, b, hkv, sk, d))
    if kind == "overflow":
        q, k = q * 1e3, k * 1e3
    elif kind == "flush":
        q, k = q + 40.0, k - 40.0
    return q.to(BF), k.to(BF), v


def _zs_close(o, ref, lse=None, ref_lse=None, tol=2e-2):
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref.float()).abs().max() < tol
    if lse is not None:
        assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
        fin = torch.isfinite(ref_lse)
        rel = (lse[fin] - ref_lse[fin]).abs() / ref_lse[fin].abs().clamp(min=1.0)
        assert rel.max() < 1e-3


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (16, 32, 8, 256, 256, 128, True, (-1, -1)),  # the 8B wave (phase 2)
    (4, 8, 4, 2048, 2048, 256, True, (1023, -1)),  # the Gemma3 text wave
    (2, 8, 2, 100, 130, 128, False, (9, 4)),
    (1, 16, 2, 200, 50, 256, False, (10, -1)),  # dead rows past sk: no flag
    (2, 4, 4, 300, 300, 128, True, (127, -1)),
])
def test_flagged_repair_kernels(dev, b, hq, hkv, sq, sk, d, causal, window):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v = _zs_inputs(gen, b, hq, hkv, sq, sk, d, "benign")
    _build.reset_launches()
    o, lse, flags = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                              return_lse=True, bound_softmax="flag_debug")
    assert dict(_build.launches) == {"flagged": 1, "repair": 1}
    assert flags.shape == (b, hq, (sq + 63) // 64) and int(flags.sum()) == 0
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5,
                                    window[0], 0 if causal else window[1], 0.0, True)
    _zs_close(o, ro, lse, rl)
    again = prefill.prefill_attention(q, k, v, causal=causal, window_size=window)
    assert torch.equal(again, o)  # the default engine is the same launch pair


@pytest.mark.parametrize("kind,d", [("overflow", 128), ("flush", 128), ("overflow", 256)])
def test_flagged_repair_fixes_poisoned_tiles(dev, kind, d):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = _zs_inputs(gen, 2, 4, 2, 256, 256, d, kind)
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, -1, 0,
                                    0.0, True)
    o, lse, flags = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                              bound_softmax="flag_debug")
    assert int(flags.sum()) > 0
    _zs_close(o, ro, lse, rl)
    raw = prefill.prefill_attention(q, k, v, causal=True, bound_softmax="unchecked")
    assert not bool(((raw.float() - ro).abs() < 2e-2).all())  # the repair did the work
    _build.reset_launches()
    only = prefill.prefill_attention(q, k, v, causal=True, bound_softmax="flag_only")
    assert dict(_build.launches) == {"flagged": 1}
    assert not bool(((only.float() - ro).abs() < 2e-2).all())


@pytest.mark.parametrize("d,mode,kind", [
    (128, "prepass", "overflow"), (64, None, "overflow"), (64, None, "benign"),
    (256, "prepass", "flush"), (128, "unchecked", "benign"), (256, "unchecked", "benign"),
])
def test_bound_kernel(dev, d, mode, kind):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = _zs_inputs(gen, 2, 8, 2, 300, 300, d, kind)
    _build.reset_launches()
    o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                       bound_softmax=mode)
    assert dict(_build.launches) == {"bound": 1}
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, -1, 0,
                                    0.0, True)
    _zs_close(o, ro, lse, rl)
    bits = prefill._risky_bits(q, k, d ** -0.5 * prefill._LOG2E)
    assert bool(bits.all()) if kind != "benign" else not bool(bits.any())


# the edges of the wgmma + TMA tile (csrc/flash_fwd_sm90.cuh): 128-row
# blocks of two 64-row warpgroups, 128-key tiles (64 at d 256), TMA rows
# past the end read as zeros
_SM90_EDGES = [
    # b, hq, hkv, sq, sk, d, causal, window, softcap, dtype
    (2, 8, 8, 100, 130, 128, True, (-1, -1), 0.0, BF),    # group 1
    (1, 8, 4, 333, 333, 128, True, (127, -1), 0.0, BF),   # group 2
    (2, 8, 2, 333, 200, 64, False, (9, 4), 0.0, BF),      # group 4, sq != sk
    (1, 16, 2, 130, 333, 256, False, (-1, -1), 0.0, BF),  # group 8
    (1, 8, 4, 333, 333, 256, True, (127, -1), 0.0, BF),
    (2, 4, 2, 100, 130, 256, False, (9, 4), 0.0, BF),
    (1, 8, 8, 333, 333, 64, True, (-1, -1), 0.0, HF),
    (2, 8, 2, 200, 333, 128, False, (9, 4), 0.0, HF),
    (1, 8, 1, 257, 257, 256, True, (-1, -1), 0.0, HF),
    (1, 8, 4, 333, 333, 128, True, (-1, -1), 50.0, BF),   # softcap
    (1, 4, 2, 130, 100, 256, False, (127, -1), 30.0, HF),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap,dtype", _SM90_EDGES)
def test_sm90_tile_edges(dev, b, hq, hkv, sq, sk, d, causal, window, softcap, dtype):
    """Kernel 1 (any head_dim, bf16/fp16, softcap) and, in bf16 without a
    softcap, the flagged + repair pair (d 128/256) and the bound kernel
    against the plain version; the repair of every tile equals kernel 1."""
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (_rn(gen, b, hq, sq, d, dtype=dtype), _rn(gen, b, hkv, sk, d, dtype=dtype),
               _rn(gen, b, hkv, sk, d, dtype=dtype))
    wl, wr = window[0], 0 if causal else window[1]
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, wl, wr,
                                    softcap, True)
    _build.reset_launches()
    o1, l1 = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                       logit_softcap=softcap, return_lse=True,
                                       bound_softmax=False)
    assert dict(_build.launches) == {"prefill": 1}
    _close(o1, l1, ro, rl)
    if dtype != BF or softcap:
        return
    if d % 128 == 0:
        o, lse, flags = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                                  return_lse=True, bound_softmax="flag_debug")
        assert flags.shape == (b, hq, (sq + 63) // 64) and int(flags.sum()) == 0
        _zs_close(o, ro, lse, rl)
        # every tile repaired: the repair's rows are kernel 1's, bit for bit
        out, lse_r = o.clone(), lse.clone()
        prefill._zs_launch("repair", q, k, v, out, lse_r, torch.ones_like(flags),
                           d ** -0.5, wl, wr)
        assert torch.equal(out, o1) and torch.equal(lse_r, l1)
    for mode in ("prepass", "unchecked"):
        o, lse = prefill.prefill_attention(q, k, v, causal=causal, window_size=window,
                                           return_lse=True, bound_softmax=mode)
        _zs_close(o, ro, lse, rl)


def _split_block_inputs(gen, d):
    """One 128-row block per head whose second 64-row tile has q rows scaled
    by 1e3 (the zero-shift exponent overflows there) and whose first tile is
    benign."""
    b, hq, hkv, s = 2, 4, 2, 200
    q, k, v = _rn(gen, b, hq, s, d).float(), _rn(gen, b, hkv, s, d), _rn(gen, b, hkv, s, d)
    q[:, :, 64:128] *= 1e3
    return q.to(BF), k, v


@pytest.mark.parametrize("d", [128, 256])
def test_flags_per_warpgroup(dev, d):
    """The block's two 64-row tiles differ: exactly the adversarial tile is
    flagged and repaired, to kernel 1's bits; the benign tile keeps the
    zero-shift output."""
    from mfa_tpu_torch.kernels import prefill

    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = _split_block_inputs(gen, d)
    o, lse, flags = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                              bound_softmax="flag_debug")
    want = torch.zeros_like(flags)
    want[:, :, 1] = 1
    assert torch.equal(flags, want)
    o1, l1 = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                       bound_softmax=False)
    zs = prefill.prefill_attention(q, k, v, causal=True, bound_softmax="flag_only")
    assert torch.equal(o[:, :, 64:128], o1[:, :, 64:128])
    assert torch.equal(lse[:, :, 64:128], l1[:, :, 64:128])
    rest = torch.cat([o[:, :, :64], o[:, :, 128:]], 2)
    assert torch.equal(rest, torch.cat([zs[:, :, :64], zs[:, :, 128:]], 2))
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, -1, 0,
                                    0.0, True)
    _zs_close(o, ro, lse, rl)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_risky_bit_per_warpgroup(dev, d):
    """A risky bit on one 64-row tile of a block: that warpgroup runs the
    classic softmax, its neighbour the zero-shift one, on the same ring."""
    from mfa_tpu_torch.kernels import prefill

    gen = torch.Generator(device=dev).manual_seed(18)
    q, k, v = _split_block_inputs(gen, d)
    bits = prefill._risky_bits(q, k, d ** -0.5 * prefill._LOG2E)
    want = torch.zeros_like(bits)
    want[:, :, 1] = 1
    assert torch.equal(bits, want)
    o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                       bound_softmax="prepass")
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, -1, 0,
                                    0.0, True)
    _zs_close(o, ro, lse, rl)
    raw = prefill.prefill_attention(q, k, v, causal=True, bound_softmax="unchecked")
    assert not bool(((raw[:, :, 64:128].float() - ro[:, :, 64:128]).abs() < 2e-2).all())


def test_fp16_takes_kernel_1(dev):
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (_rn(gen, 1, 2, 256, 128, dtype=HF) for _ in range(3))
    k[:, :, 0] = 2.0  # a strong key: every row's logit against it is large
    q = (q.float() * 0.1 + 1.0).to(HF)
    _build.reset_launches()
    o = prefill.prefill_attention(q, k, v, causal=True)
    assert dict(_build.launches) == {"prefill": 1}
    ro = prefill._prefill_plain(q.float(), k.float(), v.float(), 128 ** -0.5, -1, 0,
                                0.0, False)
    _zs_close(o, ro)
    with pytest.raises(NotImplementedError, match="fp16"):
        prefill.prefill_attention(q, k, v, causal=True, bound_softmax="unchecked")


# ---------------- int8 weight matmul (csrc/wmatmul.cu) ----------------


@pytest.mark.parametrize("m,K,N,dtype,out_f32", [
    (16, 4096, 4096, BF, False),    # decode: wq, split K
    (16, 4096, 1024, BF, False),    # wk: 8 output tiles, split K 16 ways
    (16, 14336, 4096, BF, False),   # w_down
    (16, 4096, 128256, BF, False),  # lm_head: no split
    (3601, 4096, 14336, BF, False),  # a prefill wave at w_gate
    (130, 384, 272, HF, False),     # ragged m, N % 128 != 0, fp16
    (3, 80, 48, BF, True),          # K % 64 != 0, fp32 out
    (1, 4096, 4096, BF, False),     # one row: 4 K splits at 16 rows a block
    (17, 4096, 4096, HF, True),     # 32 rows a block, fp16 x, fp32 out
    (255, 14336, 4096, BF, False),  # 128 rows a block, K 14336, 2 splits
    (256, 4096, 128, BF, True),     # 256 rows a block, one output tile: 8 splits
    (3601, 4096, 14336, HF, True),  # the wave in fp16 x, fp32 out
    (64, 256, 64, BF, False),       # N narrower than one tile
    (40, 14336, 1024, HF, False),   # 64 rows a block, K 14336, 8 splits
])
def test_int8_matmul_kernel(dev, m, K, N, dtype, out_f32):
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(16)
    x = _rn(gen, m, K, dtype=dtype)
    w = quantize_weight(torch.randn(K, N, generator=gen, device=dev) * K ** -0.5)
    out_dtype = torch.float32 if out_f32 else dtype
    _build.reset_launches()
    out = wmatmul.int8_matmul(x, w.qw, w.scale, out_dtype=out_dtype)
    assert dict(_build.launches) == {"wmatmul": 1}
    # the split reduction runs in a fixed order: the same bits every call
    assert torch.equal(out, wmatmul.int8_matmul(x, w.qw, w.scale, out_dtype=out_dtype))
    assert out.dtype == out_dtype and out.shape == (m, N)
    ref = wmatmul._int8_matmul_plain(x.float(), w.qw, w.scale, torch.float32)
    d = (out.float() - ref).abs()
    # one rounding of the fp32 accumulator: <= 2^-8 of the largest output
    assert torch.isfinite(out.float()).all()
    assert float(d.max()) <= 2 ** -8 * float(ref.abs().max()) + 1e-6
    with pytest.raises(NotImplementedError):
        wmatmul.int8_matmul(x[:, :8], w.qw[:8], w.scale)  # K % 16 != 0


def test_quantized_model_on_the_card(dev):
    """A 2-layer int8-weight Llama: the card's logits against the CPU's
    (plain versions) from the same weights; every projection is kernel 10."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab=512, dim=256, layers=2, heads=4, kv_heads=2,
                                 ffn=512, dtype=BF)
    p = llama.init_params(cfg, seed=1, device="cuda", quantize="int8")
    toks = torch.randint(0, 512, (2, 70), device=dev)
    _build.reset_launches()
    with torch.no_grad():
        a = llama.forward(p, toks, cfg)
    assert _build.launches["wmatmul"] == 7 * 2 + 1
    cpu = dict(layers=[{k_: v_.to("cpu") for k_, v_ in lp.items()} for lp in p["layers"]],
               **{k_: p[k_].to("cpu") for k_ in ("embed", "final_norm", "lm_head")})
    r = llama.forward(cpu, toks.cpu(), cfg)
    d = (a.cpu() - r).abs()
    assert float(d.max()) < 0.25 and float(d.mean()) < 0.02
