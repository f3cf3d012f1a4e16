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


def _pages(kf, vf, quant):
    """Float pages -> (k_pages, v_pages, k_scales, v_scales) in the format
    `quant` names (None: the float pages; int4 packed to feature pairs)."""
    from mfa_tpu_torch.kernels.quant import pack_int4, quantize_rows

    if quant is None:
        return kf, vf, None, None
    (kp, ks), (vp, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
    if quant == "int4":
        kp, vp = pack_int4(kp), pack_int4(vp)
    return kp, vp, ks, vs


def _poison(pages, scales, quant, where):
    """Rows `where` ([hkv, P, page] bool) hold what a stale or unmapped row
    may hold: NaN in 16-bit pages, NaN scales in quantized ones, and the
    e4m3 NaN code 0x7F in fp8 payloads."""
    if quant is None:
        pages[where] = float("nan")
        return
    scales[where] = float("nan")
    if quant == "fp8":
        pages.view(torch.uint8)[where] = 0x7F


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
    # Gemma2-9B's heads: 16 q / 8 kv of 256, softcap 50, window 4095 and none
    (1, 16, 8, 300, 300, 256, True, (4095, -1), 50.0, BF),
    (2, 16, 8, 200, 200, 256, True, (-1, -1), 50.0, BF),
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
        assert dict(_build.launches) == {"decode": 1}  # the split merge is inside it
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


def _merge_bits_equal(o, lse, partials, dtype):
    """The one launch's O and LSE against the two-launch design's merge
    arithmetic over the launch's own split partials (decode._combine_exact):
    bit for bit. o [b, (q_span,) hq, d], lse [b, (q_span,) hq]."""
    from mfa_tpu_torch.kernels import decode

    o_part, lse_part = partials
    b, hkv, _, rows, d = o_part.shape
    hq = o.shape[-2]
    span = rows * hkv // hq
    eo, el = decode._combine_exact(o_part, lse_part, dtype)
    eo = eo.reshape(b, hkv, span, hq // hkv, d).transpose(1, 2).reshape(b, span, hq, d)
    el = el.reshape(b, hkv, span, hq // hkv).transpose(1, 2).reshape(b, span, hq)
    assert torch.equal(o.reshape(eo.shape), eo)
    assert torch.equal(lse.reshape(el.shape), el)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("ns", [1, 2, 3, 8, 15, 30])
def test_decode_split_merge_in_one_launch(dev, ns, dtype):
    """Kernel 5 at b2 hq32 hkv8 S30720 d128 (480 tiles: each split count
    here divides them), the second length inside the first split (the
    other splits of its row hold nothing): one launch at every split
    count; O and the
    LSE within the plain limits of combine_splits over the plain
    partials, and, past one split, bit-equal to the two-launch merge over
    the launch's own partials."""
    from mfa_tpu_torch.kernels import _build, decode

    gen = torch.Generator(device=dev).manual_seed(ns)
    b, hq, hkv, s, d = 2, 32, 8, 30720, 128
    q, k, v = (_rn(gen, b, hq, d, dtype=dtype), _rn(gen, b, hkv, s, d, dtype=dtype),
               _rn(gen, b, hkv, s, d, dtype=dtype))
    L = torch.tensor([s - 5, 100], dtype=torch.int32, device=dev)
    n, tps = decode.split_layout(s, ns)
    assert n == ns
    partials = (torch.empty(b, hkv, n, hq // hkv, d, device=dev),
                torch.empty(b, hkv, n, hq // hkv, device=dev))
    _build.reset_launches()
    o, lse = decode._decode_cuda(q, k, v, L, d ** -0.5, n, tps, -1, 0.0,
                                 partials=partials)
    assert dict(_build.launches) == {_build.launch_key("decode", dtype): 1}
    po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L, d ** -0.5,
                                           n, tps, -1, 0.0)
    ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
    (_close if dtype == BF else _close32)(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
    if n > 1:
        _merge_bits_equal(o, lse, partials, dtype)


# tag: span, hq, hkv, d, lens, window, sinks, splits (a longest length of
# 7679: 120 pages of 64, 120 tiles, which each split count here divides)
_MERGE_CASES = {
    **{f"group 4, {n} splits": (1, 32, 8, 128, [7679, 700, 65, 1], -1, 0, n)
       for n in (2, 3, 8, 15, 30)},
    "span 4 (16-row blocks)": (4, 32, 8, 128, [7679, 700], -1, 0, 3),
    "group 16 (16-row blocks)": (1, 32, 2, 128, [7679, 300], -1, 0, 8),
    "sinks, a window emptying splits 1-5": (1, 32, 8, 128, [7679, 5000], 1000, 4, 8),
    "Gemma3-4B heads, d 256": (1, 8, 4, 256, [2000, 300, 1300], 1023, 0, 3),
}


@pytest.mark.parametrize("quant,dtype", [(None, BF), ("int8", BF), ("fp8", BF),
                                         ("int4", BF), (None, torch.float32),
                                         ("int8", torch.float32)])
@pytest.mark.parametrize("tag", list(_MERGE_CASES))
def test_paged_split_merge_in_one_launch(dev, monkeypatch, tag, quant, dtype):
    """Kernel 6 through a forced split count (pages of 64): one launch;
    O and the LSE within the plain limits of the plain split route
    (combine_splits over the plain partials) and bit-equal to the
    two-launch merge over the launch's own partials. Splits past a
    length, and splits a window empties (the sinks sit in split 0), hold
    nothing and must still take their ticket."""
    from mfa_tpu_torch.kernels import _build, decode, paged

    span, hq, hkv, d, lens, window, sinks, ns = _MERGE_CASES[tag]
    monkeypatch.setattr(paged, "split_plan",
                        lambda b, hkv, pps, page: decode.split_layout(pps * page, ns))
    gen = torch.Generator(device=dev).manual_seed(ns + d)
    page = 64
    b, pps = len(lens), max(lens) // page + 1
    P = b * pps + 1
    q = _rn(gen, b, span, hq, d, dtype=dtype) if span > 1 else _rn(gen, b, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    n, tps = decode.split_layout(pps * page, ns)
    assert n == ns
    rows = span * (hq // hkv)
    partials = (torch.empty(b, hkv, n, rows, d, device=dev),
                torch.empty(b, hkv, n, rows, device=dev))
    args = (L, table, d ** -0.5, window, 0.0, 0)
    _build.reset_launches()
    o, lse = paged._paged_cuda(q, kp, vp, ks, vs, *args, quant, sinks, None,
                               partials=partials)
    assert dict(_build.launches) == {paged.launch_name("paged", quant, span, dtype): 1}
    q_ref = q if dtype == torch.float32 else q.float()
    ro, rl = paged._paged_split_plain(q_ref, kp, vp, ks, vs, *args, num_splits=n,
                                      quant_dtype=quant, sinks=sinks)
    if dtype == BF:
        _close(o, lse, ro, rl)
    else:
        (_close32 if quant is None else _close_quant32)(o, lse, ro, rl)
    _merge_bits_equal(o, lse, partials, dtype)


_GEMMA3_LENS = [300 + (1700 * i) // 9 for i in range(10)]  # 300-2000


@pytest.mark.parametrize("hq,hkv,page,d,quant,dtype,pos_offset,window,softcap,lens", [
    (32, 8, 64, 128, "int8", BF, 1, -1, 0.0, None),
    (32, 8, 64, 128, None, BF, 1, 50, 0.0, None),
    (8, 8, 16, 64, "int8", HF, 0, -1, 0.0, None),       # fp16 q over int8 pages
    (8, 1, 8, 64, None, HF, 0, 20, 0.0, None),       # pages smaller than a tile
    (16, 2, 32, 128, "int8", BF, 1, 1, 0.0, None),
    (32, 8, 64, 128, "int8", BF, 1, -1, 15.0, None),
    (8, 4, 64, 256, "int8", BF, 1, 50, 0.0, None),      # head_dim 256, group 2 (Gemma3)
    (8, 4, 64, 256, None, BF, 1, 50, 0.0, None),
    (8, 4, 64, 256, "int8", HF, 1, -1, 0.0, None),
    (16, 2, 32, 256, None, HF, 0, -1, 0.0, None),    # group 8
    (32, 8, 128, 128, "int8", BF, 1, -1, 0.0, None),    # pages past a tile: 64-row boxes
    (8, 4, 128, 64, None, BF, 1, 100, 0.0, None),
    # more than one split: Gemma3-4B's decode (b10 hkv4: 40 blocks), b1
    (8, 4, 64, 256, "int8", BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (8, 4, 64, 256, None, BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (32, 8, 64, 128, "int8", BF, 1, -1, 0.0, [8192]),
    # fp8 (e4m3) and int4 pages: int4 rows of d / 2 bytes (32 B at d 64:
    # unswizzled; 64 B at d 128; 128 B at d 256)
    (32, 8, 64, 128, "fp8", BF, 1, -1, 0.0, None),
    (32, 8, 64, 128, "int4", BF, 1, -1, 0.0, None),
    (8, 8, 16, 64, "fp8", HF, 0, 20, 0.0, None),
    (8, 8, 16, 64, "int4", HF, 0, -1, 0.0, None),
    (16, 2, 32, 128, "fp8", BF, 1, 1, 15.0, None),
    (16, 2, 32, 128, "int4", BF, 1, 40, 15.0, None),
    (8, 4, 128, 64, "int4", BF, 1, 100, 0.0, None),
    (8, 4, 64, 256, "fp8", BF, 1, 50, 0.0, None),
    (8, 4, 64, 256, "int4", HF, 1, -1, 0.0, None),
    (8, 4, 64, 256, "fp8", BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (8, 4, 64, 256, "int4", BF, 1, 1023, 0.0, _GEMMA3_LENS),
    (32, 8, 64, 128, "fp8", BF, 1, -1, 0.0, [8192]),
    (32, 8, 64, 128, "int4", BF, 1, -1, 0.0, [8192]),
    # more than 8 q heads a kv head: the 16-row blocks (group 16, 32)
    (32, 2, 64, 128, "int8", BF, 1, -1, 0.0, None),
    (32, 2, 64, 128, None, BF, 1, 50, 0.0, None),
    (32, 2, 16, 64, "fp8", HF, 0, -1, 15.0, None),
    (32, 1, 64, 256, "int4", BF, 1, -1, 0.0, _GEMMA3_LENS),
    # Gemma2-9B (group 2, d 256, softcap 50, window 4095 and none) and
    # Qwen2-7B (group 7)
    (16, 8, 64, 256, "int8", BF, 1, 4095, 50.0, None),
    (16, 8, 64, 256, None, BF, 1, -1, 50.0, None),
    (28, 4, 64, 128, "int8", BF, 1, -1, 0.0, None),
])
def test_paged_kernel(dev, hq, hkv, page, d, quant, dtype, pos_offset, window,
                      softcap, lens):
    from mfa_tpu_torch.kernels import _build, paged

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
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    splits, _ = paged.split_plan(b, hkv, pps, page)
    if b * hkv < 100:  # the grid does not fill the card: the split route runs
        assert splits > 1
    _build.reset_launches()
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=pos_offset,
                                   logit_softcap=softcap, quant_dtype=quant,
                                   return_lse=True)
    # one launch at any split count: the split merge is inside it
    assert dict(_build.launches) == {paged.launch_name("paged", quant): 1}
    # quantized pages contract in bf16: the kernel rounds fp16 q to bf16 first
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged._paged_plain(q_ref, kp, vp, ks, vs, L, table, d ** -0.5,
                                window, softcap, pos_offset, quant_dtype=quant)
    assert o.dtype == dtype
    _close(o, lse, ro, rl)
    assert (o.float() - ro.float()).abs().mean() < 2e-3
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(o[i] == 0) and torch.isneginf(lse[i]).all()


@pytest.mark.parametrize("quant,page,d,window", [
    ("int8", 64, 128, -1), (None, 64, 128, -1), ("int8", 16, 128, 50),
    (None, 8, 64, -1), ("int8", 32, 256, -1), (None, 128, 256, 70),
    ("fp8", 64, 128, -1), ("fp8", 32, 256, 70), ("fp8", 8, 64, -1),
    ("int4", 16, 128, 50), ("int4", 32, 256, -1), ("int4", 8, 64, -1),
])
def test_paged_kernel_ignores_rows_past_lens(dev, quant, page, d, window):
    """Rows past each length hold NaN (16-bit pages), scales of rows past it
    and of unmapped pages NaN (quantized pages; fp8 payloads there the NaN
    code 0x7F too), and table entries past each length -1 or out of the
    pool: O and LSE stay finite and equal to the plain version on the
    inputs before the poisoning, through every split count."""
    from mfa_tpu_torch.kernels import paged

    gen = torch.Generator(device=dev).manual_seed(7)
    hq, hkv = 8, 2
    lens = [1, 70, 0, 333, 129]
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 2
    q = _rn(gen, b, hq, d)
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    clean = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    poisoned = torch.zeros(hkv, P, page, dtype=torch.bool, device=dev)
    used = torch.zeros(P, dtype=torch.bool, device=dev)
    for i, n in enumerate(lens):
        n_pages = -(-n // page)
        used[table[i, :n_pages].long()] = True
        if n % page:  # rows past the length in the last page
            poisoned[:, int(table[i, n_pages - 1]), n % page:] = True
        table[i, n_pages:] = torch.where(
            torch.arange(pps - n_pages, device=dev) % 2 == 0, -1, 10 ** 6).int()
    poisoned[:, ~used] = True
    _poison(kp, ks, quant, poisoned)
    _poison(vp, vs, quant, poisoned)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=1,
                                   quant_dtype=quant, return_lse=True)
    ro, rl = paged._paged_plain(q.float(), *clean, L, table, d ** -0.5, window, 0.0, 1,
                                quant_dtype=quant)
    _close(o, lse, ro, rl)
    assert torch.isfinite(lse[L > 0]).all()
    assert paged.split_plan(b, hkv, pps, page)[0] > 1


@pytest.mark.parametrize("span,group,d,quant,pos_offset,window,softcap,lens", [
    (2, 4, 128, "int8", 2, -1, 0.0, None),
    (4, 4, 128, None, 4, 50, 0.0, None),
    (3, 4, 64, "fp8", 0, -1, 0.0, None),
    (8, 2, 128, "int4", 8, 20, 0.0, None),
    (4, 8, 128, "int8", 4, -1, 30.0, None),    # 32 rows: two row blocks
    (8, 4, 256, None, 0, 100, 0.0, None),      # 32 rows at d 256
    (8, 4, 256, "int8", 8, -1, 0.0, None),
    (4, 2, 64, "int4", 4, -1, 0.0, None),
    (4, 4, 128, "int8", 4, -1, 0.0, _GEMMA3_LENS),  # the split route
    (3, 8, 256, "fp8", 0, 1023, 0.0, _GEMMA3_LENS),
])
def test_paged_kernel_multiquery(dev, span, group, d, quant, pos_offset, window,
                                 softcap, lens):
    """Kernel 6 on q [b, q_span, hq, d] (launch name "paged_span") against
    its plain version, rows and scales past each length poisoned (NaN,
    0x7F fp8 codes), and with pos_offset 0 each span row against a q_span =
    1 call at lens - (q_span - 1 - si)."""
    from mfa_tpu_torch.kernels import _build, paged

    gen = torch.Generator(device=dev).manual_seed(11)
    hkv, page = 2, 64
    hq = hkv * group
    if lens is None:
        lens = [300, span, page, 383 // page * page - 1, 195]
    b, pps = len(lens), max(lens) // page + 1
    P = b * pps + 1
    q = _rn(gen, b, span, hq, d)
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    clean = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    stale = torch.zeros(hkv, P, page, dtype=torch.bool, device=dev)
    for i, n in enumerate(lens):
        if n % page:
            stale[:, int(table[i, n // page]), n % page:] = True
    _poison(kp, ks, quant, stale)
    _poison(vp, vs, quant, stale)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(window_left=window, pos_offset=pos_offset, logit_softcap=softcap,
              quant_dtype=quant)
    _build.reset_launches()
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks,
                                   v_scales=vs, return_lse=True, **kw)
    assert dict(_build.launches) == {"paged_span": 1}
    assert o.shape == q.shape and lse.shape == (b, span, hq)
    ro, rl = paged._paged_plain(q.float(), *clean, L, table, d ** -0.5, window,
                                softcap, pos_offset, quant_dtype=quant)
    _close(o, lse, ro, rl)
    assert (o.float() - ro.float()).abs().mean() < 2e-3
    if pos_offset == 0:
        for si in range(span):
            eff = (L - (span - 1 - si)).clamp(min=0)
            o1, l1 = paged.paged_attention(q[:, si], kp, vp, eff, table,
                                           k_scales=ks, v_scales=vs,
                                           return_lse=True, **kw)
            _close(o[:, si], lse[:, si], o1, l1)


# pages of every row count: boxes of gcd(page, 64) rows (kernel 8: gcd(page,
# 128)), quantized boxes of fewer than 4 rows by cp.async
ROW_PAGES = [(q, p) for q in (None, "int8", "fp8") for p in (1, 2, 4, 6, 12, 24)] + [
    ("int4", p) for p in (2, 4, 6, 12, 24)]


def _any_rows_pages(gen, hkv, P, page, d, quant, dtype):
    kf = _rn(gen, hkv, P, page, d, dtype=dtype)
    vf = _rn(gen, hkv, P, page, d, dtype=dtype)
    return _pages(kf, vf, quant)


def _any_rows_close(o, lse, ro, rl, quant, dtype):
    if dtype == torch.float32:
        (_close32 if quant is None else _close_quant32)(o, lse, ro, rl)
    else:
        _close(o, lse, ro, rl)
        assert (o.float() - ro.float()).abs().mean() < 2e-3


@pytest.mark.parametrize("span", [1, 4])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quant,page", ROW_PAGES)
def test_paged_kernel_pages_of_any_rows(dev, quant, page, d, dtype, span):
    """Kernel 6 on pages of 1-24 rows, every format, bf16 and fp32 q, q_span
    1 and 4: 3 sink tokens and a window of 37 whose edge falls inside a
    page, rows past each length poisoned (NaN, NaN scales, 0x7F fp8 codes),
    against the plain version on the pages before the poisoning."""
    from mfa_tpu_torch.kernels import _build, paged

    gen = torch.Generator(device=dev).manual_seed(page + d)
    hq, hkv, window, sinks = 8, 2, 37, 3
    lens = [300, 0, 29, 130]
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, span, hq, d, dtype=dtype)
    kp, vp, ks, vs = _any_rows_pages(gen, hkv, P, page, d, quant, dtype)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(window_left=window, pos_offset=span, sink_tokens=sinks,
              quant_dtype=quant)
    q_ref = q if dtype == torch.float32 else q.float()
    ro, rl = paged._paged_plain(q_ref, kp, vp, ks, vs, L, table, d ** -0.5, window,
                                0.0, span, quant, sinks)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    _build.reset_launches()
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   return_lse=True, **kw)
    assert _build.launches[paged.launch_name("paged", quant, span, dtype)] == 1
    _any_rows_close(o, lse, ro, rl, quant, dtype)
    assert torch.all(o[1] == 0) and torch.isneginf(lse[1]).all()


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("quant", [None, "int8", "fp8", "int4"])
def test_paged_kernel_splits_cut_pages(dev, monkeypatch, quant, dtype):
    """Pages of 12 rows through 3 splits of 128 tokens: the boundaries cut
    pages 10 and 21 in two, and each row is read by exactly the split
    that holds it (against the plain split route and the one-pass plain
    version)."""
    from mfa_tpu_torch.kernels import decode, paged

    monkeypatch.setattr(paged, "split_plan",
                        lambda b, hkv, pps, page: decode.split_layout(pps * page, 3))
    gen = torch.Generator(device=dev).manual_seed(12)
    hq, hkv, d, page, pps = 8, 2, 128, 12, 32
    lens = [380, 200, 129, 0]
    b = len(lens)
    P = b * pps + 3
    q = _rn(gen, b, hq, d, dtype=dtype)
    kp, vp, ks, vs = _any_rows_pages(gen, hkv, P, page, d, quant, dtype)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (L, table, d ** -0.5, -1, 0.0, 1)
    q_ref = q if dtype == torch.float32 else q.float()
    ro, rl = paged._paged_plain(q_ref, kp, vp, ks, vs, *args, quant_dtype=quant)
    so, sl = paged._paged_split_plain(q_ref, kp, vp, ks, vs, *args, num_splits=3,
                                      quant_dtype=quant)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   pos_offset=1, quant_dtype=quant, return_lse=True)
    _any_rows_close(o, lse, ro, rl, quant, dtype)
    _any_rows_close(o, lse, so, sl, quant, dtype)


@pytest.mark.parametrize("row_bytes,swizzle,box_rows", [
    (128, 128, 1), (128, 128, 2), (128, 128, 4),  # 16-bit / fp32 chunks, int8 d 128
    (64, 64, 2), (64, 64, 4),                     # int8 d 64, int4 d 128 (kernel 6)
    (128, 0, 1), (64, 0, 2), (32, 0, 4),          # kernel 8's unswizzled staging
])
def test_tma_boxes_under_8_rows(dev, row_bytes, swizzle, box_rows):
    """A tile of 64 rows loaded as boxes of 1, 2 or 4 rows, from every row
    offset 0-7 of the source, lies in shared memory byte for byte as one
    8-row box leaves it: the swizzle XORs address bits 4-6 with bits 7-9
    (64 B: bits 4-5 with 7-8) of the shared-memory address, wherever a box
    starts. A box whose bytes are not a multiple of 128 would start off
    the 128-byte alignment the TMA needs (a fault: 1 row of 64 bytes, 1 or
    2 of 32); the probe refuses those, and the kernels copy such boxes by
    cp.async."""
    import ctypes

    from mfa_tpu_torch.kernels import _build

    fn = _build.function("paged", "mfa_tma_box_probe",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rows, total = 64, 72
    gen = torch.Generator(device=dev).manual_seed(row_bytes + box_rows)
    src = torch.randint(0, 256, (total, row_bytes), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    addr = torch.arange(rows * row_bytes, device=dev)
    mask = {128: 7, 64: 3, 0: 0}[swizzle]
    logical = addr ^ (((addr >> 7) & mask) << 4)
    for r0 in range(8):
        outs = []
        for r in (8, box_rows):
            out = torch.zeros(rows * row_bytes, dtype=torch.uint8, device=dev)
            _build.check("paged", fn(src.data_ptr(), out.data_ptr(), total, rows,
                                     row_bytes, r0, r, swizzle, _build.stream_of(src)))
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], src.view(-1)[r0 * row_bytes + logical]), r0
        assert torch.equal(outs[1], outs[0]), r0
    bad = torch.zeros(rows * row_bytes, dtype=torch.uint8, device=dev)
    assert fn(src.data_ptr(), bad.data_ptr(), total, rows, 64, 0, 1, 64,
              _build.stream_of(src)) == 9999  # MFA_BAD_CONFIG: 64 bytes a box


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
        (32, 8, 64, 128, "fp8", BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (32, 8, 64, 128, "int4", BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (8, 2, 16, 128, "fp8", HF, [16, 0], 100, [116, 70], [100, 40], False,
         (10, 6), 20.0),
        (4, 4, 64, 64, "int4", BF, [64, 0], 130, [194, 100], None, True, (40, -1),
         0.0),
        (16, 2, 32, 64, "fp8", BF, [96, 0], 64, [160, 64], None, True, (-1, -1),
         0.0),
        (16, 2, 32, 128, "int4", HF, [96, 0], 64, [160, 64], None, True, (-1, -1),
         20.0),
        # head_dim 256 (64-key tiles): every page format, Gemma3's group 2
        (8, 4, 64, 256, True, BF, [0, 128, 320], 192, [192, 320, 370], None, True,
         (63, -1), 0.0),
        (8, 4, 64, 256, False, BF, [0, 128, 320], 192, [192, 320, 370], None, True,
         (100, -1), 0.0),
        (8, 2, 16, 256, False, HF, [16, 0], 100, [116, 70], [100, 40], False,
         (10, 6), 20.0),
        (8, 4, 128, 256, "fp8", BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (8, 4, 32, 256, "int4", BF, [96, 0], 64, [160, 64], None, True, (40, -1),
         20.0),
        (16, 2, 64, 256, True, HF, [64, 0], 130, [194, 100], None, True, (-1, -1),
         0.0),
        # q-per-kv groups that do not divide 64 (dead tail rows in each
        # warpgroup): Qwen2-7B's 7 on every page format, 5 and 6, at d 64,
        # 128 and 256; 3 and 40 (one position a warpgroup)
        (28, 4, 64, 128, True, BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (28, 4, 64, 128, False, BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (28, 4, 64, 128, "fp8", BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (100, -1), 0.0),
        (28, 4, 64, 128, "int4", BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (20, 4, 32, 128, True, HF, [96, 0], 64, [160, 64], None, True, (-1, -1),
         20.0),
        (12, 2, 16, 128, "fp8", BF, [16, 0], 100, [116, 70], [100, 40], False,
         (10, 6), 0.0),
        (14, 2, 64, 256, True, BF, [0, 128, 320], 192, [192, 320, 370], None, True,
         (63, -1), 0.0),
        (10, 2, 64, 256, False, HF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        (12, 2, 64, 256, "int4", BF, [64, 0], 130, [194, 100], None, True, (40, -1),
         0.0),
        (28, 4, 32, 256, "fp8", BF, [96, 0], 64, [160, 64], None, True, (-1, -1),
         20.0),
        (7, 1, 64, 64, "int4", BF, [64, 0], 130, [194, 100], None, True, (40, -1),
         0.0),
        (6, 2, 16, 64, False, HF, [16, 0], 100, [116, 70], [100, 40], False,
         (10, 6), 0.0),
        (40, 1, 64, 128, False, BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 0.0),
        # Gemma2-9B's heads: softcap 50, window 4095 and none
        (16, 8, 64, 256, True, BF, [0, 128, 320], 192, [192, 320, 370], None, True,
         (4095, -1), 50.0),
        (16, 8, 64, 256, False, BF, [0, 128, 320], 192, [192, 320, 370], None,
         True, (-1, -1), 50.0),
    ])
def test_paged_prefill_kernel(dev, hq, hkv, page, d, quant, dtype, q_start, sq,
                              lens, q_lens, causal, window, softcap):
    from mfa_tpu_torch.kernels import _build, paged, paged_prefill

    quant = "int8" if quant is True else quant or None
    gen = torch.Generator(device=dev).manual_seed(5)
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    kp, vp, ks, vs = _pages(kf, vf, quant)
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
        logit_softcap=softcap, quant_dtype=quant, return_lse=True)
    assert _build.launches[paged.launch_name("paged_prefill", quant)] == 1
    # quantized pages contract in bf16: the kernel rounds fp16 q to bf16 first
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, window[0],
        0 if causal else window[1], softcap, quant_dtype=quant)
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
        (8, 8, 64, 128, "fp8", BF, [0, 100], 200, [200, 300], None, (-1, -1)),
        (32, 4, 16, 64, "int4", BF, [16, 0, 50], 150, [166, 90, 200], None,
         (-1, -1)),
        (16, 4, 16, 128, "int4", HF, [0, 40], 129, [129, 169], None, (33, -1)),
        (16, 4, 32, 64, "fp8", BF, [0, 64, 10], 256, [256, 64, 10], [256, 0, 0],
         (-1, -1)),
        # head_dim 256
        (8, 4, 64, 256, True, BF, [0, 100], 200, [200, 300], None, (1023, -1)),
        (8, 4, 16, 256, "int4", HF, [0, 40], 129, [129, 169], None, (33, -1)),
        (16, 4, 32, 256, False, BF, [0, 64, 10], 256, [256, 64, 10], [256, 0, 0],
         (-1, -1)),
        (8, 2, 64, 256, "fp8", BF, [5, 0], 300, [305, 77], [300, 77], (-1, -1)),
        (8, 8, 128, 256, False, HF, [5, 0], 300, [305, 77], [300, 77], (40, -1)),
        # groups 7, 5 and 6: the dead tail rows are never stored
        (28, 4, 64, 128, True, BF, [0, 100], 200, [200, 300], None, (-1, -1)),
        (20, 4, 16, 256, "fp8", HF, [0, 40], 129, [129, 169], None, (33, -1)),
        (12, 2, 32, 128, "int4", BF, [0, 64, 10], 256, [256, 64, 10], [256, 0, 0],
         (-1, -1)),
        (14, 2, 64, 64, False, BF, [5, 0], 300, [305, 77], [300, 77], (40, -1)),
    ])
def test_paged_prefill_edges(dev, hq, hkv, page, d, quant, dtype, q_start, sq, lens,
                             q_lens, window):
    """NaN in every key and value row past lens of each sequence's last page,
    in the pages its unmapped table entries clamp to, and (quantized pages)
    in their scales, with the NaN code 0x7F in fp8 payloads: the kernel
    never lets them reach O or the LSE. Rows past q_lens, and whole blocks
    of them, come out O = 0, LSE = -inf. Held to the plain version on the
    pages before the poisoning (the plain version multiplies those rows by
    p = 0, which keeps a NaN)."""
    from mfa_tpu_torch.kernels import _build, paged, paged_prefill

    quant = "int8" if quant is True else quant or None
    gen = torch.Generator(device=dev).manual_seed(6)
    b, pps = len(lens), 400 // page + 1
    P = b * pps + 3  # pages 0 and P - 1 are never mapped
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=dtype), _rn(gen, hkv, P, page, d, dtype=dtype)
    kp, vp, ks, vs = _pages(kf, vf, quant)
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
    _poison(kp, ks, quant, poisoned)
    _poison(vp, vs, quant, poisoned)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = (L - qs).clamp(min=0) if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device=dev)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=True,
        window_left=window[0], quant_dtype=quant, return_lse=True)
    assert _build.launches[paged.launch_name("paged_prefill", quant)] == 1
    q_ref = q.to(BF).float() if quant else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, *clean[:2], *clean[2:], L, qs, ql, table, d ** -0.5, window[0], 0, 0.0,
        quant_dtype=quant)
    _close(o, lse, ro, rl)
    dead = torch.arange(sq, device=dev)[None] >= ql[:, None]  # [b, sq]
    assert torch.equal(o.float()[dead], torch.zeros_like(o.float()[dead]))
    assert torch.isneginf(lse.transpose(1, 2)[dead]).all()


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quant,page", ROW_PAGES)
def test_paged_prefill_pages_of_any_rows(dev, quant, page, d, dtype):
    """Kernel 8 on pages of 1-24 rows, every format, bf16 and fp32 q: a
    window of 40 whose edge falls inside a page with 3 sink tokens, rows
    past q_lens, rows past each length poisoned, against the plain version
    on the pages before the poisoning."""
    from mfa_tpu_torch.kernels import _build, paged, paged_prefill

    gen = torch.Generator(device=dev).manual_seed(page + d + 1)
    hq, hkv, sq = 8, 2, 70
    q_start, lens, q_lens = [100, 0, 7], [170, 50, 77], [70, 45, 70]
    b, pps = len(lens), 200 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kp, vp, ks, vs = _any_rows_pages(gen, hkv, P, page, d, quant, dtype)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L, qs, ql = (torch.tensor(x, dtype=torch.int32, device=dev)
                 for x in (lens, q_start, q_lens))
    q_ref = q if dtype == torch.float32 else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, 40, 0, 0.0,
        quant_dtype=quant, sinks=3)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=True,
        window_left=40, sink_tokens=3, quant_dtype=quant, return_lse=True)
    assert _build.launches[paged.launch_name("paged_prefill", quant, 1, dtype)] == 1
    _any_rows_close(o, lse, ro, rl, quant, dtype)
    dead = torch.arange(sq, device=dev)[None] >= ql[:, None]
    assert torch.equal(o.float()[dead], torch.zeros_like(o.float()[dead]))
    assert torch.isneginf(lse.transpose(1, 2)[dead]).all()


@pytest.mark.parametrize("hq,hkv,quant,dtype,page", [
    (130, 2, None, BF, 64),                  # group 65
    (71, 1, None, BF, 64), (71, 1, "int8", BF, 64), (71, 1, "fp8", BF, 12),
    (71, 1, None, torch.float32, 12), (71, 1, "int8", torch.float32, 64),
    (96, 1, "int4", BF, 16), (96, 1, None, torch.float32, 1),
    (128, 1, "int8", BF, 1), (256, 2, None, BF, 6),    # group 128
])
def test_paged_prefill_groups_above_64(dev, hq, hkv, quant, dtype, page):
    """Kernel 8 above 64 q heads a kv head (a warpgroup holds 64 heads of one
    position; the grid takes ceil(group / 64) head chunks, the last one's
    rows past the group a dead tail), d 64, with ALiBi, rows past q_lens
    and rows past each length poisoned, against the plain version."""
    from mfa_tpu_torch.kernels import _build, paged, paged_prefill

    gen = torch.Generator(device=dev).manual_seed(hq + page)
    d, sq = 64, 40
    q_start, lens, q_lens = [60, 0], [100, 33], [40, 30]
    b, pps = len(lens), 120 // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d, dtype=dtype)
    kp, vp, ks, vs = _any_rows_pages(gen, hkv, P, page, d, quant, dtype)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L, qs, ql = (torch.tensor(x, dtype=torch.int32, device=dev)
                 for x in (lens, q_start, q_lens))
    slopes = _alibi(hq, dev)
    q_ref = q if dtype == torch.float32 else q.float()
    ro, rl = paged_prefill._paged_prefill_plain(
        q_ref, kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, -1, 0, 0.0,
        quant_dtype=quant, alibi=slopes)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=True,
        quant_dtype=quant, alibi_slopes=slopes, return_lse=True)
    assert _build.launches[paged.launch_name("paged_prefill", quant, 1, dtype)] == 1
    _any_rows_close(o, lse, ro, rl, quant, dtype)
    dead = torch.arange(sq, device=dev)[None] >= ql[:, None]
    assert torch.equal(o.float()[dead], torch.zeros_like(o.float()[dead]))
    assert torch.isneginf(lse.transpose(1, 2)[dead]).all()


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
    # head_dim 256 (64-key dK/dV blocks, 32-key dQ tiles): Gemma3's train
    # shape at b1, sliding and global; a ragged tail; softcap 50 in fp16
    (1, 8, 4, 2048, 2048, 256, True, (1023, -1), 0.0, BF),
    (1, 8, 4, 2048, 2048, 256, True, (-1, -1), 0.0, BF),
    (1, 8, 4, 2049, 2049, 256, True, (-1, -1), 0.0, BF),
    (1, 4, 2, 130, 130, 256, True, (-1, -1), 50.0, HF),
    (1, 8, 2, 200, 1000, 256, False, (32, 0), 0.0, BF),    # key tiles no row sees
    (2, 4, 1, 100, 37, 256, False, (-1, -1), 0.0, HF),
    (1, 4, 4, 300, 8, 256, True, (4, -1), 0.0, BF),        # dead rows
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
    # head_dim 256
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 8, 4, 256, True, (-1, -1), 0.0, BF),
    ([65, 1, 127, 0, 200], [65, 1, 127, 0, 200], 8, 4, 256, True, (48, 0), 0.0, HF),
    ([100, 37, 300], [130, 64, 200], 4, 2, 256, False, (128, 64), 30.0, BF),
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
    (4, 2048, 8, 4, 256, (1023, 0)),  # Gemma3's sliding layers
    (3, 300, 8, 2, 256, (-1, 0)),
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


def _bank_close(out, ref):
    """One rounding of the fp32 accumulator: <= 2^-8 of the largest output."""
    assert torch.isfinite(out.float()).all()
    d = (out.float() - ref).abs()
    assert float(d.max()) <= 2 ** -8 * float(ref.abs().max()) + 1e-6


@pytest.mark.parametrize("E,T,K,N,per_expert,dtype", [
    (8, 16, 4096, 14336, False, BF),   # Mixtral decode: gate / up, shared x
    (8, 16, 14336, 4096, True, BF),    # down: x of each expert
    (8, 1, 4096, 14336, False, BF),    # one row
    (4, 70, 80, 48, True, HF),         # K % 64 != 0, N under one tile, 128 rows a block
    (2, 33, 4096, 272, False, BF),     # few tiles: K split over a cluster
    (3, 300, 1040, 400, True, HF),     # 256 rows a block, K and N tails
])
def test_int8_bank_dense(dev, E, T, K, N, per_expert, dtype):
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(17)
    x = _rn(gen, *((E,) if per_expert else ()), T, K, dtype=dtype)
    w = quantize_weight(torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5)
    _build.reset_launches()
    out = wmatmul.int8_bank_matmul(x, w.qw, w.scale)
    assert dict(_build.launches) == {"wmatmul_bank": 1}
    assert out.shape == (E, T, N) and out.dtype == dtype
    assert torch.equal(out, wmatmul.int8_bank_matmul(x, w.qw, w.scale))
    _bank_close(out, wmatmul._bank_plain(x.float(), w.qw, w.scale, None, torch.float32))
    # expert e alone through the 2-D launch: the same function
    e = E - 1
    one = wmatmul.int8_matmul(x[e] if per_expert else x, w.qw[e], w.scale[e])
    _bank_close(one, out[e].float())


@pytest.mark.parametrize("sizes,K,N,dtype", [
    ((3, 0, 1, 20), 256, 128, BF),           # an empty and a one-row group, tiles straddle
    ((17, 15, 16, 16, 1, 0, 33, 30), 4096, 14336, BF),  # 16 rows a block: decode-sized groups
    ((900, 1, 0, 1200, 2001, 1500, 800, 800), 4096, 14336, BF),  # the wave: 7202 rows
    ((512, 260, 3, 257, 1, 0, 0, 7), 14336, 4096, BF),  # down at a chunk batch's skew
    ((40, 41, 0, 39), 1040, 400, HF),        # K and N tails, fp16
    ((5, 6), 4096, 272, BF),                 # few tiles: K split over a cluster
])
def test_int8_bank_grouped(dev, sizes, K, N, dtype):
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(18)
    E, R = len(sizes), sum(sizes)
    x = _rn(gen, R, K, dtype=dtype)
    w = quantize_weight(torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5)
    offs = torch.tensor([0, *torch.tensor(sizes).cumsum(0).tolist()], dtype=torch.int32,
                        device=dev)
    _build.reset_launches()
    out = wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs, max_rows=max(sizes))
    assert dict(_build.launches) == {"wmatmul_bank": 1}
    assert out.shape == (R, N) and out.dtype == dtype
    assert torch.equal(out, wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs,
                                                     max_rows=max(sizes)))
    ref = wmatmul._bank_plain(x.float(), w.qw, w.scale, offs, torch.float32)
    _bank_close(out, ref)
    # every group against its own 2-D launch: rows of the next expert that a
    # straddling tile read never reach the output
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            _bank_close(out[lo:lo + n], wmatmul.int8_matmul(x[lo:lo + n], w.qw[e],
                                                            w.scale[e]).float())
        lo += n
    with pytest.raises(NotImplementedError):
        wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs.long())


def test_moe_route_refuses_tf32(dev):
    from mfa_tpu_torch.models import llama

    t = torch.randn(4, 64, device=dev)
    w = torch.randn(64, 8, device=dev)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="fp32"):
            llama._moe_route(t, w, 2, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    w_top, idx = llama._moe_route(t, w, 2, True)
    want = torch.topk(t.double() @ w.double(), 2).indices
    assert torch.equal(idx, want)


def test_int8_moe_forms_on_the_card(dev):
    """The dense form (20 rows) and the grouped form (140 rows) of a
    Mixtral-shaped int8 layer at narrow widths on the card against the CPU
    (plain versions), from the same rows and the same routing: three expert
    launches a form."""
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab=512, dim=256, layers=1, heads=4, kv_heads=2,
                                 ffn=512, dtype=BF, n_experts=8, n_active_experts=2)
    lp = llama.init_params(cfg, seed=1, device="cuda", quantize="int8")["layers"][0]
    cpu = {k_: v_.to("cpu") for k_, v_ in lp.items()}
    for rows, form in ((20, llama._moe_dense), (140, llama._moe_grouped)):
        t = torch.randn(rows, cfg.dim, generator=torch.Generator().manual_seed(rows)).to(BF)
        w_top, idx = llama._moe_route(t, cpu["w_router"], 2, True)
        want = form(t, cpu, w_top, idx, cfg)
        _build.reset_launches()
        got = form(t.to(dev), lp, w_top.to(dev), idx.to(dev), cfg)
        assert dict(_build.launches) == {"wmatmul_bank": 3}
        d = (got.cpu().float() - want.float()).abs()
        assert torch.isfinite(got).all()
        assert float(d.max()) <= 2e-2 * float(want.float().abs().max())


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


# ------ attention sinks, ALiBi and kv_position_offset in every kernel ------


def _alibi(h, dev):
    """The ALiBi paper's slopes 2^(-8 (i + 1) / h)."""
    return 2.0 ** (-8.0 * torch.arange(1, h + 1, device=dev, dtype=torch.float32) / h)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,sinks,offset,alibi,engine,dtype", [
    # sinks: every engine (None = flagged + repair at d 128 / 256, the bound
    # prepass at d 64), at the sink tiles' meeting with the band and past it
    (1, 8, 2, 400, 400, 128, (63, 0), 10, 0, False, None, BF),
    (1, 8, 2, 400, 400, 128, (63, 0), 10, 0, False, False, BF),
    (1, 4, 2, 260, 260, 128, (100, 0), 140, 0, False, None, BF),
    (1, 4, 4, 256, 256, 64, (0, -1), 128, 0, False, None, BF),   # the gap filled
    (1, 4, 4, 256, 256, 64, (0, -1), 128, 0, False, "unchecked", BF),
    (2, 8, 4, 700, 700, 256, (255, 0), 4, 0, False, None, BF),
    (1, 8, 2, 1200, 1200, 128, (300, 0), 200, 0, False, "prepass", BF),
    (1, 8, 2, 300, 300, 64, (31, 0), 4, 0, False, None, HF),     # fp16: kernel 1
    (1, 16, 2, 200, 50, 128, (10, 0), 4, 0, False, None, BF),    # dead rows past sk
    # ALiBi: kernel 1 (the engine falls back to it)
    (2, 8, 2, 300, 300, 128, (-1, 0), 0, 0, True, None, BF),
    (2, 8, 2, 300, 300, 128, (-1, -1), 0, 0, True, None, BF),
    (1, 8, 4, 200, 330, 256, (63, 0), 4, 0, True, None, BF),     # with sinks
    (1, 4, 2, 129, 129, 64, (-1, 0), 0, 0, True, None, HF),
    # kv_position_offset (the ring's pairs), every engine
    (1, 8, 2, 256, 640, 128, (-1, 0), 0, 384, False, None, BF),
    (1, 8, 2, 256, 640, 128, (127, 0), 0, 384, False, False, BF),
    (1, 4, 2, 200, 200, 64, (-1, 0), 0, 1024, False, None, BF),  # every column seen
    (1, 8, 4, 300, 700, 256, (-1, 0), 0, 200, True, None, BF),   # with ALiBi
])
def test_prefill_sinks_alibi_offset(dev, b, hq, hkv, sq, sk, d, window, sinks, offset,
                                    alibi, engine, dtype):
    from mfa_tpu_torch.kernels import prefill

    gen = torch.Generator(device=dev).manual_seed(30)
    q, k, v = (_rn(gen, b, hq, sq, d, dtype=dtype), _rn(gen, b, hkv, sk, d, dtype=dtype),
               _rn(gen, b, hkv, sk, d, dtype=dtype))
    slopes = _alibi(hq, dev) if alibi else None
    o, lse = prefill.prefill_attention(q, k, v, window_size=window, sink_tokens=sinks,
                                       kv_position_offset=offset, alibi_slopes=slopes,
                                       bound_softmax=engine, return_lse=True)
    ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, window[0],
                                    window[1], 0.0, True, sinks, offset, slopes)
    _close(o, lse, ro, rl)
    assert (o.float() - ro.float()).abs().mean() < 2e-3


def test_flagged_repair_with_sinks_on_poisoned_tiles(dev):
    """std-1e3 scores poison the zero-shift sums of the sink tiles too: the
    flags cover them and the repair equals kernel 1 bit for bit."""
    from mfa_tpu_torch.kernels import prefill

    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = _zs_inputs(gen, 1, 4, 2, 512, 512, 128, "overflow")
    kw = dict(window_size=(127, 0), sink_tokens=4)
    o, flags = prefill.prefill_attention(q, k, v, bound_softmax="flag_debug", **kw)
    assert int(flags.sum()) > 0
    assert torch.equal(o, prefill.prefill_attention(q, k, v, bound_softmax=False, **kw))


@pytest.mark.parametrize("lens_q,hq,hkv,d,window,sinks,alibi,dtype", [
    ([200, 1100, 0, 513], 8, 2, 128, (63, 0), 4, False, BF),
    ([200, 1100, 0, 513], 8, 2, 128, (-1, 0), 0, True, BF),
    ([65, 1, 127, 0, 300], 8, 4, 256, (31, 0), 40, True, HF),
    ([100, 37, 300], 4, 2, 64, (-1, -1), 0, True, BF),
])
def test_varlen_sinks_alibi(dev, lens_q, hq, hkv, d, window, sinks, alibi, dtype):
    from mfa_tpu_torch.kernels import varlen

    gen = torch.Generator(device=dev).manual_seed(32)
    n = sum(lens_q)
    q, k, v = (_rn(gen, n, h, d, dtype=dtype) for h in (hq, hkv, hkv))
    cu = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
    slopes = _alibi(hq, dev) if alibi else None
    kw = dict(window_size=window, sink_tokens=sinks, alibi_slopes=slopes)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens_q), max(lens_q),
                                     return_lse=True, **kw)
    ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu, d ** -0.5,
                                  window[0], window[1], 0.0, True, sinks, slopes)
    _close(o, lse, ro, rl)


@pytest.mark.parametrize("b,hq,hkv,s,d,lens,splits,window,sinks,alibi", [
    (3, 8, 2, 700, 64, [700, 0, 257], (1, 2, 3, 0), 100, 4, False),
    (4, 32, 8, 8192, 128, [8192, 4099, 4097, 100], (1, 3, 0), 4095, 4, False),
    (2, 32, 8, 8192, 128, [8192, 300], (1, 2, 0), -1, 0, True),
    (2, 8, 4, 1000, 256, [1000, 64], (1, 3), 200, 70, True),
    (2, 8, 8, 300, 128, [300, 65], (1, 5), 10, 64, False),   # sinks meet the band
])
def test_decode_sinks_alibi(dev, b, hq, hkv, s, d, lens, splits, window, sinks, alibi):
    from mfa_tpu_torch.kernels import decode

    gen = torch.Generator(device=dev).manual_seed(33)
    q, k, v = _rn(gen, b, hq, d), _rn(gen, b, hkv, s, d), _rn(gen, b, hkv, s, d)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = _alibi(hq, dev) if alibi else None
    for ns in splits:
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns, window_left=window,
                                         sink_tokens=sinks, alibi_slopes=slopes,
                                         return_lse=True)
        n, tps = decode.split_layout(s, ns if ns else decode.default_splits(b, hkv, s))
        po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L,
                                               d ** -0.5, n, tps, window, 0.0,
                                               sinks, slopes)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _close(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))


@pytest.mark.parametrize("span,hq,hkv,page,d,quant,pos_offset,window,sinks,alibi,lens", [
    (1, 32, 8, 64, 128, "int8", 1, 4095, 4, False, [8192, 4200, 4097, 300]),
    (1, 32, 8, 64, 128, "int4", 1, 4095, 4, False, [8192, 4200, 4097, 300]),
    (1, 32, 8, 64, 128, None, 1, 4095, 4, True, [8192, 4200, 4097, 300]),
    (1, 32, 8, 64, 128, "fp8", 1, 100, 70, True, [2000, 65, 100, 3]),
    (1, 8, 4, 64, 256, "int8", 1, 1023, 4, True, _GEMMA3_LENS),   # split route
    (1, 8, 2, 16, 64, None, 0, 20, 24, False, [300, 0, 40]),      # sinks past pages
    (4, 32, 8, 64, 128, "int8", 4, 4095, 4, True, [8192, 4200, 4097, 300]),  # span
    (4, 32, 8, 64, 128, "int4", 4, 100, 4, False, [2000, 650, 4097, 30]),
    (1, 32, 2, 64, 128, "int8", 1, 300, 4, True, [5000, 700]),    # group 16
    (3, 16, 2, 32, 256, None, 0, 50, 8, True, _GEMMA3_LENS),     # span, split route
])
def test_paged_sinks_alibi(dev, span, hq, hkv, page, d, quant, pos_offset, window, sinks,
                           alibi, lens):
    from mfa_tpu_torch.kernels import paged

    gen = torch.Generator(device=dev).manual_seed(34)
    b, pps = len(lens), max(lens) // page + 2
    P = b * pps + 1
    q = _rn(gen, b, span, hq, d) if span > 1 else _rn(gen, b, hq, d)
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = _alibi(hq, dev) if alibi else None
    kw = dict(window_left=window, pos_offset=pos_offset, quant_dtype=quant)
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   sink_tokens=sinks, alibi_slopes=slopes,
                                   return_lse=True, **kw)
    ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5, window,
                                0.0, pos_offset, quant, sinks, slopes)
    _close(o, lse, ro, rl)
    assert (o.float() - ro.float()).abs().mean() < 2e-3
    so, sl = paged._paged_split_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5,
                                      window, 0.0, pos_offset, quant_dtype=quant,
                                      sinks=sinks, alibi=slopes)
    _close(o, lse, so, sl)


@pytest.mark.parametrize("hq,hkv,page,d,quant,q_start,sq,lens,window,sinks,alibi", [
    (32, 8, 64, 128, "int8", [4608, 5120, 0, 4096], 512, [5120, 5632, 512, 4500],
     4095, 4, False),
    (32, 8, 64, 128, None, [4608, 5120, 0, 4096], 512, [5120, 5632, 512, 4500],
     4095, 4, True),
    (32, 8, 64, 128, "int4", [512, 1024], 256, [768, 1280], 100, 70, False),
    (28, 4, 16, 128, "fp8", [512, 1024], 256, [768, 1200], 300, 4, True),  # group 7
    (8, 4, 64, 256, "int8", [1536, 64], 512, [2048, 576], 1023, 4, True),
    (8, 2, 32, 64, None, [96, 0], 64, [160, 64], 20, 40, False),
])
def test_paged_prefill_sinks_alibi(dev, hq, hkv, page, d, quant, q_start, sq, lens,
                                   window, sinks, alibi):
    from mfa_tpu_torch.kernels import paged_prefill

    gen = torch.Generator(device=dev).manual_seed(35)
    b, pps = len(lens), max(lens) // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d)
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = (L - qs).clamp(min=0)
    slopes = _alibi(hq, dev) if alibi else None
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=True,
        window_left=window, sink_tokens=sinks, alibi_slopes=slopes, quant_dtype=quant,
        return_lse=True)
    ro, rl = paged_prefill._paged_prefill_plain(
        q.float(), kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, window, 0, 0.0,
        quant, sinks, slopes)
    _close(o, lse, ro, rl)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,sinks,offset,alibi,dtype", [
    (1, 8, 2, 1100, 1100, 128, (255, 0), 4, 0, False, BF),    # kernel 11 with sinks
    (1, 8, 2, 600, 600, 128, (100, 0), 140, 0, False, BF),
    (1, 8, 4, 700, 700, 256, (127, 0), 4, 0, False, BF),
    (1, 8, 2, 300, 300, 64, (31, 0), 70, 0, False, HF),
    (1, 8, 2, 512, 512, 128, (-1, 0), 0, 0, True, BF),       # ALiBi, every launch
    (1, 8, 4, 300, 300, 256, (63, 0), 0, 0, True, BF),
    (1, 8, 2, 256, 640, 128, (-1, 0), 0, 384, False, BF),    # the offset, 11-13
    (1, 8, 2, 256, 640, 128, (127, 0), 0, 384, True, BF),
    (1, 8, 4, 200, 500, 256, (-1, 0), 0, 300, False, HF),
])
def test_backward_sinks_alibi_offset(dev, b, hq, hkv, sq, sk, d, window, sinks, offset,
                                     alibi, dtype):
    from mfa_tpu_torch.kernels import backward, prefill

    gen = torch.Generator(device=dev).manual_seed(36)
    q, k, v, do = (_rn(gen, b, h, s, d, dtype=dtype)
                   for h, s in ((hq, sq), (hkv, sk), (hkv, sk), (hq, sq)))
    slopes = _alibi(hq, dev) if alibi else None
    kw = dict(window_size=window, sink_tokens=sinks, kv_position_offset=offset,
              alibi_slopes=slopes)
    o, lse = prefill.prefill_attention(q, k, v, return_lse=True, **kw)
    ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                              do.float(), d ** -0.5, window[0], window[1], 0.0, sinks,
                              offset, slopes)
    fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
    _bwd_close(fused, ref, "fused")
    if sinks:
        with pytest.raises(NotImplementedError):
            backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    else:
        _bwd_close(backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw),
                   ref, "split")


def test_varlen_backward_alibi(dev):
    from mfa_tpu_torch.kernels import backward, varlen

    gen = torch.Generator(device=dev).manual_seed(37)
    lens = [200, 1100, 0, 513]
    n = sum(lens)
    q, k, v, do = (_rn(gen, n, h, 128) for h in (8, 2, 2, 8))
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    slopes = _alibi(8, dev)
    kw = dict(causal=True, alibi_slopes=slopes)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens),
                                     return_lse=True, **kw)
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, **kw)
    ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), cu, cu, 128 ** -0.5, -1, 0, 0.0, slopes)
    _bwd_close(got, ref, "varlen alibi")


# -- every head_dim up to 256: the kernels at the next instantiated D ---------

NEW_DIMS = (32, 80, 96, 100, 160, 192, 224)


def _stored_pages(kf, vf, quant):
    """Float pages [hkv, P, page, d] -> (k, v, k_scales, v_scales) as the
    cache stores them: rows at the head-dim plan's stored width
    (cache/paged_cache.py:stored_rows; int4 feature pairs)."""
    from mfa_tpu_torch.cache.paged_cache import stored_rows
    from mfa_tpu_torch.kernels.quant import FP8, quantize_rows

    if quant is None:
        return stored_rows(None, kf), stored_rows(None, vf), None, None
    (kq, ks), (vq, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
    kp, vp = stored_rows(quant, kq), stored_rows(quant, vq)
    if quant == "fp8":
        kp, vp = kp.view(FP8), vp.view(FP8)
    return kp, vp, ks, vs


@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("mode", [None, False, "flag_only"])
def test_head_dim_prefill_kernels(dev, d, mode):
    """Kernels 1 (False) and 4 (the default at d % 128 != 0: the bound
    prepass; "flag_only" asks for the flagged engine, which mfa_tpu gives
    only at d % 128 == 0, and gets kernel 4 as there) at every d, causal
    GQA 4:1 and a window with sinks; the output keeps the caller's d and
    the engine is chosen from the true d, never the padded one."""
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = _rn(gen, 2, 8, 300, d), _rn(gen, 2, 2, 300, d), _rn(gen, 2, 2, 300, d)
    engine = {None: "bound", False: "prefill", "flag_only": "bound"}[mode]
    for wl, sinks in ((-1, 0), (100, 4)):
        _build.reset_launches()
        o, lse = prefill.prefill_attention(q, k, v, causal=True, window_size=(wl, -1),
                                           sink_tokens=sinks, return_lse=True,
                                           bound_softmax=mode)
        assert dict(_build.launches) == {engine: 1} and o.shape == q.shape
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, wl,
                                        0, 0.0, True, sinks)
        _close(o, lse, ro, rl)


@pytest.mark.parametrize("d", NEW_DIMS)
def test_head_dim_varlen_and_image_block(dev, d):
    from mfa_tpu_torch.kernels import _build, blockmask, varlen

    gen = torch.Generator(device=dev).manual_seed(d + 1)
    lens = [200, 1, 0, 333]
    q = _rn(gen, sum(lens), 8, d)
    k, v = _rn(gen, sum(lens), 2, d), _rn(gen, sum(lens), 2, d)
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    _build.reset_launches()
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens), causal=True,
                                     window_size=(77, -1), return_lse=True)
    assert _build.launches["varlen"] == 1 and o.shape == q.shape
    ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu, d ** -0.5, 77,
                                  0, 0.0, True)
    _close(o, lse, ro, rl)
    qb, kb, vb = _rn(gen, 2, 8, 300, d), _rn(gen, 2, 4, 300, d), _rn(gen, 2, 4, 300, d)
    ids = _run_ids(2, 300, [[(10, 80), (150, 280)], [(63, 64)]], dev)
    o = blockmask.image_block_prefill(qb, kb, vb, ids, window_left=32)
    ref = blockmask._image_block_plain(qb.float(), kb.float(), vb.float(), ids,
                                       d ** -0.5, 32)
    assert o.shape == qb.shape and (o.float() - ref).abs().max() < 2e-2


@pytest.mark.parametrize("d", NEW_DIMS)
def test_head_dim_decode_kernel(dev, d):
    """Kernel 5 at every d, group 4 and group 16 (its 16-row blocks), one
    split and three."""
    from mfa_tpu_torch.kernels import _build, decode

    gen = torch.Generator(device=dev).manual_seed(d + 2)
    for hq, hkv in ((8, 2), (32, 2)):
        q, k, v = _rn(gen, 3, hq, d), _rn(gen, 3, hkv, 700, d), _rn(gen, 3, hkv, 700, d)
        L = torch.tensor([700, 0, 257], dtype=torch.int32, device=dev)
        for ns in (1, 3):
            _build.reset_launches()
            o, lse = decode.decode_attention(q, k, v, L, num_splits=ns, window_left=300,
                                             sink_tokens=3, return_lse=True)
            assert dict(_build.launches) == {"decode": 1}
            n, tps = decode.split_layout(700, ns)
            po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L,
                                                   d ** -0.5, n, tps, 300, 0.0, 3)
            ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
            _close(o, lse, ro.reshape(3, hq, d), rl.reshape(3, hq))


@pytest.mark.parametrize("group,hkv", [(16, 2), (32, 1), (12, 2), (64, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_kernel_any_group(dev, group, hkv, d):
    """Kernel 5 with more than 8 q heads a kv head (before: refused): the
    16-row blocks at the decode_groups shape's groups 16 and 32, a group
    that is not a multiple of 16, and 64; the heuristic's split count and
    4 splits."""
    from mfa_tpu_torch.kernels import _build, decode

    gen = torch.Generator(device=dev).manual_seed(group + d)
    b, s = 4, 2100
    hq = group * hkv
    q, k, v = _rn(gen, b, hq, d), _rn(gen, b, hkv, s, d), _rn(gen, b, hkv, s, d)
    L = torch.tensor([2100, 1, 1000, 0], dtype=torch.int32, device=dev)
    for ns in (0, 4):
        _build.reset_launches()
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns, return_lse=True)
        assert dict(_build.launches) == {"decode": 1}
        n, tps = decode.split_layout(s, ns or decode.default_splits(b, hkv, s, group))
        po, pl = decode._decode_partials_plain(q.float(), k.float(), v.float(), L,
                                               d ** -0.5, n, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _close(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
    assert torch.all(o[3] == 0)


@pytest.mark.parametrize("quant", [None, "int8", "fp8", "int4"])
@pytest.mark.parametrize("d", NEW_DIMS)
def test_head_dim_paged_kernels(dev, d, quant):
    """Kernels 6 and 8 at every d on every page format, pages as the cache
    stores them (int4 rows widened where d / 2 bytes are not a multiple
    of 16: 48 bytes at d 80), NaN in the rows past each length; kernel 6
    at group 4 and at group 16 (16-row blocks) with the split route."""
    from mfa_tpu_torch.kernels import _build, paged, paged_prefill
    from mfa_tpu_torch.kernels.quant import row_width

    gen = torch.Generator(device=dev).manual_seed(d + 3)
    page, pps, hkv = 32, 13, 2
    lens = [300, 0, 33, 400]
    b = len(lens)
    P = b * pps + 3
    kf, vf = _rn(gen, hkv, P, page, d), _rn(gen, hkv, P, page, d)
    kp, vp, ks, vs = _stored_pages(kf, vf, quant)
    assert kp.shape[-1] == row_width(quant, d)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    for hq in (8, 32):
        q = _rn(gen, b, hq, d)
        _build.reset_launches()
        o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                       window_left=200, pos_offset=1, quant_dtype=quant,
                                       return_lse=True)
        assert _build.launches[paged.launch_name("paged", quant)] == 1
        assert o.shape == q.shape
        ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5, 200,
                                    0.0, 1, quant_dtype=quant)
        _close(o, lse, ro, rl)
    q_start, sq = [0, 0, 1, 300], 100
    qp = _rn(gen, b, sq, 8, d)
    Lc = torch.tensor([100, 50, 33, 400], dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        qp, kp, vp, Lc, qs, table, k_scales=ks, v_scales=vs, causal=True,
        window_left=90, quant_dtype=quant, return_lse=True)
    assert _build.launches[paged.launch_name("paged_prefill", quant)] == 1
    assert o.shape == qp.shape
    ro, rl = paged_prefill._paged_prefill_plain(
        qp.float(), kp, vp, ks, vs, Lc, qs, (Lc - qs).clamp(min=0), table, d ** -0.5,
        90, 0, 0.0, quant_dtype=quant)
    _close(o, lse, ro, rl)


def test_unpadded_pages_are_copied_to_the_stored_width(dev):
    """bf16 pages of d 100 (200-byte rows: no TMA map reads them) and int4
    pages of d 80 (40-byte rows): the wrappers copy them to the stored
    width, and the result equals the stored pages'."""
    from mfa_tpu_torch.kernels import paged, paged_prefill
    from mfa_tpu_torch.kernels.quant import pack_int4, quantize_rows

    gen = torch.Generator(device=dev).manual_seed(50)
    L = torch.tensor([200, 70], dtype=torch.int32, device=dev)
    table = torch.arange(1, 17, device=dev).reshape(2, 8).int()
    for d, quant in ((100, None), (80, "int4")):
        kf, vf = _rn(gen, 2, 17, 32, d), _rn(gen, 2, 17, 32, d)
        stored = _stored_pages(kf, vf, quant)
        if quant is None:
            raw = (kf, vf, None, None)
        else:
            (kq, ks), (vq, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
            raw = (pack_int4(kq), pack_int4(vq), ks, vs)
        assert raw[0].shape[-1] != stored[0].shape[-1]
        q, qp = _rn(gen, 2, 8, d), _rn(gen, 2, 64, 8, d)
        qs = torch.zeros(2, dtype=torch.int32, device=dev)
        outs = []
        for kp, vp, ks, vs in (raw, stored):
            outs.append((
                paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                      quant_dtype=quant),
                paged_prefill.paged_prefill_attention(
                    qp, kp, vp, L.clamp(max=64), qs, table, k_scales=ks, v_scales=vs,
                    quant_dtype=quant)))
        assert all(torch.equal(a, b_) for a, b_ in zip(*outs))


@pytest.mark.parametrize("d", NEW_DIMS)
def test_head_dim_backward_kernels(dev, d):
    """Kernels 11-13 (fused and split) and 14 at every d: gradients of the
    caller's shape, within _bwd_close's limits of the plain backward."""
    from mfa_tpu_torch.kernels import _build, backward, varlen

    gen = torch.Generator(device=dev).manual_seed(d + 4)
    q, k, v, o, lse, do = _bwd_inputs(gen, 1, 8, 2, 333, 333, d, True, (100, -1), 0.0,
                                      BF)
    kw = dict(causal=True, window_size=(100, -1))
    ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                              do.float(), d ** -0.5, 100, 0, 0.0)
    _build.reset_launches()
    fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
    split = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert dict(_build.launches) == {"bwd_fused": 1, "bwd_dkv": 1, "bwd_dq": 1}
    assert [g.shape for g in fused + split] == [q.shape, k.shape, v.shape] * 2
    _bwd_close(fused, ref, "fused")
    _bwd_close(split, ref, "split")
    lens = [200, 1, 0, 333]
    n = sum(lens)
    q, k, v, do = (_rn(gen, n, h, d) for h in (8, 2, 2, 8))
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens), causal=True,
                                     return_lse=True)
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)
    ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), cu, cu, d ** -0.5, -1, 0, 0.0)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    _bwd_close(got, ref, "varlen")


# ---------------- fp32 inputs: the fp32 tile (csrc/flash_fwd_f32.cuh) ----------------
# Every forward kernel (1-9) on fp32 inputs against its plain fp32 version:
# within atol = rtol = 1e-4 on fp32 inputs and pages (LSE too, with the same
# -inf rows); on quantized pages with fp32 q within the bf16-q case's limits
# (max 2e-2, mean 2e-3: p is rounded to bf16 for P.V in both). Launch names
# end in _fp32: no plain route ran.

F32 = torch.float32


def _close32(out, lse, ref, ref_lse, tol=1e-4):
    assert out.dtype == F32 and bool(torch.isfinite(out).all())
    assert bool(((out - ref.float()).abs() <= tol + tol * ref.float().abs()).all())
    if lse is not None:
        assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
        fin = torch.isfinite(ref_lse)
        if fin.any():
            assert bool(((lse[fin] - ref_lse[fin]).abs()
                         <= tol + tol * ref_lse[fin].abs()).all())


def _close_quant32(out, lse, ref, ref_lse):
    assert out.dtype == F32
    _close(out, lse, ref, ref_lse)
    assert (out - ref.float()).abs().mean() < 2e-3


def _poison_past(kp, vp, ks, vs, quant, table, lens, page):
    """NaN (scales, fp8 NaN codes) in every row of a sequence's pages at or
    past its length: rows a kernel must never read."""
    where = torch.zeros(kp.shape[:3], dtype=torch.bool, device=kp.device)
    for i, n in enumerate(lens):
        for j, pg in enumerate(table[i].tolist()):
            lo = max(0, n - j * page)
            if lo < page:
                where[:, pg, lo:] = True
    for pages, scales in ((kp, ks), (vp, vs)):
        _poison(pages, scales, quant, where)


_F32_PREFILL = [
    # b, hq, hkv, sq, sk, d, window, softcap, sinks, offset, alibi
    (2, 8, 2, 100, 130, 128, (-1, 0), 0.0, 0, 0, False),
    (2, 8, 2, 100, 130, 128, (9, 4), 0.0, 0, 0, False),
    (1, 4, 4, 64, 64, 128, (-1, 0), 30.0, 0, 0, False),
    (1, 8, 1, 1, 1, 64, (-1, -1), 0.0, 0, 0, False),        # one row, one column
    (1, 16, 2, 200, 50, 64, (10, -1), 0.0, 0, 0, False),    # dead rows past sk
    (2, 8, 4, 300, 300, 256, (-1, 0), 0.0, 0, 0, False),
    (1, 16, 8, 300, 300, 256, (4095, 0), 50.0, 0, 0, False),  # Gemma2's softcap
    (2, 8, 2, 333, 333, 80, (-1, 0), 0.0, 0, 0, False),      # d 80 at D 128
    (16, 32, 8, 256, 256, 128, (-1, 0), 0.0, 0, 0, False),   # the 8B wave
    (1, 8, 2, 400, 400, 128, (63, 0), 0.0, 10, 0, False),    # sinks
    (1, 4, 4, 256, 256, 64, (0, -1), 0.0, 128, 0, False),    # sinks fill the gap
    (2, 8, 2, 300, 300, 128, (-1, 0), 0.0, 0, 0, True),      # ALiBi
    (1, 8, 4, 200, 330, 256, (63, 0), 0.0, 4, 0, True),
    (1, 8, 2, 256, 640, 128, (-1, 0), 0.0, 0, 384, False),   # kv_position_offset
    (1, 8, 4, 300, 700, 256, (-1, 0), 0.0, 0, 200, True),
]


@pytest.mark.parametrize("engine", [False, None, "unchecked"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,softcap,sinks,offset,alibi",
                         _F32_PREFILL)
def test_prefill_kernels_fp32(dev, b, hq, hkv, sq, sk, d, window, softcap, sinks,
                              offset, alibi, engine):
    """Kernel 1 (engine False), the default (kernels 2 + 3 at d % 128 == 0,
    kernel 4 else; softcap and ALiBi keep kernel 1) and kernel 4 unchecked."""
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(40)
    q, k, v = (_rn(gen, b, hq, sq, d, dtype=F32), _rn(gen, b, hkv, sk, d, dtype=F32),
               _rn(gen, b, hkv, sk, d, dtype=F32))
    slopes = _alibi(hq, dev) if alibi else None
    _build.reset_launches()
    o, lse = prefill.prefill_attention(q, k, v, window_size=window, logit_softcap=softcap,
                                       sink_tokens=sinks, kv_position_offset=offset,
                                       alibi_slopes=slopes, bound_softmax=engine,
                                       return_lse=True)
    eng, mode = prefill.select_engine(engine, F32, d, softcap, alibi)
    assert dict(_build.launches) == {"classic": {"prefill_fp32": 1},
                                     "flagged": {"flagged_fp32": 1, "repair_fp32": 1},
                                     "bound": {"bound_fp32": 1}}[eng]
    sk_ = (sinks if window[0] >= 0 else 0)
    if eng == "classic":
        ro, rl = prefill._prefill_plain(q, k, v, d ** -0.5, window[0], window[1], softcap,
                                        True, sk_, offset, slopes)
    else:
        ro, rl, _ = prefill._engine_plain(eng, mode, q, k, v, d ** -0.5, window[0],
                                          window[1], sk_, offset)
    _close32(o, lse, ro, rl)


def _zs_inputs32(gen, b, hq, hkv, sq, sk, d, kind):
    """fp32 q, k, v: benign N(0, 1); 'overflow' std 1e3; 'flush' q + 40, k - 40;
    'risky' q and k x 4 (every tile past the norm bound, scores of std ~16)."""
    q, k, v = (_rn(gen, b, hq, sq, d, dtype=F32), _rn(gen, b, hkv, sk, d, dtype=F32),
               _rn(gen, b, hkv, sk, d, dtype=F32))
    if kind == "overflow":
        q, k = q * 1e3, k * 1e3
    elif kind == "risky":
        q, k = q * 4.0, k * 4.0
    elif kind == "flush":
        q, k = q + 40.0, k - 40.0
    return q, k, v


@pytest.mark.parametrize("kind,d,window,sinks", [
    ("benign", 128, (-1, 0), 0), ("benign", 256, (1023, 0), 0),
    ("overflow", 128, (-1, 0), 0), ("flush", 128, (-1, 0), 0),
    ("overflow", 256, (-1, 0), 0), ("overflow", 128, (127, 0), 4),
])
def test_flagged_repair_fp32(dev, kind, d, window, sinks):
    """Kernel 2's flags equal the plain zero-shift flags (0 on benign
    inputs, > 0 on adversarial ones), and the repaired output equals
    kernel 1's bit for bit where every tile is flagged."""
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(41)
    q, k, v = _zs_inputs32(gen, 2, 8, 2, 300, 300, d, kind)
    kw = dict(window_size=window, sink_tokens=sinks)
    _build.reset_launches()
    o, lse, flags = prefill.prefill_attention(q, k, v, return_lse=True,
                                              bound_softmax="flag_debug", **kw)
    assert dict(_build.launches) == {"flagged_fp32": 1, "repair_fp32": 1}
    _, _, pflags = prefill._engine_plain("flagged", "flag_debug", q, k, v, d ** -0.5,
                                         window[0], window[1], sinks)
    assert torch.equal(flags, pflags)
    ro, rl = prefill._prefill_plain(q, k, v, d ** -0.5, window[0], window[1], 0.0, True,
                                    sinks)
    if kind == "benign":
        assert int(flags.sum()) == 0
        _close32(o, lse, ro, rl)
        return
    assert int(flags.sum()) > 0
    k1, l1 = prefill.prefill_attention(q, k, v, return_lse=True, bound_softmax=False, **kw)
    rows = flags.bool().repeat_interleave(64, -1)[..., :300]
    assert torch.equal(o[rows], k1[rows]) and torch.equal(lse[rows], l1[rows])
    if bool(flags.all()):
        assert torch.equal(o, k1)


@pytest.mark.parametrize("d,mode,kind", [
    (64, None, "benign"), (64, None, "risky"), (128, "prepass", "risky"),
    (256, "prepass", "risky"), (64, "unchecked", "benign"), (256, "unchecked", "benign"),
])
def test_bound_kernel_fp32(dev, d, mode, kind):
    """Kernel 4: the risky bits pick the classic softmax per 64-row tile
    (every tile risky on the 'risky' inputs, none on benign ones). Not on
    std-1e3 or shifted inputs: scores of 1e4-1e6 carry fp32 rounding that
    moves p by percents in any summation order, so two fp32 computations
    cannot agree to 1e-4 there (kernels 2 + 3 are held bit for bit to
    kernel 1 on them instead)."""
    from mfa_tpu_torch.kernels import _build, prefill

    gen = torch.Generator(device=dev).manual_seed(42)
    q, k, v = _zs_inputs32(gen, 2, 8, 2, 300, 300, d, kind)
    _build.reset_launches()
    o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                       bound_softmax=mode)
    assert dict(_build.launches) == {"bound_fp32": 1}
    ro, rl, _ = prefill._engine_plain("bound", mode or "prepass", q, k, v, d ** -0.5,
                                      -1, 0)
    _close32(o, lse, ro, rl)
    bits = prefill._risky_bits(q, k, d ** -0.5 * prefill._LOG2E)
    assert bool(bits.all()) if kind == "risky" else not bool(bits.any())


_F32_DECODE = [
    # b, hq, hkv, s, d, lens, splits, window, softcap, sinks, alibi
    (3, 8, 2, 700, 64, [700, 0, 257], (1, 2, 3, 0), -1, 0.0, 0, False),
    (4, 32, 8, 1000, 128, [1000, 999, 64, 63], (0, 5), 100, 0.0, 0, False),
    (2, 4, 1, 300, 64, [300, 200], (2,), -1, 20.0, 0, False),
    (2, 8, 4, 700, 256, [700, 1], (1, 3), 100, 0.0, 0, False),
    (2, 20, 4, 500, 80, [499, 0], (1, 3), -1, 0.0, 0, False),     # group 5, d 80
    (2, 32, 2, 600, 128, [600, 300], (1, 2), -1, 0.0, 0, False),  # group 16
    (4, 32, 8, 8192, 128, [8192, 4099, 4097, 100], (1, 3, 0), 4095, 0.0, 4, False),
    (2, 8, 4, 1000, 256, [1000, 64], (1, 3), 200, 0.0, 70, True),
    (16, 32, 8, 8192, 128, [8192] * 16, (0,), -1, 0.0, 0, False),  # the smoke's shape
]


@pytest.mark.parametrize("b,hq,hkv,s,d,lens,splits,window,softcap,sinks,alibi",
                         _F32_DECODE)
def test_decode_kernel_fp32(dev, b, hq, hkv, s, d, lens, splits, window, softcap, sinks,
                            alibi):
    """Kernel 5 (one launch, the split merge inside it) on fp32 q and
    caches; rows past each length hold NaN and are never read."""
    from mfa_tpu_torch.kernels import _build, decode

    gen = torch.Generator(device=dev).manual_seed(43)
    q, k, v = (_rn(gen, b, hq, d, dtype=F32), _rn(gen, b, hkv, s, d, dtype=F32),
               _rn(gen, b, hkv, s, d, dtype=F32))
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = _alibi(hq, dev) if alibi else None
    sk_ = sinks if window >= 0 else 0
    refs = {}
    for ns in splits:
        n, tps = decode.split_layout(
            s, ns if ns else decode.default_splits(b, hkv, s, hq // hkv))
        po, pl = decode._decode_partials_plain(q, k, v, L, d ** -0.5, n, tps, window,
                                               softcap, sk_, slopes)
        refs[ns] = decode.combine_splits(po, pl, axis=2, return_lse=True)
    for i, n in enumerate(lens):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    for ns in splits:
        _build.reset_launches()
        o, lse = decode.decode_attention(q, k, v, L, num_splits=ns, window_left=window,
                                         logit_softcap=softcap, sink_tokens=sinks,
                                         alibi_slopes=slopes, return_lse=True)
        assert dict(_build.launches) == {"decode_fp32": 1}
        ro, rl = refs[ns]
        _close32(o, lse, ro.reshape(b, hq, d), rl.reshape(b, hq))
    assert torch.all(o[L == 0] == 0)


_F32_PAGED = [
    # span, hq, hkv, page, d, quant, pos_offset, window, softcap, sinks, alibi, lens
    (1, 32, 8, 64, 128, None, 1, -1, 0.0, 0, False, None),
    (1, 32, 8, 64, 128, "int8", 1, -1, 0.0, 0, False, None),   # the 8B serve step
    (1, 32, 8, 64, 128, "fp8", 1, 50, 0.0, 0, False, None),
    (1, 32, 8, 64, 128, "int4", 1, -1, 15.0, 0, False, None),
    (1, 8, 8, 16, 64, None, 0, 20, 0.0, 0, False, None),       # pages under a tile
    (1, 8, 8, 16, 64, "int4", 0, -1, 0.0, 0, False, None),
    (1, 8, 4, 128, 256, None, 1, 100, 0.0, 0, False, None),    # pages past a tile
    (1, 8, 4, 64, 256, None, 1, 1023, 0.0, 0, False, _GEMMA3_LENS),  # split route
    (1, 8, 4, 64, 256, "int8", 1, 1023, 0.0, 0, False, _GEMMA3_LENS),
    (1, 32, 2, 64, 128, "int8", 1, -1, 0.0, 0, False, None),   # group 16
    (1, 32, 8, 64, 128, None, 1, -1, 0.0, 0, False, [8192]),   # b1: 16 splits
    (4, 32, 8, 64, 128, None, 4, 4095, 0.0, 4, True, [8192, 4200, 4097, 300]),
    (4, 32, 8, 64, 128, "int4", 4, 100, 0.0, 4, False, [2000, 650, 4097, 30]),
    (3, 16, 2, 32, 256, "fp8", 0, 50, 0.0, 8, True, _GEMMA3_LENS),
    (1, 20, 4, 32, 80, None, 1, -1, 0.0, 0, False, None),      # d 80
    (1, 20, 4, 32, 80, "int8", 1, -1, 0.0, 0, False, None),
    (1, 32, 8, 64, 128, "fp8", 1, 100, 0.0, 70, True, [2000, 65, 100, 3]),
]


@pytest.mark.parametrize(
    "span,hq,hkv,page,d,quant,pos_offset,window,softcap,sinks,alibi,lens", _F32_PAGED)
def test_paged_kernel_fp32(dev, span, hq, hkv, page, d, quant, pos_offset, window,
                           softcap, sinks, alibi, lens):
    """Kernel 6 with fp32 q on fp32 pages and on int8 / fp8 / int4 pages
    (q . k in fp32), spans, groups, the split route (one launch); rows
    past each length poisoned."""
    from mfa_tpu_torch.kernels import _build, paged

    gen = torch.Generator(device=dev).manual_seed(44)
    if lens is None:
        lens = [300, 0, page, 383 // page * page - 1]
    b, pps = len(lens), max(max(lens), 400) // page + 1
    P = b * pps + 3
    q = _rn(gen, b, span, hq, d, dtype=F32) if span > 1 else _rn(gen, b, hq, d, dtype=F32)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=F32), _rn(gen, hkv, P, page, d, dtype=F32)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = _alibi(hq, dev) if alibi else None
    sk_ = sinks if window >= 0 else 0
    ro, rl = paged._paged_plain(q, kp, vp, ks, vs, L, table, d ** -0.5, window, softcap,
                                pos_offset, quant, sk_, slopes)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    _build.reset_launches()
    o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                   window_left=window, pos_offset=pos_offset,
                                   logit_softcap=softcap, quant_dtype=quant,
                                   sink_tokens=sinks, alibi_slopes=slopes,
                                   return_lse=True)
    assert dict(_build.launches) == {"paged_fp32": 1}
    (_close32 if quant is None else _close_quant32)(o, lse, ro, rl)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(o[i] == 0) and torch.isneginf(lse[i]).all()


@pytest.mark.parametrize("d,quant", [(128, None), (128, "int8"), (256, None), (64, None)])
def test_fp32_decode_repeats_bit_equal(dev, d, quant):
    """Kernel 6 with fp32 q (and kernel 5 on fp32 caches) over 8192-token
    sequences at b16 hkv8: every block walks 64 (d 256: 128) tiles through
    its ring, two teams of warps taking turns. 30 repeats are bit-equal to
    the first (a slot shared by two teams let a parity wait pass on the
    other team's phase: wrong data or a fault at these lengths only)."""
    from mfa_tpu_torch.kernels import decode, paged

    gen = torch.Generator(device=dev).manual_seed(45)
    b, hq, hkv, page, n = 16, 32, 8, 64, 8192 if d < 256 else 4096
    pps = n // page
    P = b * pps + 1
    q = _rn(gen, b, hq, d, dtype=F32)
    kp, vp, ks, vs = _pages(_rn(gen, hkv, P, page, d, dtype=F32),
                            _rn(gen, hkv, P, page, d, dtype=F32), quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.full((b,), n, dtype=torch.int32, device=dev)
    runs = [lambda: paged.paged_attention(q, kp, vp, L, table, k_scales=ks,
                                          v_scales=vs, quant_dtype=quant)]
    if quant is None:
        kc = kp[:, table.long()].permute(1, 0, 2, 3, 4).reshape(b, hkv, n, d)
        vc = vp[:, table.long()].permute(1, 0, 2, 3, 4).reshape(b, hkv, n, d)
        runs.append(lambda: decode.decode_attention(q, kc, vc, L))
    for run in runs:
        first = run()
        assert all(torch.equal(run(), first) for _ in range(30))


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,window,softcap,sinks,alibi", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 32, 8, 128, (-1, 0), 0.0, 0, False),
    ([100, 37, 300], [130, 64, 200], 8, 2, 128, (128, 64), 0.0, 0, False),
    ([30, 5], [10, 0], 4, 2, 64, (3, 0), 0.0, 0, False),       # dead rows
    ([65, 1, 64], [65, 1, 64], 4, 4, 64, (-1, 0), 30.0, 0, False),
    ([100, 37, 300], [130, 64, 200], 8, 4, 256, (127, 32), 0.0, 0, False),
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 8, 2, 80, (63, 0), 0.0, 4, True),
])
def test_varlen_kernel_fp32(dev, lens_q, lens_k, hq, hkv, d, window, softcap, sinks,
                            alibi):
    """Kernel 7: the packed layout of the fp32 tile."""
    from mfa_tpu_torch.kernels import _build, varlen

    gen = torch.Generator(device=dev).manual_seed(45)
    q = _rn(gen, sum(lens_q), hq, d, dtype=F32)
    k, v = (_rn(gen, sum(lens_k), hkv, d, dtype=F32) for _ in range(2))
    cu_q = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
    cu_k = torch.tensor([0] + lens_k, device=dev).cumsum(0).int()
    slopes = _alibi(hq, dev) if alibi else None
    _build.reset_launches()
    o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lens_q), max(lens_k),
                                     window_size=window, logit_softcap=softcap,
                                     sink_tokens=sinks, alibi_slopes=slopes,
                                     return_lse=True)
    assert dict(_build.launches) == {"varlen_fp32": 1}
    ro, rl = varlen._varlen_plain(q, k, v, cu_q, cu_k, d ** -0.5, window[0], window[1],
                                  softcap, True, sinks, slopes)
    _close32(o, lse, ro, rl)


@pytest.mark.parametrize(
    "hq,hkv,page,d,quant,q_start,sq,lens,q_lens,window,softcap,sinks,alibi", [
        (32, 8, 64, 128, "int8", [0, 128, 320], 192, [192, 320, 370], None, (-1, 0),
         0.0, 0, False),                                       # the 8B chunk batch
        (32, 8, 64, 128, None, [0, 128, 320], 192, [192, 320, 370], None, (-1, 0),
         0.0, 0, False),
        (8, 2, 16, 128, None, [16, 0], 100, [116, 70], [100, 40], (10, 6), 0.0, 0,
         False),
        (32, 8, 64, 128, "fp8", [0, 128, 320], 192, [192, 320, 370], None, (-1, 0),
         0.0, 0, False),
        (16, 2, 32, 128, "int4", [96, 0], 64, [160, 64], None, (-1, 0), 20.0, 0, False),
        (4, 4, 64, 64, None, [64, 0], 130, [194, 100], None, (40, 0), 0.0, 0, False),
        (4, 4, 64, 64, "int4", [64, 0], 130, [194, 100], None, (40, 0), 0.0, 0, False),
        (8, 4, 64, 256, None, [0, 128, 320], 192, [192, 320, 370], None, (63, 0), 0.0,
         0, False),
        (8, 4, 64, 256, "int8", [1536, 64], 512, [2048, 576], None, (1023, 0), 0.0, 4,
         True),
        (28, 4, 64, 128, "int8", [0, 128, 320], 192, [192, 320, 370], None, (-1, 0),
         0.0, 0, False),                                       # group 7
        (40, 1, 64, 128, None, [0, 128, 320], 192, [192, 320, 370], None, (-1, 0), 0.0,
         0, False),                                            # group 40
        (64, 1, 16, 64, "fp8", [16, 0], 100, [116, 70], [100, 40], (10, 6), 0.0, 0,
         False),                                               # group 64
        (20, 4, 32, 80, None, [96, 0], 64, [160, 64], None, (-1, 0), 0.0, 0, True),
        (32, 8, 64, 128, None, [4608, 5120, 0, 4096], 512, [5120, 5632, 512, 4500],
         None, (4095, 0), 0.0, 4, True),
    ])
def test_paged_prefill_kernel_fp32(dev, hq, hkv, page, d, quant, q_start, sq, lens,
                                   q_lens, window, softcap, sinks, alibi):
    """Kernel 8 with fp32 q on fp32 and quantized pages, groups 1-64, rows
    past q_lens, rows past each length poisoned."""
    from mfa_tpu_torch.kernels import _build, paged_prefill

    gen = torch.Generator(device=dev).manual_seed(46)
    b, pps = len(lens), max(max(lens), 400) // page + 1
    P = b * pps + 3
    q = _rn(gen, b, sq, hq, d, dtype=F32)
    kf, vf = _rn(gen, hkv, P, page, d, dtype=F32), _rn(gen, hkv, P, page, d, dtype=F32)
    kp, vp, ks, vs = _pages(kf, vf, quant)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = (L - qs).clamp(min=0) if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device=dev)
    slopes = _alibi(hq, dev) if alibi else None
    ro, rl = paged_prefill._paged_prefill_plain(
        q, kp, vp, ks, vs, L, qs, ql, table, d ** -0.5, window[0], window[1], softcap,
        quant, sinks, slopes)
    _poison_past(kp, vp, ks, vs, quant, table, lens, page)
    _build.reset_launches()
    o, lse = paged_prefill.paged_prefill_attention(
        q, kp, vp, L, qs, table, q_lens=ql, k_scales=ks, v_scales=vs, causal=False,
        window_left=window[0], window_right=window[1], logit_softcap=softcap,
        quant_dtype=quant, sink_tokens=sinks, alibi_slopes=slopes, return_lse=True)
    assert dict(_build.launches) == {"paged_prefill_fp32": 1}
    (_close32 if quant is None else _close_quant32)(o, lse, ro, rl)


@pytest.mark.parametrize("b,hq,hkv,s,d,runs,window", [
    (2, 8, 4, 300, 256, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]], -1),
    (2, 8, 4, 300, 256, [[(10, 80), (150, 280)], [(63, 64), (127, 200)]], 32),
    (1, 4, 2, 517, 128, [[(0, 3), (100, 355)]], 64),
    (2, 4, 4, 129, 64, [[(60, 70)], []], 16),
    (3, 8, 1, 200, 128, [[], [], [(0, 199)]], -1),
    (2, 8, 4, 300, 80, [[(10, 80), (81, 200)], [(0, 299)]], 50),
])
def test_image_block_kernel_fp32(dev, b, hq, hkv, s, d, runs, window):
    """Kernel 9: kind IMAGE of the fp32 tile against the dense masked fp32
    softmax."""
    from mfa_tpu_torch.kernels import _build, blockmask

    gen = torch.Generator(device=dev).manual_seed(47)
    q, k, v = (_rn(gen, b, hq, s, d, dtype=F32), _rn(gen, b, hkv, s, d, dtype=F32),
               _rn(gen, b, hkv, s, d, dtype=F32))
    ids = _run_ids(b, s, runs, dev)
    _build.reset_launches()
    o = blockmask.image_block_prefill(q, k, v, ids, window_left=window)
    assert dict(_build.launches) == {"blockmask_fp32": 1}
    ref = blockmask._image_block_plain(q, k, v, ids, d ** -0.5, window)
    _close32(o, None, ref, None)


def test_fp32_entry_points(dev):
    """flash_attn_func, flash_attn_varlen_func and flash_attn_with_kvcache
    on fp32 tensors run the fp32 kernels and return fp32."""
    import mfa_tpu_torch
    from mfa_tpu_torch.kernels import _build

    gen = torch.Generator(device=dev).manual_seed(48)
    q, k, v = (_rn(gen, 2, 128, 8, 64, dtype=F32) for _ in range(3))
    _build.reset_launches()
    o = mfa_tpu_torch.flash_attn_func(q, k, v)   # BASELINE's first config: kernel 4
    cu = torch.tensor([0, 128, 256], device=dev, dtype=torch.int32)
    ov = mfa_tpu_torch.flash_attn_varlen_func(q.flatten(0, 1), k.flatten(0, 1),
                                              v.flatten(0, 1), cu, cu, 128, 128)
    kc, vc = _rn(gen, 2, 512, 8, 64, dtype=F32), _rn(gen, 2, 512, 8, 64, dtype=F32)
    od = mfa_tpu_torch.flash_attn_with_kvcache(q[:, :1], kc, vc, cache_seqlens=300)
    assert all(t.dtype == F32 and bool(torch.isfinite(t).all()) for t in (o, ov, od))
    got = dict(_build.launches)
    assert got["bound_fp32"] == 1 and got["varlen_fp32"] == 1
    assert got["decode_fp32"] == 1 and "combine_fp32" not in got
    assert not any(n in got for n in ("bound", "varlen", "decode", "combine"))


# -- fp32 inputs in the backward (kernels 11-14, csrc/flash_bwd_f32.cuh) and
# in the int8 matmul (kernel 10: three bf16 parts of x); launch names end in
# _fp32. Limits: allclose(rtol=1e-4, atol=1e-4 max |ref|) for the gradients
# (fp32 products in another order than the plain version's, and the fused
# launch's dQ additions across blocks), 1e-5 of the largest output for
# kernel 10 (x split exactly, W exact in bf16, fp32 accumulation).


def _bwd_close32(got, ref, what):
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == F32 and bool(torch.isfinite(g).all()), (what, name)
        err = float((g - r).abs().max())
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max())), (
            what, name, err)


_F32_BWD = [
    # b, hq, hkv, sq, sk, d, window, softcap, sinks, offset, alibi
    (2, 8, 2, 300, 300, 128, (-1, 0), 0.0, 0, 0, False),
    (1, 8, 2, 128, 512, 128, (-1, 0), 0.0, 0, 0, False),    # key tiles with no live row
    (1, 4, 4, 300, 8, 64, (4, 0), 0.0, 0, 0, False),        # dead rows
    (2, 4, 1, 100, 37, 64, (-1, -1), 0.0, 0, 0, False),
    (1, 4, 2, 130, 130, 128, (-1, 0), 30.0, 0, 0, False),   # softcap
    (1, 8, 2, 333, 333, 80, (-1, 0), 0.0, 0, 0, False),     # d 80 at D 128
    (1, 8, 4, 600, 600, 256, (127, 0), 0.0, 0, 0, False),
    (1, 4, 2, 130, 130, 256, (-1, 0), 50.0, 0, 0, False),
    (1, 28, 4, 300, 300, 128, (-1, 0), 0.0, 0, 0, False),   # group 7
    (1, 8, 2, 200, 1000, 128, (32, 0), 0.0, 0, 0, False),   # key blocks no row sees
    (1, 8, 2, 1100, 1100, 128, (255, 0), 0.0, 4, 0, False),  # sinks: the fused launch
    (1, 8, 2, 300, 300, 64, (31, 0), 0.0, 70, 0, False),
    (1, 8, 2, 512, 512, 128, (-1, 0), 0.0, 0, 0, True),     # ALiBi
    (1, 8, 2, 256, 640, 128, (-1, 0), 0.0, 0, 384, False),  # kv_position_offset
    (1, 8, 4, 200, 500, 256, (-1, 0), 0.0, 0, 300, True),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,softcap,sinks,offset,alibi", _F32_BWD)
def test_backward_kernels_fp32(dev, b, hq, hkv, sq, sk, d, window, softcap, sinks, offset,
                               alibi):
    from mfa_tpu_torch.kernels import _build, backward, prefill

    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator(device=dev).manual_seed(50)
    q, k, v, do = (_rn(gen, b, h, s, d, dtype=F32)
                   for h, s in ((hq, sq), (hkv, sk), (hkv, sk), (hq, sq)))
    slopes = _alibi(hq, dev) if alibi else None
    kw = dict(window_size=window, sink_tokens=sinks, kv_position_offset=offset,
              alibi_slopes=slopes, logit_softcap=softcap)
    o, lse = prefill.prefill_attention(q, k, v, return_lse=True, **kw)
    ref = backward._bwd_plain(q, k, v, o, lse, do, d ** -0.5, window[0], window[1],
                              softcap, sinks, offset, slopes)
    _build.reset_launches()
    fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
    assert dict(_build.launches) == {"bwd_fused_fp32": 1}
    _bwd_close32(fused, ref, "fused")
    dead = torch.isneginf(lse)
    assert torch.all(fused[0][dead] == 0)
    if sinks:
        with pytest.raises(NotImplementedError):
            backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
        return
    split = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert _build.launches["bwd_dkv_fp32"] == 1 and _build.launches["bwd_dq_fp32"] == 1
    _bwd_close32(split, ref, "split")
    again = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(split, again))  # deterministic
    assert torch.all(split[0][dead] == 0)


def _fp32_bwd_case(q, k, v, do, window, fused=True, ref=None):
    """Kernels 11 and 12 + 13 in fp32 on one input against _bwd_plain (or
    `ref`) -> the plain gradients."""
    from mfa_tpu_torch.kernels import backward, prefill

    d = q.shape[-1]
    o, lse = prefill.prefill_attention(q, k, v, window_size=window, return_lse=True)
    if ref is None:
        ref = backward._bwd_plain(q, k, v, o, lse, do, d ** -0.5, window[0], window[1], 0.0)
    if fused:
        _bwd_close32(backward.flash_attention_bwd(q, k, v, o, lse, do, window_size=window),
                     ref, "fused")
    split = backward.flash_attention_bwd(q, k, v, o, lse, do, window_size=window, fused=False)
    _bwd_close32(split, ref, "split")
    dead = torch.isneginf(lse)
    assert torch.all(split[0][dead] == 0)
    return o, lse, ref


# the fp32 tile's block sizes: R own rows (keys, or q rows for dQ: 128 / 64 /
# 32 at D 64 / 128 / 256) and walked tiles of C = 32 rows
_F32_EDGE = sorted({(d, sq, sk) for d, r in ((64, 128), (128, 64), (256, 32))
                    for sq, sk in ((r - 1, r + 1), (r + 1, r - 1), (31, 33), (33, 31))})


@pytest.mark.parametrize("d,sq,sk", _F32_EDGE)
@pytest.mark.parametrize("window", [(-1, 0), (-1, -1)])
def test_backward_kernels_fp32_tile_edges(dev, d, sq, sk, window):
    """sq and sk one under and one over the fp32 tile's block sizes at each
    D (kernels 11, 12 + 13), causal and not, group 2."""
    gen = torch.Generator(device=dev).manual_seed(56)
    q, do = (_rn(gen, 1, 4, sq, d, dtype=F32) for _ in range(2))
    k, v = (_rn(gen, 1, 2, sk, d, dtype=F32) for _ in range(2))
    _fp32_bwd_case(q, k, v, do, window)


def test_backward_kernels_fp32_larger_scores_need_three_products(dev):
    """tests/test_torch_fp32.py's larger-score input (numpy seed 0, q and k x
    3, b1 hq4 hkv2 s256 d128, causal): one TF32 pass (hi.hi) of the plain
    version misses the fp32 limit and the kernels keep it, so their
    products are not one pass."""
    import numpy as np

    from mfa_tpu_torch.kernels import backward

    rng = np.random.RandomState(0)
    q = rng.standard_normal((1, 4, 256, 128)) * 3.0
    k = rng.standard_normal((1, 2, 256, 128)) * 3.0
    v, do = rng.standard_normal((1, 2, 256, 128)), rng.standard_normal((1, 4, 256, 128))
    q, k, v, do = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (q, k, v, do))
    o, lse, ref = _fp32_bwd_case(q, k, v, do, (-1, 0))

    def one_pass(a, b):
        return backward._split_tf32_plain(a)[0] @ backward._split_tf32_plain(b)[0]

    one = backward._bwd_plain(q, k, v, o, lse, do, 128 ** -0.5, -1, 0, 0.0, matmul=one_pass)
    assert not all(torch.allclose(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
                   for g, r in zip(one, ref))


@pytest.mark.parametrize("lens_q,lens_k,hq,hkv,d,window,softcap,alibi", [
    ([200, 1100, 0, 513], [200, 1100, 0, 513], 8, 2, 128, (-1, 0), 0.0, False),
    ([100, 300], [256, 400], 8, 2, 64, (64, 32), 0.0, False),
    ([300, 0, 517, 64], [300, 0, 517, 64], 8, 4, 256, (-1, 0), 0.0, True),
    ([130, 70], [130, 70], 4, 2, 128, (-1, 0), 30.0, False),
    ([90, 45], [90, 45], 7, 1, 80, (-1, 0), 0.0, False),
])
def test_varlen_backward_kernels_fp32(dev, lens_q, lens_k, hq, hkv, d, window, softcap,
                                      alibi):
    from mfa_tpu_torch.kernels import _build, backward, varlen

    gen = torch.Generator(device=dev).manual_seed(51)
    q, do = _rn(gen, sum(lens_q), hq, d, dtype=F32), _rn(gen, sum(lens_q), hq, d, dtype=F32)
    k, v = _rn(gen, sum(lens_k), hkv, d, dtype=F32), _rn(gen, sum(lens_k), hkv, d, dtype=F32)
    cu_q = torch.tensor([0] + lens_q, device=dev).cumsum(0).int()
    cu_k = torch.tensor([0] + lens_k, device=dev).cumsum(0).int()
    slopes = _alibi(hq, dev) if alibi else None
    kw = dict(window_size=window, logit_softcap=softcap, alibi_slopes=slopes)
    o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lens_q), max(lens_k),
                                     return_lse=True, **kw)
    _build.reset_launches()
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu_q, cu_k, **kw)
    assert dict(_build.launches) == {"varlen_bwd_dkv_fp32": 1, "varlen_bwd_dq_fp32": 1}
    ref = backward._varlen_bwd_plain(q, k, v, o, lse, do, cu_q, cu_k, d ** -0.5, window[0],
                                     window[1], softcap, slopes)
    _bwd_close32(got, ref, "varlen")


def test_varlen_backward_fp32_equals_dense_bit_for_bit(dev):
    """Kernel 14 in fp32 on 4 x 256 equal lengths gives kernels 12 + 13's
    bits on the same data batched (one tile body, two addressings)."""
    from mfa_tpu_torch.kernels import backward, varlen

    n, s, hq, hkv, d = 4, 256, 8, 2, 128
    gen = torch.Generator(device=dev).manual_seed(52)
    q, do = _rn(gen, n * s, hq, d, dtype=F32), _rn(gen, n * s, hq, d, dtype=F32)
    k, v = _rn(gen, n * s, hkv, d, dtype=F32), _rn(gen, n * s, hkv, d, dtype=F32)
    cu = torch.arange(0, n * s + 1, s, device=dev, dtype=torch.int32)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, s, s, causal=True, return_lse=True)
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)

    def batched(t):  # [n * s, h, d] -> [n, h, s, d]
        return t.view(n, s, t.shape[1], d).transpose(1, 2).contiguous()

    dense = backward.flash_attention_bwd(
        batched(q), batched(k), batched(v), batched(o), lse.view(hq, n, s).transpose(0, 1),
        batched(do), causal=True, fused=False)
    assert all(torch.equal(batched(a), b_) for a, b_ in zip(got, dense))


@pytest.mark.parametrize("m,K,N", [
    (16, 4096, 4096),     # decode: wq, split K
    (16, 4096, 1024),     # wk
    (16, 14336, 4096),    # w_down
    (16, 4096, 14336),    # w_gate
    (1, 4096, 4096),      # one row
    (17, 4096, 4096),     # 32 rows a block
    (40, 14336, 1024),    # 64 rows a block, 8 splits
    (130, 384, 272),      # 128 rows a block, ragged m, N % 128 != 0
    (3, 80, 48),          # K % 64 != 0
    (300, 1040, 400),     # 128 rows a block past 256 rows (fp32 x), K and N tails
    (3601, 4096, 14336),  # a prefill wave at w_gate
])
def test_int8_matmul_kernel_fp32(dev, m, K, N):
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator(device=dev).manual_seed(53)
    x = _rn(gen, m, K, dtype=F32)
    w = quantize_weight(torch.randn(K, N, generator=gen, device=dev) * K ** -0.5)
    _build.reset_launches()
    out = wmatmul.int8_matmul(x, w.qw, w.scale)
    assert dict(_build.launches) == {"wmatmul_fp32": 1}
    assert out.dtype == F32 and out.shape == (m, N)
    assert torch.equal(out, wmatmul.int8_matmul(x, w.qw, w.scale))
    ref = wmatmul._int8_matmul_plain(x, w.qw, w.scale, F32)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with pytest.raises(NotImplementedError):
        wmatmul.int8_matmul(x, w.qw, w.scale, out_dtype=BF)


def test_int8_matmul_fp32_split_prepass(dev):
    """The pre-pass alone: mfa_int8_matmul's bf16 parts of fp32 x equal the
    plain split bit for bit, and add back to x exactly, over magnitudes
    1e-30 to 1e30."""
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(54)
    m, K, N = 48, 256, 128
    x = (torch.randn(m, K, generator=gen, device=dev)
         * 10.0 ** (torch.rand(m, K, generator=gen, device=dev) * 60 - 30)).float()
    w = quantize_weight(torch.randn(K, N, generator=gen, device=dev))
    x3 = torch.empty((3, m, K), dtype=BF, device=dev)
    out = torch.empty((m, N), dtype=F32, device=dev)
    splits, per = wmatmul.split_k(m, K, N, f32=True)
    fn = _build.function("wmatmul", "mfa_int8_matmul", wmatmul._ARGTYPES)
    rc = fn(x.data_ptr(), w.qw.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
            x3.data_ptr(), _build.DTYPE_CODES[F32], 1, m, K, N, splits, per,
            _build.stream_of(x))
    _build.check("wmatmul", rc)
    torch.cuda.synchronize()
    want = wmatmul._split_bf16x3_plain(x)
    assert all(torch.equal(x3[i], want[i]) for i in range(3))
    assert torch.equal(sum(p.double() for p in x3.unbind(0)), x.double())


@pytest.mark.parametrize("form", ["shared", "per_expert", "grouped"])
def test_int8_bank_fp32(dev, form):
    from mfa_tpu_torch.kernels import _build, wmatmul
    from mfa_tpu_torch.models.wquant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(55)
    E, K, N = 8, 4096, 14336
    w = quantize_weight(torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5)
    offs = None
    if form == "grouped":
        sizes = (900, 1, 0, 1200, 2001, 1500, 800, 800)
        x = _rn(gen, sum(sizes), K, dtype=F32)
        offs = torch.tensor([0, *torch.tensor(sizes).cumsum(0).tolist()],
                            dtype=torch.int32, device=dev)
    else:
        x = _rn(gen, *((E,) if form == "per_expert" else ()), 16, K, dtype=F32)
    _build.reset_launches()
    out = wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs)
    assert dict(_build.launches) == {"wmatmul_bank_fp32": 1}
    assert out.dtype == F32
    ref = wmatmul._bank_plain(x, w.qw, w.scale, offs, F32)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_fp32_train_step_and_int8_forward_on_the_card(dev):
    """A tiny fp32 model: its int8-weight forward (the embedding kept fp32,
    so x stays fp32: kernel 10 in fp32) within relative L2 1e-4 of the
    CPU's logits; then one SGD step on the card (kernels 2 + 3 and 11 in
    fp32) against the CPU's plain step, the loss within relative 1e-5 and
    every gradient within relative L2 1e-4."""
    import numpy as np

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama, wquant

    cfg = llama.LlamaConfig.tiny(vocab=256, dim=256, layers=2, heads=4, kv_heads=2,
                                 ffn=512)
    assert cfg.dtype == F32
    p_gpu = llama.init_params(cfg, seed=3, device=dev)
    p_cpu = dict(layers=[{k: t.cpu() for k, t in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 129))
    with torch.no_grad():
        _build.reset_launches()
        a = llama.forward(wquant.quantize_params(p_gpu, include_embed=False),
                          torch.as_tensor(toks, device=dev), cfg)
        assert _build.launches["wmatmul_fp32"] == 7 * cfg.n_layers + 1
        r = llama.forward(wquant.quantize_params(p_cpu, include_embed=False),
                          torch.as_tensor(toks), cfg)
    assert a.dtype == F32
    assert float((a.cpu() - r).norm()) <= 1e-4 * float(r.norm())
    res = {}
    for name, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        _build.reset_launches()
        params, loss = llama.train_step(params, toks, cfg, lr=0.1)
        res[name] = (float(loss), [p.grad.cpu() for p in llama.param_tensors(params)],
                     dict(_build.launches))
    assert res["cuda"][2].get("bwd_fused_fp32") == cfg.n_layers
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for g, r in zip(res["cuda"][1], res["cpu"][1]):
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-12
