#!/usr/bin/env python3
"""Time kernel 9 (image-block prefill) and kernel 8 (paged prefill) against
their bounds and the library call where there is one, on one GPU.

    python3 scripts/time_paged_blockmask.py [--root DIR] [--label NAME]
        [--dtype bfloat16|float32] [--kernels 9,8,6]

Kernel 9 at chip_smoke.py's four image cases (Gemma3-4B's image wave b4
hq8 hkv4 s2048 d256 with one 256-token run at 700 and window 1023, the
same without the window, two runs across tile edges at s 1000 with window
255, and d 128 at s 777 with a run 250-520 and window 127), against
scaled_dot_product_attention with the boolean mask, and beside it kernel 1
(the same band without the runs) as the floor it can reach. Kernel 8 at the 8B
engine's chunk batch (hq32 hkv8 d128, 4 x 512 chunks at q_start
0/1024/2048/3072, int8 pages of 64), the same on int8 pages of 16 tokens
and on bf16 pages of 64 (the int8 conversion's share), and the varlen paged
route's shape (bf16 pages of 64, q_start 0, lens
512/1024/300/700); no single PyTorch call computes it. All bf16 from seed
0, each output held against its plain version (max 2e-2, mean 2e-3).
Times are CUDA-event means (chip_smoke._time_ms); the bound is the larger
of the bytes (each input once, each output once) over 3.35 TB/s and 4 d
flops per visible (row, key) pair of every q head over 989 TFLOP/s.
--root imports mfa_tpu_torch from another checkout (e.g. the parent
commit unpacked with git archive), so two versions compare in one call.
Prints one line per kernel and shape, and the card's name and power limit.

--dtype float32 times the fp32 tiles instead, at PERF.md's fp32 rows:
kernel 9 at Gemma3-4B's image wave (beside SDPA + bool mask on the fp32
tensors), kernel 8 with fp32 q at the chunk batch (4 x 512 at q_start
0-3072, hq32 hkv8 d128, pages of 64) on int8, fp32, fp8 and int4 pages,
and kernel 6 with fp32 q at the 8B serve step (b16, lens 300 - 7 i,
pos_offset 1) on the same four formats and at lens 8192 on fp32 and int8
pages. Each held against its plain fp32 version: atol = rtol = 1e-4 on
fp32 inputs and pages (O and LSE, chip_smoke._err32), the bf16-q case's
limits on quantized pages; bounds as chip_smoke.py's fp32 phase (4-byte
rows, or the page bytes, at 3.35 TB/s against 4 d flops a visible pair
at 165 TFLOP/s, or at 494.5 on quantized pages: chip_smoke._peak32).
TF32 stays off for the plain versions and SDPA. --kernels keeps some of
the fp32 rows (9, 8, 6).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMAGE_CASES = (  # tag, b, hq, hkv, s, d, runs, window left
    ("image wave, run 700-955, window 1023", 4, 8, 4, 2048, 256, [(700, 955)], 1023),
    ("image wave, run 700-955, no window", 4, 8, 4, 2048, 256, [(700, 955)], -1),
    ("two runs, s 1000, window 255", 2, 8, 4, 1000, 256, [(100, 200), (383, 700)], 255),
    ("d 128, s 777, run 250-520, window 127", 2, 16, 8, 777, 128, [(250, 520)], 127),
)
PAGED_CASES = (  # tag, int8 pages, page, q_start, sq, q_lens
    ("chunk batch, int8 pages of 64", True, 64, [0, 1024, 2048, 3072], 512, None),
    ("chunk batch, int8 pages of 16", True, 16, [0, 1024, 2048, 3072], 512, None),
    ("chunk batch, bf16 pages of 64", False, 64, [0, 1024, 2048, 3072], 512, None),
    ("varlen paged route, bf16 pages of 64", False, 64, [0, 0, 0, 0], 1024,
     [512, 1024, 300, 700]),
)


def _check(out, ref, what):
    import torch

    err = (out.float() - ref.float()).abs()
    good = bool(torch.isfinite(out.float()).all()) and float(err.max()) < 2e-2 \
        and float(err.mean()) < 2e-3
    return good, f" max_abs_err {float(err.max()):.3e}{'' if good else ' FAIL ' + what}"


def image_cases(cs, label, gen):
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import blockmask, prefill

    ok = True
    for tag, b, hq, hkv, s, d, runs, wl in IMAGE_CASES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        ids = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
        for gi, (a, z) in enumerate(runs):
            ids[:, a:z + 1] = gi
        o = blockmask.image_block_prefill(q, k, v, ids, window_left=wl)
        ro = blockmask._image_block_plain(q.float(), k.float(), v.float(), ids, d ** -0.5, wl)
        good, note = _check(o, ro, tag)
        ok &= good
        mask = blockmask.block_mask(ids, wl)
        ms = cs._time_ms(lambda: blockmask.image_block_prefill(q, k, v, ids, window_left=wl))
        k1 = cs._time_ms(lambda: prefill.prefill_attention(
            q, k, v, causal=True, window_size=(wl, -1), bound_softmax=False))
        lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], enable_gqa=True))
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + ids.numel() * 4
        bound_ms, by = cs._bound(nbytes, 4 * hq * int(mask.sum()) * d)
        print(f"{label} kernel 9 {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound "
              f"share {bound_ms / ms:.3f} library_ms(sdpa + bool mask) {lib_ms:.4f} "
              f"({ms / lib_ms:.2f}x); kernel 1 without the runs {k1:.4f}{note}", flush=True)
        del q, k, v, o, ro, mask
        torch.cuda.empty_cache()
    return ok


def paged_cases(cs, label, gen):
    import torch

    from mfa_tpu_torch.kernels import paged_prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    hq, hkv, d = 32, 8, 128
    ok = True
    for tag, quant, page, q_start, sq, q_lens in PAGED_CASES:
        b = len(q_start)
        q_lens = q_lens or [sq] * b
        lens = [st + n for st, n in zip(q_start, q_lens)]
        pps = max(lens) // page + 1
        P = b * pps + 1
        q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        if quant:
            (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
        else:
            kp, vp, ks, vs = kf, vf, None, None
        table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                 ).reshape(b, pps).to(torch.int32)
        L, QS, QL = (torch.tensor(x, dtype=torch.int32, device="cuda")
                     for x in (lens, q_start, q_lens))

        def run():
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs, causal=True)

        ro, _ = paged_prefill._paged_prefill_plain(
            q.float(), kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, -1, 0, 0.0)
        good, note = _check(run(), ro, tag)
        ok &= good
        ms = cs._time_ms(run)
        kv_rows = sum(-(-n // page) * page for n in lens) * hkv
        nbytes = 2 * kv_rows * d * kp.element_size() + (8 * kv_rows if quant else 0) \
            + b * pps * 4 + 2 * b * sq * hq * d * 2
        pairs = sum(cs._visible_pairs(n, n_k, st, -1, 0)
                    for st, n, n_k in zip(q_start, q_lens, lens))
        bound_ms, by = cs._bound(nbytes, 4 * hq * pairs * d)
        print(f"{label} kernel 8 {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound "
              f"share {bound_ms / ms:.3f} library_ms none{note}", flush=True)
        del q, kf, vf, kp, vp, ro
        torch.cuda.empty_cache()
    return ok


def _line32(cs, label, what, ms, nbytes, flops, lib_ms=None, note="", quant=None):
    bound_ms, by = cs._bound32(nbytes, flops, cs._peak32(quant))
    lib = f" sdpa_ms {lib_ms:.4f} (/ sdpa {ms / lib_ms:.2f}x)" if lib_ms else " library_ms none"
    print(f"{label} float32 {what}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) share "
          f"{bound_ms / ms:.3f}{lib}{note}", flush=True)


def _check32(cs, out, lse, ref, ref_lse, quant, what):
    if quant is None:
        return cs._err32(out, ref, what, lse, ref_lse)[1]
    return cs._err(out, ref, what=what)[1] and cs._lse_err(lse, ref_lse, what)


def fp32_cases(cs, label, gen, kernels=("9", "8", "6")) -> bool:
    """The fp32 rows of kernels 9, 8 and 6 (see the module docstring), of
    those in `kernels`."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import blockmask, paged, paged_prefill

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    ok = True
    if "9" in kernels:
        b, hq, hkv, s, d = 4, 8, 4, 2048, 256  # kernel 9
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        ids = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
        ids[:, 700:956] = 0
        vis = blockmask.block_mask(ids, 1023)
        ok &= cs._err32(blockmask.image_block_prefill(q, k, v, ids, window_left=1023),
                        blockmask._image_block_plain(q, k, v, ids, d ** -0.5, 1023), "kernel 9")[1]
        _line32(cs, label, "kernel 9 image wave", cs._time_ms(
            lambda: blockmask.image_block_prefill(q, k, v, ids, window_left=1023)),
            4 * (2 * q.numel() + 2 * k.numel()) + 4 * b * s, 4 * hq * float(vis.sum()) * d,
            cs._time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis[:, None],
                                                               enable_gqa=True)))
        del q, k, v, vis
        torch.cuda.empty_cache()
    hq, hkv, d, page = 32, 8, 128, 64
    if "8" in kernels:  # the engine chunk batch
        q_start, sq = [0, 1024, 2048, 3072], 512
        lens = [s0 + sq for s0 in q_start]
        b, pps = 4, max(lens) // page + 1
        P = b * pps + 3
        q = rn(b, sq, hq, d)
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
              ).reshape(b, pps).int()
        L, QS = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, q_start))
        QL = L - QS
        pairs = sum(cs._visible_pairs(sq, n, s0, -1, 0) for s0, n in zip(q_start, lens))
        for quant in ("int8", None, "fp8", "int4"):
            kp, vp, ks, vs = cs._pages32(kf, vf, quant)

            def run():
                return paged_prefill.paged_prefill_attention(
                    q, kp, vp, L, QS, bt, q_lens=QL, k_scales=ks, v_scales=vs, quant_dtype=quant,
                    return_lse=True)

            ro, rl = paged_prefill._paged_prefill_plain(q, kp, vp, ks, vs, L, QS, QL, bt,
                                                        d ** -0.5, -1, 0, 0.0, quant)
            ok &= _check32(cs, *run(), ro, rl, quant, f"kernel 8 {quant or 'fp32'} pages")
            _line32(cs, label, f"kernel 8 chunk batch, {quant or 'fp32'} pages", cs._time_ms(run),
                    2 * sum(lens) * hkv * cs._row_bytes32(quant, d) + 2 * b * sq * hq * d * 4,
                    4 * hq * pairs * d, quant=quant)
            del kp, vp, ks, vs
        del q, kf, vf
        torch.cuda.empty_cache()
    for quant, lens in ((None, None), ("int8", None), ("fp8", None), ("int4", None),
                        (None, [8192] * 16), ("int8", [8192] * 16)) if "6" in kernels else ():
        lens = lens or [300 - 7 * i for i in range(16)]
        b, pps = len(lens), max(lens) // page + 1
        P = b * pps + 1
        q = rn(b, hq, d)
        kp, vp, ks, vs = cs._pages32(rn(hkv, P, page, d), rn(hkv, P, page, d), quant)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
              ).reshape(b, pps).int()
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def run():
            return paged.paged_attention(q, kp, vp, L, bt, k_scales=ks, v_scales=vs,
                                         pos_offset=1, quant_dtype=quant, return_lse=True)

        ro, rl = paged._paged_plain(q, kp, vp, ks, vs, L, bt, d ** -0.5, -1, 0.0, 1, quant)
        ok &= _check32(cs, *run(), ro, rl, quant, f"kernel 6 {quant or 'fp32'} pages")
        rows = sum(lens) * hkv
        _line32(cs, label, f"kernel 6 serve step, {quant or 'fp32'} pages, lens {max(lens)}",
                cs._time_ms(run), 2 * rows * cs._row_bytes32(quant, d) + b * pps * 4
                + 2 * b * hq * d * 4 + b * hq * 4, 4 * (hq // hkv) * rows * d, quant=quant)
        del q, kp, vp, ks, vs
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--kernels", default="9,8,6", help="fp32 rows to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing and bound helpers of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import blockmask

    print(f"mfa_tpu_torch from {os.path.dirname(blockmask.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        if args.dtype == "float32":
            ok = fp32_cases(cs, args.label, gen, args.kernels.split(","))
        else:
            ok = image_cases(cs, args.label, gen)
            ok &= paged_cases(cs, args.label, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
