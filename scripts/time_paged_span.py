#!/usr/bin/env python3
"""Time kernel 6 (paged decode) on multi-query spans and at q_span = 1,
and kernel 5 (split-KV decode), on one GPU.

    python3 scripts/time_paged_span.py [--root DIR] [--label NAME]

Kernel 6 at the Llama-3-8B verify shape of speculative decoding (b16, a
span of 4 queries, hq32 hkv8 d128, pages of 64, lengths 195-300,
pos_offset 4: the stored cache, the span's own rows merged by the
caller), beside q_span = 1 at the same lengths (pos_offset 1: the decode
step), each on bf16, int8, fp8 and int4 pages; then groups of 16 q heads a
kv head at q_span = 1 (hq32 hkv2, int8 and bf16 pages); then kernel 5 at
b16 hq32 hkv8 S8192 d128 (its PERF.md shape). Each output is held to its
plain version (max 2e-2, mean 2e-3, LSE 1e-3 with the same -inf rows).
Times are CUDA-event means (chip_smoke._time_ms) of the whole call; the
bound is the larger of the bytes (each visible K/V row once: 2 d bytes
bf16, d + 4 int8 and fp8, d / 2 + 4 int4, with its scale; q, O, LSE and
the table) over 3.35 TB/s and the operations (4 d flops per visible
(query row, key) pair) over 989 TFLOP/s. No single PyTorch call computes
kernel 6's function; kernel 5 beside SDPA.
--root imports mfa_tpu_torch from another checkout (e.g. the parent
commit unpacked with git archive), so two versions compare in one call;
what that checkout refuses (spans, groups above 8) prints "not taken".
Prints one line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = (None, "int8", "fp8", "int4")  # None: bf16 pages
VERIFY_LENS = [300 - 7 * i for i in range(16)]  # 195-300


def _name(quant):
    return quant or "bf16"


def _row_bytes(quant, d):
    return {None: 2 * d, "int8": d + 4, "fp8": d + 4, "int4": d // 2 + 4}[quant]


def _pages(kf, vf, quant):
    from mfa_tpu_torch.kernels import quant as q

    if quant is None:
        return kf, vf, None, None
    (kp, ks), (vp, vs) = q.quantize_rows(kf, quant), q.quantize_rows(vf, quant)
    if quant == "int4":
        kp, vp = q.pack_int4(kp), q.pack_int4(vp)
    return kp, vp, ks, vs


def _close(o, lse, ro, rl):
    import torch

    err = (o.float() - ro.float()).abs()
    fin = torch.isfinite(rl)
    return bool(torch.isfinite(o.float()).all()) and float(err.max()) < 2e-2 \
        and float(err.mean()) < 2e-3 \
        and torch.equal(torch.isneginf(lse), torch.isneginf(rl)) \
        and float((lse[fin] - rl[fin]).abs().max()) < 1e-3, float(err.max())


def paged_case(cs, label, gen, tag, span, hq, hkv, formats, lens=VERIFY_LENS,
               d=128):
    """Kernel 6 at one shape on each format; span > 1 takes q [b, span, hq,
    d] with pos_offset = span, span 1 q [b, hq, d] with pos_offset 1."""
    import torch

    from mfa_tpu_torch.kernels import paged

    b, page = len(lens), 64
    pps = max(lens) // page + 1
    P = b * pps + 1
    shape = (b, span, hq, d) if span > 1 else (b, hq, d)
    q = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
             ).reshape(b, pps).to(torch.int32)
    L = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pos_offset = span if span > 1 else 1
    rows = sum(lens) * hkv  # every row of the span sees the stored cache
    ok = True
    for quant in formats:
        kp, vp, ks, vs = _pages(kf, vf, quant)
        kw = dict(k_scales=ks, v_scales=vs, pos_offset=pos_offset, return_lse=True)
        if quant in ("fp8", "int4"):
            kw["quant_dtype"] = quant

        def run():
            return paged.paged_attention(q, kp, vp, L, table, **kw)

        try:
            o, lse = run()
        except (NotImplementedError, ValueError) as e:
            print(f"{label} kernel 6 {tag}, {_name(quant)} pages: not taken by this "
                  f"checkout ({type(e).__name__})", flush=True)
            continue
        ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5,
                                    -1, 0.0, pos_offset, quant_dtype=quant)
        good, mx = _close(o, lse, ro, rl)
        ok &= good
        ms = cs._time_ms(run)
        plain_ms = cs._time_ms(lambda: paged._paged_plain(
            q, kp, vp, ks, vs, L, table, d ** -0.5, -1, 0.0, pos_offset,
            quant_dtype=quant), iters=3)
        nbytes = 2 * rows * _row_bytes(quant, d) + b * pps * 4 \
            + 2 * b * span * hq * d * 2 + b * span * hq * 4
        bound_ms, by = cs._bound(nbytes, 4 * span * hq // hkv * rows * d)
        print(f"{label} kernel 6 {tag}, {_name(quant)} pages: ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bound_ms:.6f} ({by}) bound share "
              f"{bound_ms / ms:.3f} splits {paged.split_plan(b, hkv, pps, page)[0]} "
              f"library_ms none max_abs_err {mx:.3e}{'' if good else ' FAIL'}",
              flush=True)
        del kp, vp, o, lse, ro, rl
    del q, kf, vf
    torch.cuda.empty_cache()
    return ok


def decode_case(cs, label, gen):
    """Kernel 5 at b16 hq32 hkv8 S8192 d128 beside SDPA."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import decode

    b, hq, hkv, S, d = 16, 32, 8, 8192, 128
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(b, hkv, S, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    L = torch.full((b,), S, dtype=torch.int32, device="cuda")
    o = decode.decode_attention(q, kc, vc, L)
    ref = F.scaled_dot_product_attention(q[:, :, None].float(), kc.float(), vc.float(),
                                         enable_gqa=True)[:, :, 0]
    err = float((o.float() - ref).abs().max())
    ms = cs._time_ms(lambda: decode.decode_attention(q, kc, vc, L))
    lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, enable_gqa=True))
    bound_ms, by = cs._bound(2 * b * hkv * S * d * 2 + 2 * b * hq * d * 2,
                             4 * b * hq * S * d)
    print(f"{label} kernel 5 b16 hq32 hkv8 S8192 d128 bf16: ms {ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({by}) library_ms(sdpa) {lib_ms:.4f} max_abs_err "
          f"{err:.3e}{'' if err < 2e-2 else ' FAIL'}", flush=True)
    return err < 2e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing and bound helpers of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import paged

    print(f"mfa_tpu_torch from {os.path.dirname(paged.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    label, ok = args.label, True
    with torch.no_grad():
        ok &= paged_case(cs, label, gen, "8B verify shape, span 4", 4, 32, 8, FORMATS)
        ok &= paged_case(cs, label, gen, "8B decode step, q_span 1", 1, 32, 8, FORMATS)
        ok &= paged_case(cs, label, gen, "group 16, q_span 1 (hq32 hkv2)", 1, 32, 2,
                         ("int8", None))
        ok &= decode_case(cs, label, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
