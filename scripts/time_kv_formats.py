#!/usr/bin/env python3
"""Time kernel 6 (paged decode) and kernel 8 (paged prefill) on bf16,
int8, fp8 (e4m3) and int4 KV pages, on one GPU.

    python3 scripts/time_kv_formats.py [--root DIR] [--label NAME] [--no-sweep]

Kernel 6 at chip_smoke.py's shapes: the Llama-3-8B serve step (b16 hq32
hkv8 d128, pages of 64, lengths 195-300, pos_offset 1), Gemma3-4B's
decode step (b10 hq8 hkv4 d256, lengths 300-2000, window 1023: 3 splits)
and lengths 8192 (the 8B heads); then a sweep of the
8B heads at lengths 512 to 32768 on int8, fp8 and int4 pages, whose
int4 / int8 time ratio gives dispatch/config.py's
INT4_KV_CROSSOVER_TOKENS: the first length from which int4 pages are
read faster than int8 pages at every swept length. Kernel 8 at the
engine's chunk batch (4 x 512 at q_start 0/1024/2048/3072, the 8B heads,
pages of 64). Each output is held to its plain version (max 2e-2, mean
2e-3, LSE 1e-3 with the same -inf rows). Times are CUDA-event means
(chip_smoke._time_ms) of the whole call at the wrapper's split count (one
launch; before the split merge moved into it, past one split a combine
launch too); the bound is the larger of the bytes
(each visible K/V row once: 2 d bytes bf16, d + 4 int8 and fp8, d / 2 + 4
int4, with its scale; q, O, LSE and the table) over 3.35 TB/s and the
operations (4 d flops per visible (row, key) pair of every q head) over
989 TFLOP/s. No single PyTorch call computes these functions.
--root imports mfa_tpu_torch from another checkout (e.g. the parent
commit unpacked with git archive), so two versions compare in one call;
formats that checkout does not take are reported as such. Prints one line
per kernel, format and shape, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = (None, "int8", "fp8", "int4")  # None: bf16 pages
SWEEP = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def _name(quant):
    return quant or "bf16"


def _pages(kf, vf, quant):
    """Float pages in `quant`'s format, or None where this checkout does
    not take the format."""
    from mfa_tpu_torch.kernels import quant as q

    if quant is None:
        return kf, vf, None, None
    try:
        (kp, ks), (vp, vs) = q.quantize_rows(kf, quant), q.quantize_rows(vf, quant)
    except (NotImplementedError, ValueError):
        return None
    if quant == "int4":
        kp, vp = q.pack_int4(kp), q.pack_int4(vp)
    return kp, vp, ks, vs


def _quant_kw(quant):
    """quant_dtype for the calls: int8 pages name none, as every checkout
    takes them so."""
    return {} if quant in (None, "int8") else {"quant_dtype": quant}


def _row_bytes(quant, d):
    return {None: 2 * d, "int8": d + 4, "fp8": d + 4, "int4": d // 2 + 4}[quant]


def _close(o, lse, ro, rl):
    import torch

    err = (o.float() - ro.float()).abs()
    fin = torch.isfinite(rl)
    return bool(torch.isfinite(o.float()).all()) and float(err.max()) < 2e-2 \
        and float(err.mean()) < 2e-3 \
        and torch.equal(torch.isneginf(lse), torch.isneginf(rl)) \
        and float((lse[fin] - rl[fin]).abs().max()) < 1e-3, float(err.max())


def decode_case(cs, label, gen, tag, b, hq, hkv, d, lens, wl, formats, check=True):
    """Kernel 6 on each format at one shape -> {format: ms}."""
    import torch

    from mfa_tpu_torch.kernels import paged

    page = 64
    pps = max(lens) // page + 1
    P = b * pps + 1
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
             ).reshape(b, pps).to(torch.int32)
    L = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = sum(min(n, wl) if wl >= 0 else n for n in lens) * hkv  # visible, pos_offset 1
    times, ok = {}, True
    for quant in formats:
        pages = _pages(kf, vf, quant)
        if pages is None:
            print(f"{label} kernel 6 {tag}, {_name(quant)} pages: not taken by this "
                  f"checkout", flush=True)
            continue
        kp, vp, ks, vs = pages

        def run():
            return paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                         window_left=wl, pos_offset=1, return_lse=True,
                                         **_quant_kw(quant))

        o, lse = run()
        good, mx = True, float("nan")
        if check:
            ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5,
                                        wl, 0.0, 1, **_quant_kw(quant))
            good, mx = _close(o, lse, ro, rl)
            del ro, rl
        ok &= good
        ms = cs._time_ms(run)
        times[quant] = ms
        nbytes = 2 * rows * _row_bytes(quant, d) + b * pps * 4 + 2 * b * hq * d * 2 \
            + b * hq * 4
        bound_ms, by = cs._bound(nbytes, 4 * hq // hkv * rows * d)
        print(f"{label} kernel 6 {tag}, {_name(quant)} pages: ms {ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f} splits "
              f"{paged.split_plan(b, hkv, pps, page)[0]} library_ms none max_abs_err "
              f"{mx:.3e}{'' if good else ' FAIL'}", flush=True)
        del kp, vp, o, lse
    del q, kf, vf
    torch.cuda.empty_cache()
    return times, ok


def prefill_case(cs, label, gen):
    """Kernel 8 at the engine's chunk batch on each format."""
    import torch

    from mfa_tpu_torch.kernels import paged_prefill

    hq, hkv, d, page, sq = 32, 8, 128, 64, 512
    q_start = [0, 1024, 2048, 3072]
    lens = [s + sq for s in q_start]
    b, pps = len(lens), max(lens) // page + 1
    P = b * pps + 1
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
             ).reshape(b, pps).to(torch.int32)
    L, QS = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, q_start))
    QL = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    pairs = sum(cs._visible_pairs(sq, n, s, -1, 0) for s, n in zip(q_start, lens))
    ok = True
    for quant in FORMATS:
        pages = _pages(kf, vf, quant)
        if pages is None:
            print(f"{label} kernel 8 chunk batch 4 x 512, {_name(quant)} pages: not "
                  f"taken by this checkout", flush=True)
            continue
        kp, vp, ks, vs = pages

        def run(lse=False):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, return_lse=lse, **_quant_kw(quant))

        o, lse = run(True)
        ro, rl = paged_prefill._paged_prefill_plain(
            q.float(), kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, -1, 0, 0.0,
            **_quant_kw(quant))
        good, mx = _close(o, lse, ro, rl)
        ok &= good
        ms = cs._time_ms(run)
        kv_rows = sum(lens) * hkv
        nbytes = 2 * kv_rows * _row_bytes(quant, d) + b * pps * 4 + 2 * b * sq * hq * d * 2
        bound_ms, by = cs._bound(nbytes, 4 * hq * pairs * d)
        print(f"{label} kernel 8 chunk batch 4 x 512 at q_start {q_start}, "
              f"{_name(quant)} pages: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound "
              f"share {bound_ms / ms:.3f} library_ms none max_abs_err "
              f"{mx:.3e}{'' if good else ' FAIL'}", flush=True)
        del kp, vp, o, lse, ro, rl
    del q, kf, vf
    torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--no-sweep", action="store_true", help="skip the lens sweep")
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
        for tag, b, hq, hkv, d, lens, wl in (
                ("8B serve step", 16, 32, 8, 128, [300 - 7 * i for i in range(16)], -1),
                ("Gemma3-4B decode d256 window 1023", 10, 8, 4, 256,
                 [300 + (1700 * i) // 9 for i in range(10)], 1023),
                ("lens 8192", 16, 32, 8, 128, [8192] * 16, -1)):
            _, good = decode_case(cs, label, gen, tag, b, hq, hkv, d, lens, wl, FORMATS)
            ok &= good
        ok &= prefill_case(cs, label, gen)
        if not args.no_sweep:
            ratios = {}
            for n in SWEEP:
                times, good = decode_case(cs, label, gen, f"sweep lens {n}", 16, 32, 8,
                                          128, [n] * 16, -1, ("int8", "fp8", "int4"),
                                          check=n <= 8192)
                ok &= good
                if "int4" in times:
                    ratios[n] = times["int4"] / times["int8"]
            if ratios:
                faster = [n for n in SWEEP if all(ratios[m] < 1.0 for m in SWEEP if m >= n)]
                print(f"{label} int4 / int8 kernel 6 time by length: "
                      + ", ".join(f"{n}: {r:.3f}" for n, r in ratios.items())
                      + f"; int4 faster from {faster[0] if faster else 'no swept length'}",
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
