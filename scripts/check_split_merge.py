#!/usr/bin/env python3
"""Hold the split-KV decode of one checkout against another's, bit for bit,
and time both: kernels 5 and 6 on their split route, where a checkout may
merge the splits in a launch of its own or inside the one launch.

    python3 scripts/check_split_merge.py [--root DIR] [--label NAME] --save FILE
    python3 scripts/check_split_merge.py --compare FILE_A FILE_B

The first form imports mfa_tpu_torch from DIR (default: this checkout),
runs every case on one GPU on inputs drawn from seed 0 on the card, prints
each case's whole-call time (chip_smoke._time_ms: CUDA-event mean) and
writes its O and LSE to FILE (torch.save). Cases, bf16 unless named:

- kernel 5 at b2 hq32 hkv8 S30720 d128 (480 tiles, which each count here
  divides), lengths 30715 and 100 (the second row's splits past its first
  hold nothing), at 1, 2, 3, 8, 15 (the heuristic's count at b1) and 30
  splits; fp32 q and cache at S8192 and 3 splits; group 16 (hq32 hkv2)
  at S8192 and 4 splits; chip_smoke.py decode_groups' b16 S8192 at groups
  16 and 32 (hq32 hkv2 / hkv1), 4 splits;
- kernel 6 on pages of 64 with the split count forced through
  kernels/paged.py:split_plan: group 4 (hq32 hkv8 d128, lengths 7679, 700,
  65 and 1: 120 tiles) at 2, 3, 8, 15 and 30 splits on bf16, int8, fp8 and
  int4 pages; a span of 4 (hq32 hkv8) at 3; group 16 (hq32 hkv2) at 8; 4
  sinks with a window of 1000 that empties splits 1-5 of 8; Gemma3-4B's
  heads (hq8 hkv4 d256, window 1023, lengths 2000, 300 and 1300) at 3;
  fp32 q on fp32 pages at 3.

The second form prints, case by case, whether O and the LSE of the two
files are equal bit for bit (and else how many values differ and by how
much at most), beside both times, and exits non-zero unless every case is
bit-equal. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = "bf16"


def _decode_cases():
    # tag: b, hq, hkv, S, d, lens, splits, dtype
    cases = {f"kernel 5, {n} split(s)": (2, 32, 8, 30720, 128, [30715, 100], n, BF)
             for n in (1, 2, 3, 8, 15, 30)}
    cases["kernel 5 fp32, 3 splits"] = (2, 32, 8, 8192, 128, [8187, 100], 3, "fp32")
    cases["kernel 5 group 16, 4 splits"] = (2, 32, 2, 8192, 128, [8187, 100], 4, BF)
    for hkv in (2, 1):  # chip_smoke.py decode_groups' shapes: groups 16 and 32
        cases[f"kernel 5 b16 group {32 // hkv}, 4 splits"] = (
            16, 32, hkv, 8192, 128, [8192] * 16, 4, BF)
    return cases


def _paged_cases():
    # tag: span, hq, hkv, d, lens, window, sinks, splits, quant, dtype
    cases = {}
    for quant in (None, "int8", "fp8", "int4"):
        for n in (2, 3, 8, 15, 30):
            cases[f"kernel 6 {quant or 'bf16'} pages, group 4, {n} splits"] = (
                1, 32, 8, 128, [7679, 700, 65, 1], -1, 0, n, quant, BF)
    cases["kernel 6 int8 pages, span 4, 3 splits"] = (
        4, 32, 8, 128, [7679, 700], -1, 0, 3, "int8", BF)
    cases["kernel 6 int8 pages, group 16, 8 splits"] = (
        1, 32, 2, 128, [7679, 300], -1, 0, 8, "int8", BF)
    cases["kernel 6 int8 pages, 4 sinks, window 1000, 8 splits"] = (
        1, 32, 8, 128, [7679, 5000], 1000, 4, 8, "int8", BF)
    cases["kernel 6 int8 pages, Gemma3-4B heads d256, window 1023, 3 splits"] = (
        1, 8, 4, 256, [2000, 300, 1300], 1023, 0, 3, "int8", BF)
    cases["kernel 6 fp32 q and pages, group 4, 3 splits"] = (
        1, 32, 8, 128, [7679, 700, 65, 1], -1, 0, 3, None, "fp32")
    return cases


def run(root: str, label: str, path: str) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing helpers of this checkout

    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("check_split_merge: needs a CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import _build, decode, paged
    from mfa_tpu_torch.kernels.quant import pack_int4, quantize_rows

    print(f"{label} mfa_tpu_torch from {os.path.dirname(_build.__file__)}", flush=True)
    _build.build_all()
    dtypes = {BF: torch.bfloat16, "fp32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=BF):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtypes[dtype])

    results = {}
    for tag, (b, hq, hkv, S, d, lens, ns, dt) in _decode_cases().items():
        q, k, v = rn(b, hq, d, dtype=dt), rn(b, hkv, S, d, dtype=dt), rn(b, hkv, S, d, dtype=dt)
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def call():
            return decode.decode_attention(q, k, v, L, num_splits=ns, return_lse=True)

        o, lse = call()
        ms = cs._time_ms(call)
        results[tag] = (o.cpu(), lse.cpu(), ms)
        print(f"{label} {tag}: {ms:.4f} ms", flush=True)
        del q, k, v
    real_plan = paged.split_plan
    try:
        for tag, (span, hq, hkv, d, lens, wl, sinks, ns, quant, dt) in _paged_cases().items():
            paged.split_plan = lambda b_, h_, pps, page, ns=ns: decode.split_layout(pps * page, ns)
            page, b = 64, len(lens)
            pps = max(lens) // page + 1
            P = b * pps + 1
            q = rn(b, span, hq, d, dtype=dt) if span > 1 else rn(b, hq, d, dtype=dt)
            kf, vf = rn(hkv, P, page, d, dtype=dt), rn(hkv, P, page, d, dtype=dt)
            ks = vs = None
            kp, vp = kf, vf
            if quant:
                (kp, ks), (vp, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
                if quant == "int4":
                    kp, vp = pack_int4(kp), pack_int4(vp)
            table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                     ).reshape(b, pps).int()
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")

            def call():
                return paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                             window_left=wl, sink_tokens=sinks,
                                             quant_dtype=quant, return_lse=True)

            o, lse = call()
            ms = cs._time_ms(call)
            results[tag] = (o.cpu(), lse.cpu(), ms)
            print(f"{label} {tag}: {ms:.4f} ms", flush=True)
            del q, kf, vf, kp, vp
    finally:
        paged.split_plan = real_plan
    torch.save(results, path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    ok = True
    for tag in a:
        (oa, la, ta), (ob, lb, tb) = a[tag], b[tag]
        n_o, n_l = int((oa != ob).sum()), int((la != lb).sum())
        fin = torch.isfinite(la) & torch.isfinite(lb)
        diff = max(float((oa.float() - ob.float()).abs().max()),
                   float((la[fin] - lb[fin]).abs().max()) if fin.any() else 0.0)
        same = n_o == 0 and n_l == 0
        ok &= same
        print(f"{tag}: {'bit-equal' if same else 'DIFFER'} ({n_o} of {oa.numel()} O, "
              f"{n_l} of {la.numel()} LSE values differ, max |a - b| {diff:.3e}); "
              f"ms {ta:.4f} -> {tb:.4f} ({tb / ta:.3f}x)", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.save:
        ap.error("--save FILE or --compare A B")
    return run(args.root, args.label, args.save)


if __name__ == "__main__":
    sys.exit(main())
