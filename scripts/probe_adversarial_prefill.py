#!/usr/bin/env python3
"""How far kernels 1 and 4 sit from the fp32 plain version on std-1e3
inputs, draw by draw, on one GPU.

    python3 scripts/probe_adversarial_prefill.py [--draws 8]

chip_smoke.py phase 2 holds kernel 4 ("prepass": every tile risky, so the
classic softmax) on q, k of std 1e3 at the 8B wave's shape (b16 hq32 hkv8
s256 d128, causal, bf16) to max 2e-2 of the fp32 plain version. There the
logits reach ~1e5: the fp32 dot products of the kernel and of the plain
version round differently, by more than the gap between a row's top two
logits in some rows, so the output of such a row moves by a fraction of
|v|. This prints, for each draw from its own seed, the largest and mean
error of kernel 1, kernel 4 and the fp32 plain version against an fp64
reference, and kernel 1 against kernel 4, so the spread of the fp32 plain
version itself is beside the kernels'. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _reference64(q, k, v, scale):
    """Causal GQA attention in float64."""
    import torch

    group = q.shape[1] // k.shape[1]
    kf = k.double().repeat_interleave(group, dim=1)
    vf = v.double().repeat_interleave(group, dim=1)
    s = (q.double() @ kf.transpose(-1, -2)) * scale
    n = q.shape[2]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return p @ vf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import prefill

    b, hq, hkv, s, d = 16, 32, 8, 256, 128
    scale = d ** -0.5
    for seed in range(args.draws):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for h in (hq, hkv, hkv))
        q, k, v = (q * 1e3).to(torch.bfloat16), (k * 1e3).to(torch.bfloat16), v.to(torch.bfloat16)
        ref = _reference64(q, k, v, scale)
        outs = {
            "kernel 1": prefill.prefill_attention(q, k, v, causal=True, bound_softmax=False),
            "kernel 4 prepass": prefill.prefill_attention(q, k, v, causal=True,
                                                          bound_softmax="prepass"),
            "fp32 plain": prefill._prefill_plain(q, k, v, scale, -1, 0, 0.0, False),
        }
        parts = []
        for name, o in outs.items():
            err = (o.double() - ref).abs()
            parts.append(f"{name} max {float(err.max()):.3e} mean {float(err.mean()):.3e}")
        k1_k4 = float((outs["kernel 1"].float() - outs["kernel 4 prepass"].float()).abs().max())
        plain = outs["fp32 plain"].float()
        k4_plain = float((outs["kernel 4 prepass"].float() - plain).abs().max())
        print(f"draw {seed}: against fp64: {'; '.join(parts)}; kernel 1 vs kernel 4 max "
              f"{k1_k4:.3e}; kernel 4 vs fp32 plain max {k4_plain:.3e}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
