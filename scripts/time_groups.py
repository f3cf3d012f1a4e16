#!/usr/bin/env python3
"""Time kernel 8 (paged prefill) at q-per-kv groups that divide its 64-row
warpgroups and at groups that do not, on one GPU.

    python3 scripts/time_groups.py [--root DIR] [--label NAME]

Chunk batches of 4 x 512 rows, pages of 64, bf16 q from seed 0 (the cases
of scripts/time_head256.py:paged_prefill_cases, which holds each output
to the plain version: max 2e-2, mean 2e-3, LSE within 1e-3 with the same
-inf rows, and prints ms, the bound, the plain version's ms):

- group 4, Llama-3-8B's batch (hq 32 / hkv 8, d 128, q_start
  0/1024/2048/3072, int8 pages) and group 2, Gemma3-4B's (hq 8 / hkv 4,
  d 256, q_start 1536, int8 pages): the groups whose code path must not
  move;
- group 7, Qwen2-7B's batch (hq 28 / hkv 4, d 128, q_start 1536, int8 and
  bf16 pages), beside group 8 on the same positions (hq 32 / hkv 4);
- Gemma2-9B's batch (hq 16 / hkv 8, d 256, q_start 1536, int8 pages,
  softcap 50, causal and window 4095).

--root imports mfa_tpu_torch from another checkout (the parent commit
unpacked with git archive), so two versions compare in one call; a
checkout that refuses a group prints "not taken" for its rows. Prints the
card's name and power limit last.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs  # timing and bound helpers of this checkout
    import time_head256 as th

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import paged_prefill

    print(f"mfa_tpu_torch from {os.path.dirname(paged_prefill.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lab = args.label
    at = [1536] * 4
    with torch.no_grad():
        ok = th.paged_prefill_cases(cs, lab, gen, 128, 32, 8, [0, 1024, 2048, 3072],
                                    (("int8", -1, 64),))
        ok &= th.paged_prefill_cases(cs, lab, gen, 256, 8, 4, at, (("int8", -1, 64),))
        for hq in (28, 32):
            ok &= th.paged_prefill_cases(cs, lab, gen, 128, hq, 4, at,
                                         (("int8", -1, 64), ("bf16", -1, 64)))
        ok &= th.paged_prefill_cases(cs, lab, gen, 256, 16, 8, at,
                                     (("int8", -1, 64), ("int8", 4095, 64)), softcap=50.0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
