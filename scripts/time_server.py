#!/usr/bin/env python3
"""Time the HTTP front end (mfa_tpu_torch/serve/server.py) over the
Llama-3-8B engine on one GPU, with the server's listen backlog set in
turns.

    python3 scripts/time_server.py [--backlogs 5,128,5,128]

Builds the kernels, runs chip_smoke.py's engine phase (the 8B weights from
seed 0, 16 prompts of 200-256 tokens, its decode rate) and burst phase
(the pipelined rate beside which the server's is printed), then
chip_smoke.py's server_8b phase once per listed backlog, in that order:
a lone request plain and streamed, 16 clients sent at once (TTFT of each
streamed client, the engine's waves, steps and captures meanwhile,
tokens per second through HTTP), a stop sequence, bad bodies, and one
injected engine failure with the recovery. The backlog is the listen
queue of the server's socket: socketserver's default is 5, the port's
128. Prints the card's name and power limit with every rate; exits 1 if
any phase failed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backlogs", default="5,128,5,128")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve import server

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    ident = smi[0].strip() if smi else "nvidia-smi: n/a"
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"build: {_build.build_all():.1f} s [{ident}]", flush=True)
    counts, state = {}, {}
    ok = cs.engine_phase(counts, ident, state)
    ok &= cs.burst_engine_phase(counts, ident, state)
    default = server._Server.request_queue_size
    for backlog in (int(b) for b in args.backlogs.split(",")):
        server._Server.request_queue_size = backlog
        print(f"--- server_8b with a listen backlog of {backlog} ---", flush=True)
        t0 = time.perf_counter()
        try:
            good = cs.server_phase(counts, ident, state)
        finally:
            server._Server.request_queue_size = default
        print(f"--- backlog {backlog}: {'ok' if good else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        ok &= good or backlog < default  # a small backlog may drop clients
    print(ident, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
