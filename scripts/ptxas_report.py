#!/usr/bin/env python3
"""Registers, spills and Hopper instructions of every kernel the port compiles.

    python3 scripts/ptxas_report.py [--match 256]

Compiles each source of mfa_tpu_torch/kernels/_build.SOURCES with the
port's own nvcc flags plus `-Xptxas -v` (all sources at once, into a
temporary directory), and prints one line per kernel instantiation:
registers a thread, spill stores and loads in bytes, the stack frame,
whether its SASS (`cuobjdump -sass`) holds HGMMA (wgmma), HMMA (mma.sync)
and UTMALDG (a TMA load), and the demangled name. --match keeps only the names containing the
string. HMMA marks an mma.sync product (the decode tile of kernels 5 and
6). Exits non-zero if a source does not compile, if an instantiation
spills, if a kernel lacks the instructions its design rests on (REQUIRED:
the decode tile HMMA and UTMALDG, the wgmma + TMA backward kernels
`fb90::bwd_kernel` and `fb90::dq_kernel` HGMMA and UTMALDG), or if a kernel
of a source holds an instruction its design retired (FORBIDDEN: HMMA in
backward.cu, whose kernels all run wgmma). Needs nvcc and cuobjdump (the
CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if not tool:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def parse(log: str):
    """ptxas -v output -> [(mangled name, registers, spill stores, spill
    loads, stack bytes)] in the order ptxas printed them."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = [m.group(1), None, None, None, None]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur[4], cur[2], cur[3] = (int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
    return [tuple(r) for r in rows]


def sass_ops(lib: str, ops=("HGMMA", "HMMA", "UTMALDG")):
    """{mangled kernel name: {op: present}} from `cuobjdump -sass lib`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = part.partition("\n")
        found[name.strip()] = {op: op in body for op in ops}
    return found


# kernel name fragment -> SASS instructions every instantiation must hold
REQUIRED = {"kd90::splitkv_kernel": ("HMMA", "UTMALDG"),
            "fb90::bwd_kernel": ("HGMMA", "UTMALDG"),
            "fb90::dq_kernel": ("HGMMA", "UTMALDG")}
# source -> SASS instructions none of its kernels may hold
FORBIDDEN = {"backward.cu": ("HMMA",)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    from mfa_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in _build.SOURCES:
            cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   os.path.join(tmp, src + ".so"), os.path.join(_build.CSRC, src)]
            procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
        failed = False
        for src, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"{src}: nvcc failed\n{log}", flush=True)
                failed = True
                continue
            rows = parse(log)
            names = _demangle([r[0] for r in rows])
            ops = sass_ops(os.path.join(tmp, src + ".so"))
            for (mangled, regs, st, ld, stack), name in zip(rows, names):
                if args.match and args.match not in name:
                    continue
                has = ops.get(mangled, {})
                tags = " ".join(f"{op} {'yes' if on else 'no'}"
                                for op, on in has.items()) or "SASS not found"
                print(f"{src}: {regs} registers, spill stores {st} B, spill "
                      f"loads {ld} B, stack {stack} B, {tags}: {name}",
                      flush=True)
                missing = [op for frag, need in REQUIRED.items() if frag in name
                           for op in need if not has.get(op)]
                banned = [op for op in FORBIDDEN.get(src, ()) if has.get(op)]
                if st or ld or missing or banned:
                    print(f"  FAIL: spills {st} / {ld} B, missing {missing}, "
                          f"forbidden {banned}", flush=True)
                    failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
