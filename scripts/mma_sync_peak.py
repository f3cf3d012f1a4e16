#!/usr/bin/env python3
"""The card's mma.sync rates: the ceiling of the fp32 tiles' 3xTF32 products.

    python3 scripts/mma_sync_peak.py

Compiles a small CUDA program with the port's nvcc (sm_90a) into a
temporary directory and runs it: one block of 8 warps an SM (132 blocks),
each warp issuing independent chains of mma.sync m16n8k8 .tf32 (4, 8 or 16
accumulators a warp) or m16n8k16 .bf16 on register operands, timed with
CUDA events. Prints TFLOP/s for each, and the card's name and power limit.
3xTF32 costs three m16n8k8 .tf32 products a product, so a third of the
.tf32 rate is what csrc/flash_fwd_f32.cuh and flash_bwd_f32.cuh can reach.
Needs nvcc and a card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <int KIND, int ACC>
__global__ void __launch_bounds__(256, 1) bench(float* out, int iters) {
  float d[ACC][4];
  for (int i = 0; i < ACC; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int i = 0; i < ACC; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int KIND, int ACC>
static void run(float* out, int blocks) {
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<KIND, ACC><<<blocks, 256>>>(out, 16);
  cudaEventRecord(e0);
  bench<KIND, ACC><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * (KIND == 0 ? 8 : 16) * ACC * (double)iters * blocks * 8;
  printf("%s, %d accumulators a warp: %.1f TFLOP/s (%d blocks of 8 warps)\n",
         KIND == 0 ? "mma.sync m16n8k8 .tf32" : "mma.sync m16n8k16 .bf16", ACC,
         flops / ms / 1e9, blocks);
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 256 * 4 * 4);
  run<0, 4>(out, 132);
  run<0, 8>(out, 132);
  run<0, 16>(out, 132);
  run<1, 8>(out, 132);
  run<1, 16>(out, 132);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    from mfa_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "mma_peak.cu"), os.path.join(tmp, "mma_peak")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", exe, src], check=True)
        rc = subprocess.run([exe]).returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
