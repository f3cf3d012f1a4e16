"""Device timing and roofline arithmetic (counterpart of
mfa_tpu/utils/timing.py).

The card's peaks come from one table keyed by torch.cuda.get_device_name();
a device the table does not hold raises instead of borrowing another
card's numbers.

`scan_timeit` keeps mfa_tpu's contract: per-iteration seconds of chained
step_fn(carry, *args), measured at N and 2N iterations and differenced so
that fixed costs cancel, N sized from a pilot run. mfa_tpu runs the chain
inside one jitted lax.fori_loop; here, on a CUDA carry, the N chained steps
are captured into one CUDA graph (the host issues none of them while the
card runs), and each replay is timed with CUDA events. On a CPU carry the
steps run eagerly under the host clock, which checks the control flow and
measures nothing about a device.
"""

from __future__ import annotations

import time

import torch

H100_SXM = "NVIDIA H100 80GB HBM3"
# Published peaks of the H100 SXM part at its 700 W limit (NVIDIA's data
# sheet, dense rates): HBM3 bytes/s and bf16 tensor-core FLOP/s. A card set
# below 700 W (nvidia-smi's power.limit) runs slower under load.
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Per device name: memory bytes/s and dense bf16 FLOP/s.
HBM_BW = {H100_SXM: PEAK_BYTES}
PEAK_BF16 = {H100_SXM: PEAK_BF16_FLOPS}


def _device_name() -> str:
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: the peak table holds GPUs only "
                         f"({', '.join(HBM_BW)})")
    return torch.cuda.get_device_name()


def _lookup(table: dict, what: str) -> float:
    name = _device_name()
    if name not in table:
        raise ValueError(f"no {what} known for device {name!r} (known: "
                         f"{', '.join(table)})")
    return table[name]


def device_bw() -> float:
    """Peak memory bytes/s of the current CUDA device."""
    return _lookup(HBM_BW, "memory rate")


def device_peak_flops() -> float:
    """Peak dense bf16 FLOP/s of the current CUDA device."""
    return _lookup(PEAK_BF16, "bf16 peak")


def _first(x) -> torch.Tensor:
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def _readback(x) -> float:
    return float(_first(x).reshape(-1)[0])


def measure_rtt() -> float:
    """Median round trip of a trivial op on the card plus
    torch.cuda.synchronize(), in seconds."""
    x = torch.zeros((), device="cuda")
    x = x + 1.0
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        x = x + 1.0
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _chained(step_fn, carry, args, n: int):
    for _ in range(n):
        carry = step_fn(carry, *args)
    return carry


def _host_timer(step_fn, carry0, args):
    """n -> the host seconds of n chained steps on the CPU (best of 2)."""

    def measure(n: int) -> float:
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            _readback(_chained(step_fn, carry0, args, n))
            best = min(best, time.perf_counter() - t0)
        return best

    return measure


def _graph_timer(step_fn, carry0, args):
    """n -> the device seconds of one replay of a CUDA graph holding n
    chained steps (best of 2), timed with CUDA events. Graphs are kept per
    n, each with its own memory pool."""
    graphs = {}

    def graph_of(n: int) -> torch.cuda.CUDAGraph:
        if n not in graphs:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                _chained(step_fn, carry0, args, n)
            graphs[n] = g
        return graphs[n]

    def measure(n: int) -> float:
        g = graph_of(n)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        best = float("inf")
        for _ in range(2):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best

    return measure


def scan_timeit(step_fn, carry0, args=(), iters: int = 0,
                rtt: float = 0.0, target_s: float = 0.75) -> float:
    """Per-iteration seconds of step_fn(carry, *args), each step fed the
    last one's carry. Runs the chain at N and 2N iterations and differences
    the times, so fixed costs cancel; with iters <= 0, N is sized from a
    pilot run of 8 (rtt, seconds, is taken off the pilot) so that the chain
    lasts about target_s, between 8 and 512.

    On a CUDA carry each chain is one CUDA graph replay timed with CUDA
    events (step_fn must be capturable: no host sync, no pageable copy);
    on a CPU carry the host clock times eager steps."""
    on_card = _first(carry0).device.type == "cuda"
    _readback(_chained(step_fn, carry0, args, 2))  # warm: builds, caches
    if on_card:
        torch.cuda.synchronize()
        measure = _graph_timer(step_fn, carry0, args)
    else:
        measure = _host_timer(step_fn, carry0, args)
    if iters <= 0:
        pilot = measure(8)
        est = max((pilot - rtt) / 8, 1e-6)
        iters = int(min(512, max(8, target_s / est)))
    t_n = measure(iters)
    t_2n = measure(2 * iters)
    return max(t_2n - t_n, 1e-9) / iters


def chain(q, out):
    """Make q depend on out without changing its value by more than its
    rounding: q + out * 1e-7 in q's dtype, the product taken in fp32 and
    rounded to q's dtype (mfa_tpu's arithmetic). Two launches when out has
    q's dtype (the product's fp32 math is the elementwise op's own), so
    the chain adds little to a short kernel it times."""
    if out.dtype == q.dtype:
        return q + out * 1e-7
    return q + (out.float() * 1e-7).to(q.dtype)


def roofline_pct(bytes_moved: int, seconds: float) -> float:
    """Percent of the current device's peak memory rate."""
    return 100.0 * bytes_moved / seconds / device_bw()
