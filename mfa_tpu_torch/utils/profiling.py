"""Profiler integration (counterpart of mfa_tpu/utils/profiling.py).

trace() wraps torch.profiler around a block and writes a Chrome trace
(viewable in Perfetto or chrome://tracing) into a directory: CPU activity
always, CUDA activity (each kernel by its symbol, through CUPTI) when a
CUDA device is present. annotate() names a region on that timeline. CUPTI
may not list the kernels a CUDA graph replay runs, so trace eager calls
where the kernels matter.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "mfa_tpu_torch_trace")


@contextlib.contextmanager
def trace(log_dir=None):
    """Capture a trace around a block; on exit write it as
    <log_dir>/trace_<pid>_<ns>.json (the path is the profiler's
    `trace_path` attribute):

        with profiling.trace("traces") as prof:
            out = flash_attn_func(q, k, v)
            torch.cuda.synchronize()
        print(prof.trace_path)

    CUDA work still running at exit is waited for, so its kernels land in
    the trace."""
    log_dir = log_dir or default_dir()
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named region inside a trace (a user annotation on the timeline)."""
    return record_function(name)
