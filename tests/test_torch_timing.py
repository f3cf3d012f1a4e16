"""The port's timing and profiling utilities (mfa_tpu_torch/utils/timing.py,
profiling.py) on the CPU: scan_timeit's control flow, chain's arithmetic
against mfa_tpu's, the peak table (a ValueError with no card or an unknown
one, the H100's numbers by name), roofline_pct, a Chrome trace holding an
annotation, and chip_smoke.py's bounds drawn from the same table."""

import json
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.utils import timing as jax_timing
from mfa_tpu_torch.utils import profiling, timing
from tests.jax_maps import release_jax_code  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def named_card(monkeypatch):
    """Pretend a CUDA device of the given name is present."""

    def set_name(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)

    return set_name


def test_scan_timeit_cpu_sanity():
    x = torch.ones((256, 256))

    def step(c, x):
        return c + 0.0 * x.sum() + 1.0

    dt = timing.scan_timeit(step, torch.zeros(()), args=(x,), iters=16)
    assert 0 < dt < 1.0


def test_scan_timeit_sizes_n_from_a_pilot():
    calls = []

    def step(c):
        calls.append(1)
        return c + 1.0

    dt = timing.scan_timeit(step, torch.zeros(()), target_s=1e-3)
    assert 0 < dt < 1.0
    # warm 2, pilot 2 x 8, then 2 x N and 2 x 2N with 8 <= N <= 512
    n = (len(calls) - 2 - 16) // 6
    assert 8 <= n <= 512 and len(calls) == 2 + 16 + 6 * n


@pytest.mark.parametrize("dtype, out_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_chain_matches_mfa_tpu(dtype, out_dtype):
    rng = np.random.RandomState(0)
    q = rng.standard_normal((4, 8, 64)).astype(np.float32)
    out = (rng.standard_normal((4, 8, 64)) * 1e4).astype(np.float32)
    want = np.asarray(jax_timing.chain(jnp.asarray(q, dtype),
                                       jnp.asarray(out, out_dtype)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = timing.chain(torch.tensor(q, dtype=tdt),
                       torch.tensor(out, dtype=getattr(torch, out_dtype)))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_device_bw_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (timing.device_bw, timing.device_peak_flops):
        with pytest.raises(ValueError, match="no CUDA device"):
            fn()


def test_device_peaks_by_name(named_card):
    named_card("NVIDIA H100 80GB HBM3")
    assert timing.device_bw() == 3.35e12 == timing.PEAK_BYTES
    assert timing.device_peak_flops() == 989e12 == timing.PEAK_BF16_FLOPS
    named_card("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        timing.device_bw()
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        timing.device_peak_flops()


def test_roofline_pct(named_card):
    named_card("NVIDIA H100 80GB HBM3")
    assert timing.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert timing.roofline_pct(1.675e9, 1e-3) == pytest.approx(50.0)
    assert timing.roofline_pct(0, 1.0) == 0.0


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("paged_decode"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    path = pathlib.Path(prof.trace_path)
    assert path.parent == tmp_path and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "paged_decode" for e in events)


def test_trace_default_dir_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    assert profiling.default_dir() == os.path.join(str(tmp_path),
                                                   "mfa_tpu_torch_trace")


def test_chip_smoke_bounds_use_the_table():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke._bound(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert chip_smoke._bound(0.0, 989e9) == (pytest.approx(1.0), "operations")
