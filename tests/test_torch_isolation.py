"""The port stands alone: importing mfa_tpu_torch loads neither JAX nor any
mfa_tpu module, the package never calls PyTorch's fused attention, and
entry points that create state on the default device ("cuda") raise when
no GPU is present instead of running on the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mfa_tpu_torch"


def test_import_loads_neither_jax_nor_mfa_tpu():
    code = (
        "import sys\n"
        "import mfa_tpu_torch, mfa_tpu_torch.serve.engine, "
        "mfa_tpu_torch.kernels.decode, mfa_tpu_torch.kernels.paged, "
        "mfa_tpu_torch.kernels.varlen, mfa_tpu_torch.kernels.paged_prefill, "
        "mfa_tpu_torch.kernels.backward, mfa_tpu_torch.kernels.autodiff, "
        "mfa_tpu_torch.models.llama, mfa_tpu_torch.ref.oracle\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'mfa_tpu' or m.startswith('mfa_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_package_sources_never_name_jax_or_mfa_tpu():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                words = stripped.replace(",", " ").split()
                assert "jax" not in words and "mfa_tpu" not in words, (path, line)
                assert not any(w.startswith(("jax.", "mfa_tpu.")) for w in words), (
                    path, line)


def test_no_fused_attention_in_the_package():
    for path in list(PKG.rglob("*.py")) + list(PKG.rglob("*.cu*")):
        assert "scaled_dot_product_attention" not in path.read_text(), path


def test_state_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.build_kv_caches(cfg, 8, 4, 2, 2)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg)


def test_import_builds_no_kernel():
    code = (
        "import mfa_tpu_torch, mfa_tpu_torch.serve.engine\n"
        "from mfa_tpu_torch.kernels import _build\n"
        "assert not _build._libs and _build.build_seconds is None\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
