"""The port stands alone: importing mfa_tpu_torch loads neither JAX nor any
mfa_tpu module (nor transformers, safetensors or ml_dtypes, which the
card's machine lacks: checkpoints load through the port's own reader), the package never calls PyTorch's fused attention, and
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
        "mfa_tpu_torch.models.llama, mfa_tpu_torch.ref.oracle, "
        "mfa_tpu_torch.models.vision, mfa_tpu_torch.kernels.blockmask, "
        "mfa_tpu_torch.models.wquant, mfa_tpu_torch.kernels.wmatmul, "
        "mfa_tpu_torch.models.safetensors_io, mfa_tpu_torch.models.convert, "
        "mfa_tpu_torch.utils.checkpoint, mfa_tpu_torch.serve.server, "
        "mfa_tpu_torch.utils.timing, mfa_tpu_torch.utils.profiling, "
        "mfa_tpu_torch.utils.native, mfa_tpu_torch.shard.mesh, "
        "mfa_tpu_torch.shard.attention, mfa_tpu_torch.shard.ring, "
        "mfa_tpu_torch.shard.expert, mfa_tpu_torch.shard.pipeline, "
        "mfa_tpu_torch.shard.launch, mfa_tpu_torch.serve.multihost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'mfa_tpu', 'transformers', 'safetensors', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports_jax_or_mfa_tpu(line: str) -> bool:
    """An import statement, at any indentation (a lazy import inside a
    function included), that names jax or mfa_tpu."""
    stripped = line.strip()
    if not stripped.startswith(("import ", "from ")):
        return False
    words = stripped.replace(",", " ").split()
    return ("jax" in words or "mfa_tpu" in words
            or any(w.startswith(("jax.", "mfa_tpu.")) for w in words))


def test_package_sources_never_name_jax_or_mfa_tpu():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not _imports_jax_or_mfa_tpu(line), (path, line)


@pytest.mark.parametrize("line, bad", [
    ("            from mfa_tpu.serve.sampling import SamplingParams", True),
    ("    import jax.numpy as jnp", True),
    ("from mfa_tpu import interface", True),
    ("from mfa_tpu_torch.serve.sampling import SamplingParams", False),
    ("# from mfa_tpu.serve.sampling import SamplingParams", False),
])
def test_source_scan_reaches_lazy_imports(line, bad):
    assert _imports_jax_or_mfa_tpu(line) == bad


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
        "import mfa_tpu_torch.models.vision, mfa_tpu_torch.kernels.blockmask\n"
        "import mfa_tpu_torch.models.wquant, mfa_tpu_torch.kernels.wmatmul\n"
        "import mfa_tpu_torch.serve.server, mfa_tpu_torch.utils.timing\n"
        "import mfa_tpu_torch.utils.profiling, mfa_tpu_torch.shard.ring\n"
        "import mfa_tpu_torch.shard.expert, mfa_tpu_torch.shard.pipeline\n"
        "import mfa_tpu_torch.shard.launch, mfa_tpu_torch.serve.multihost\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from mfa_tpu_torch.kernels import _build\n"
        "from mfa_tpu_torch.utils import native\n"
        "assert not _build._libs and _build.build_seconds is None\n"
        "assert native._LIB is None and native.build_seconds is None\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharding_layer_sources_never_name_jax_or_mfa_tpu():
    """The sharding layer and the rank-side test functions (which the
    spawned ranks import) name neither jax nor mfa_tpu."""
    paths = sorted((PKG / "shard").glob("*.py")) + [
        PKG / "serve" / "multihost.py", ROOT / "tests" / "torch_rank_fns.py"]
    assert len(paths) == 9
    for path in paths:
        for line in path.read_text().splitlines():
            assert not _imports_jax_or_mfa_tpu(line), (path, line)


def test_launcher_reraises_a_failing_rank():
    """A rank that raises while the others wait in a collective ends the
    group: the launcher re-raises the rank's exception and does not hang
    (its own timeout is far below the group's)."""
    import time

    from mfa_tpu_torch.shard.launch import RankError, Ranks
    from tests import torch_rank_fns as R

    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 raised(.|\\n)*rank failure on purpose"):
        with Ranks(2, device="cpu", threads=1, timeout_s=60) as ranks:
            ranks.run(R.fail_on_rank, 1)
    assert time.monotonic() - t0 < 45


def test_launcher_refuses_more_nccl_ranks_than_cards(monkeypatch):
    """On CUDA the launcher takes NCCL, which needs a card a rank: with
    fewer cards it raises before spawning rather than falling back to
    gloo; gloo is the caller's explicit choice."""
    import torch

    from mfa_tpu_torch.shard.launch import Ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs a card a rank: 2 ranks, 1 cards"):
        Ranks(2, device="cuda")
