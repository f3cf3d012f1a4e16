"""The port's native runtime (mfa_tpu_torch/utils/native.py over its own
csrc/runtime.cpp, built with g++ at first use) against mfa_tpu's
(mfa_tpu/utils/native.py) and against the Python rules (the port's
PageAllocator, mfa_tpu's Python admission and scheduler): the same page
ids in the same order, the same admissions, block tables and cu_seqlens
on seeded inputs; several processes building at once; and the scheduler
raising, never falling back, when the build fails."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from mfa_tpu.serve import scheduler as jax_scheduler
from mfa_tpu.utils import native as jax_native
from mfa_tpu_torch.cache.paged_cache import PageAllocator
from mfa_tpu_torch.serve import scheduler
from mfa_tpu_torch.serve.scheduler import Scheduler
from mfa_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _admit_rule(prompt_lens, free_slots, free_pages, page_size):
    """The Python admission rule (mfa_tpu/utils/native.py's fallback):
    FIFO while a slot is free and the prompt's pages plus one decode page
    fit -> (n_admitted, pages_needed list)."""
    admitted, budget = 0, free_pages
    needed = []
    for ln in prompt_lens:
        np_pages = max(1, -(-int(ln) // page_size))
        if admitted >= free_slots or budget < np_pages + 1:
            break
        needed.append(np_pages)
        budget -= np_pages
        admitted += 1
    return admitted, needed


def test_native_allocator_matches_python():
    na = native.NativeAllocator(32)
    pa = PageAllocator(32)
    assert na.free_pages == pa.free_pages == 31
    n_pages = na.alloc(5)
    p_pages = pa.alloc(5)
    assert n_pages == p_pages  # the same LIFO order
    na.free(n_pages[::-1])
    pa.free(p_pages[::-1])
    assert na.free_pages == pa.free_pages
    assert na.alloc(7) == pa.alloc(7)
    with pytest.raises(MemoryError):
        na.alloc(1000)
    assert na.free_pages == 24  # exhaustion must not leak pages


ADMIT_CASES = [
    ([10, 20, 3], 2, 8, 8),
    ([1], 0, 100, 8),
    ([100, 1, 1], 4, 3, 8),
    ([], 4, 10, 8),
    ([8, 8, 8, 8], 10, 100, 8),
    ([0, 64, 65], 3, 5, 64),
]


@pytest.mark.parametrize("lens, slots, pages, psize", ADMIT_CASES)
def test_native_admit_matches_python_rule(lens, slots, pages, psize):
    assert native.admit(lens, slots, pages, psize) == \
        _admit_rule(lens, slots, pages, psize)


def test_native_block_table_and_cu():
    tbl = native.pack_block_table([[1, 2], [3], [4, 5, 6]], 4)
    assert tbl.tolist() == [[1, 2, 0, 0], [3, 0, 0, 0], [4, 5, 6, 0]]
    assert tbl.dtype == np.int32
    cu = native.cu_seqlens([3, 5, 2])
    assert cu.tolist() == [0, 3, 8, 10]
    assert cu.dtype == np.int32
    assert native.pack_block_table([], 3).shape == (0, 3)
    assert native.cu_seqlens([]).tolist() == [0]


def test_scheduler_uses_native_allocator():
    s = Scheduler(max_seqs=2, pages_per_seq=4, page_size=8, num_pages=16)
    assert type(s.allocator) is native.NativeAllocator
    assert s.allocator.num_pages == 16 and s.allocator.free_pages == 15


def test_native_equals_mfa_tpu_on_seeded_inputs():
    rng = np.random.RandomState(0)
    for _ in range(20):
        lens = [int(x) for x in rng.randint(0, 300, rng.randint(1, 12))]
        slots, pages, psize = (int(rng.randint(0, 10)), int(rng.randint(0, 60)),
                               int(rng.choice([8, 16, 64])))
        assert native.admit(lens, slots, pages, psize) == \
            jax_native.admit(lens, slots, pages, psize)
        rows = [[int(p) for p in rng.randint(1, 99, rng.randint(0, 9))]
                for _ in range(rng.randint(1, 6))]
        width = int(rng.randint(1, 8))
        np.testing.assert_array_equal(native.pack_block_table(rows, width),
                                      jax_native.pack_block_table(rows, width))
        np.testing.assert_array_equal(native.cu_seqlens(lens),
                                      jax_native.cu_seqlens(lens))
    # allocation order (mfa_tpu's NativeAllocator, or its Python fallback
    # when its library is not built: the same order either way)
    try:
        ref = jax_native.NativeAllocator(40)
    except RuntimeError:
        from mfa_tpu.cache.paged_cache import PageAllocator as ref_cls
        ref = ref_cls(40)
    ours = native.NativeAllocator(40)
    for n in rng.randint(1, 6, 6):
        got, want = ours.alloc(int(n)), ref.alloc(int(n))
        assert got == want
        ours.free(got[::2])
        ref.free(want[::2])
        assert ours.free_pages == ref.free_pages


def _sched_trace(mod, **kw):
    """Admission, decode-page mapping, preemption and release on one
    scheduler of module `mod` -> every page list it handed out, in order."""
    s = mod.Scheduler(max_seqs=3, pages_per_seq=6, page_size=4, num_pages=24,
                      **kw)
    reqs = [mod.Request(i, list(range(n)), 8)
            for i, n in enumerate((5, 9, 3, 7))]
    for r in reqs:
        s.submit(r)
    log = [[r.pages[:] for r in s.admit()]]
    for step in range(3):
        for r in list(s.active.values()):
            log.append(s.ensure_decode_pages(r, 4))
            r.generated.extend([1] * 4)
    s.preempt(reqs[1])
    s.finish(reqs[0])
    log.append([r.pages[:] for r in s.admit()])
    log.append(s.allocator.free_pages)
    return log


def test_scheduler_native_and_python_agree():
    # the port's scheduler (native) against mfa_tpu's on its Python allocator
    assert _sched_trace(scheduler) == \
        _sched_trace(jax_scheduler, use_native=False)


def test_use_native_raises_when_the_build_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native runtime"):
        Scheduler(max_seqs=2, pages_per_seq=4, page_size=8, num_pages=16)
    with pytest.raises(RuntimeError, match="native runtime"):
        native.admit([8], 1, 4, 8)
    assert not list(tmp_path.glob("*/*.so"))


def test_concurrent_builds(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, and no temporary file is left behind."""
    code = (
        "import sys\n"
        "from mfa_tpu_torch.utils import native\n"
        "native.BUILD_ROOT = sys.argv[1]\n"
        "assert native.cu_seqlens([1, 2]).tolist() == [0, 1, 3]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    files = sorted(f.name for f in tmp_path.glob("*/*"))
    assert files == ["libmfa_runtime.so"]
