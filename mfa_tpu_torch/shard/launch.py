"""Start SPMD ranks on one host and run functions on all of them.

    with Ranks(4, device="cpu") as ranks:
        outs = ranks.run(fn, arg)      # fn(arg) on every rank, in rank order

`Ranks` spawns world_size processes (torch.multiprocessing, the spawn
method) that rendezvous through a FileStore in a fresh temporary
directory, so two groups started at once never race for a TCP port. Each
rank sets RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE, on "cuda"
takes card rank % device_count, joins the default process group, and then
serves run() calls until close(): fn and its arguments are pickled to
every rank (fn by its import path, so it lives in a module the ranks can
import), and each rank's return value and the kernel launch counts of its
call (kernels/_build.launches) come back. A rank that raises ends the
group: the other ranks are terminated (they may wait in a collective that
will never complete) and the parent raises RankError with the rank's
traceback. A rank that dies or a run past its timeout does the same.

backend: NCCL on "cuda", which needs a card a rank (it refuses two ranks
on one GPU), and gloo on "cpu". More ranks than cards run only when the
caller asks for gloo, which takes CUDA tensors through host memory
(shard/mesh.py): a group never falls back to it on its own.
"""

from __future__ import annotations

import collections
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised, died or timed out; the group is closed."""


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, threads: Optional[int], timeout_s: float,
               tasks, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:
        results.put(("err", rank, traceback.format_exc()))
        return
    from mfa_tpu_torch.kernels import _build

    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        _build.reset_launches()
        try:
            out = fn(*args, **kwargs)
        except Exception:
            results.put(("err", rank, traceback.format_exc()))
            break
        results.put(("ok", rank, out, dict(_build.launches)))
    dist.destroy_process_group()


class Ranks:
    """world_size SPMD rank processes (module docstring). device: "cpu" or
    "cuda"; backend: default NCCL on "cuda" (ValueError with fewer cards
    than ranks) and gloo on "cpu"; threads: torch threads a rank (set it
    when many ranks share few cores); timeout_s: of the process group's
    collectives and the default of run()."""

    def __init__(self, world_size: int, device: str = "cuda",
                 backend: Optional[str] = None, threads: Optional[int] = None,
                 timeout_s: float = 600.0):
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the ranks on the CPU")
        if backend is None:
            backend = "nccl" if device == "cuda" else "gloo"
        cards = torch.cuda.device_count() if device == "cuda" else 0
        if backend == "nccl" and cards < world_size:
            raise ValueError(f"NCCL needs a card a rank: {world_size} ranks, "
                             f"{cards} cards; pass backend='gloo' to "
                             "time-share the cards through host memory")
        self.world_size = world_size
        self.backend = backend
        self.timeout_s = timeout_s
        self.launches: collections.Counter = collections.Counter()
        self._dir = tempfile.mkdtemp(prefix="mfa_ranks_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world_size, os.path.join(self._dir, "store"), backend,
                device, threads, timeout_s, self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout_s: Optional[float] = None, **kwargs):
        """fn(*args, **kwargs) on every rank -> their results, in rank order.
        self.launches becomes the launches of this call, summed over ranks."""
        if self._procs is None:
            raise RankError("the ranks are closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        outs, launches = {}, collections.Counter()
        while len(outs) < self.world_size:
            try:
                msg = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in outs]
                if dead or time.monotonic() > deadline:
                    self.close(force=True)
                    why = (f"rank {dead[0]} exited with code "
                           f"{self._exitcode(dead[0])}" if dead
                           else f"no result within {timeout_s or self.timeout_s} s")
                    raise RankError(f"{getattr(fn, '__name__', fn)}: {why}")
                continue
            if msg[0] == "err":
                self.close(force=True)
                raise RankError(f"rank {msg[1]} raised:\n{msg[2]}")
            outs[msg[1]] = msg[2]
            launches.update(msg[3])
        self.launches = launches
        return [outs[r] for r in range(self.world_size)]

    def _exitcode(self, rank: int):
        return self._procs[rank].exitcode if self._procs else None

    def close(self, force: bool = False) -> None:
        """Stop the ranks (terminate them with force) and remove the store."""
        procs, self._procs = self._procs, None
        if procs is None:
            return
        if not force:
            for q in self._tasks:
                q.put(None)
            for p in procs:
                p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)

