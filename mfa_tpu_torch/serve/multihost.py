"""Multi-host serving: process init, hybrid meshes, request routing
(counterpart of mfa_tpu/serve/multihost.py).

- Within a host: tensor parallelism. Engine(mesh=serving_mesh(tp)) shards
  params and paged KV by kv head; decode attention needs no communication,
  and the o-projection and MLP partial sums are one all-reduce each.
- Across hosts: data parallelism at the engine level. Each host runs a
  whole engine replica over its local ranks and serves a disjoint request
  subset (route_requests), so no cross-host traffic enters the token loop.
- For training across hosts, make_hybrid_mesh builds the DCN-outer x
  ICI-inner mesh (data axes over hosts, model axes within one).

Ranks are numbered node-major (a host's ranks are consecutive), as
torchrun and shard/launch.py number them. In one process every helper
degrades to its single-process form.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mfa_tpu_torch.shard.mesh import DATA_AXIS, MODEL_AXIS, all_gather, make_mesh


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join the default process group from the arguments or the
    environment (MASTER_ADDR / WORLD_SIZE / RANK, as torchrun sets them)
    and return this process's rank. A no-op returning the rank when a
    group exists, and 0 in one process with nothing to join. backend:
    NCCL when CUDA is present, else gloo. Errors (a wrong address, a
    missing rank) are raised, never swallowed."""
    if dist.is_initialized():
        return dist.get_rank()
    if (init_method is None and world_size is None
            and "WORLD_SIZE" not in os.environ):
        return 0
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=init_method, world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.get_rank()


def local_world_size() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE, else the whole world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def serving_mesh(tp: Optional[int] = None,
                 device_type: str = "cuda") -> DeviceMesh:
    """A model-only mesh over this host's ranks for TP serving (tp defaults
    to all of them). Serving meshes stay within one host, so the decode
    loop's all-reduces never cross hosts; a tp above the host's ranks
    raises (use engine replicas instead)."""
    local = local_world_size()
    tp = tp or local
    if tp > local:
        raise ValueError(f"tp={tp} exceeds {local} local ranks: cross-host "
                         "TP would put the network in the decode loop; use "
                         "engine replicas instead")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == tp:
        return make_mesh({MODEL_AXIS: tp}, device_type)
    if world % tp:
        raise ValueError(f"tp={tp} must divide the {world} ranks")
    # the other ranks form replicas of their own: one model mesh each
    return make_mesh({DATA_AXIS: world // tp, MODEL_AXIS: tp},
                     device_type)[MODEL_AXIS]


def make_hybrid_mesh(dcn_axes: Mapping[str, int], ici_axes: Mapping[str, int],
                     device_type: str = "cuda") -> DeviceMesh:
    """DCN-outer x ICI-inner mesh for multi-host training:
    make_hybrid_mesh({"data": 2}, {"model": 4}) on 2 hosts x 4 ranks. With
    node-major ranks the row-major mesh keeps the DCN axes outermost; over
    several hosts the ICI axes must fit within one host."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    ici = math.prod(ici_axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = local_world_size()
    if world > local and local % ici:
        raise ValueError(f"ICI axes {dict(ici_axes)} ({ici} ranks) must fit "
                         f"within one host's {local} ranks")
    return make_mesh(dict(zip(names, tuple(dcn_axes.values())
                              + tuple(ici_axes.values()))), device_type)


def route_requests(request_ids: Sequence[int], process_index: int,
                   process_count: int) -> List[int]:
    """Deterministic disjoint partition of a request stream across engine
    replicas (uid mod replicas): every host, and any front end, computes
    the same assignment with no coordination traffic."""
    return [r for r in request_ids if r % process_count == process_index]


@dataclasses.dataclass
class FleetStats:
    """Engine stats summed across processes."""

    prefill_tokens: int
    decode_tokens: int
    recoveries: int
    wall_s: float

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s else 0.0


def aggregate_stats(stats) -> FleetStats:
    """Sum EngineStats across processes (the longest wall clock): one
    all_gather of a float64 vector over the world; the identity in one
    process."""
    local = torch.tensor([stats.prefill_tokens, stats.decode_tokens,
                          stats.recoveries, stats.wall_s], dtype=torch.float64)
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            local = local.to(torch.device("cuda", torch.cuda.current_device()))
        gathered = all_gather(local).cpu()
    else:
        gathered = local[None]
    return FleetStats(
        prefill_tokens=int(gathered[:, 0].sum()),
        decode_tokens=int(gathered[:, 1].sum()),
        recoveries=int(gathered[:, 2].sum()),
        wall_s=float(gathered[:, 3].max()),
    )
