"""Device meshes and the collectives of the sharding layer (counterpart of
mfa_tpu/shard/mesh.py).

mfa_tpu runs one controller over `shard_map`, and XLA inserts the
collectives. The port is SPMD instead: every rank runs the same program on
its own shard of weights, KV pages and activations, host bookkeeping
(scheduler, block tables, routing) is replicated and deterministic, and
every collective is an explicit call on the process group of one mesh
axis. The mesh is PyTorch's DeviceMesh with mfa_tpu's axis names:

- "data":   batch parallelism (DP);
- "model":  KV-head tensor parallelism (TP) for attention, and the
  all-reduce axis of the o-projection and MLP partial sums;
- "ctx":    KV-sequence context parallelism (CP: ring attention and the
  context-parallel decodes, merged by the split-KV LSE algebra);
- "expert": expert parallelism (EP) for MoE banks (shard/expert.py);
- "pipe":   pipeline parallelism (PP), a GPipe schedule (shard/pipeline.py).

The collectives, by their JAX names:

    psum                -> psum       (all_reduce SUM)
    pmax                -> pmax       (all_reduce MAX)
    ppermute on a ring  -> ring_shift (batch_isend_irecv to rank +- shift)
    all_to_all          -> all_to_all (all_to_all_single on dim 0)
    process_allgather   -> all_gather

and send_to / recv_from between two ranks of an axis (the pipeline's
stage-to-stage activations, which mfa_tpu rotates with ppermute).

psum / pmax return new tensors and carry no gradient; the training paths
use reduce_from (all-reduce forward, identity backward) and copy_to
(identity forward, all-reduce backward), the pair GSPMD's transposes give
mfa_tpu.

Backends: NCCL on CUDA tensors is the production path, and the only one a
CUDA graph can capture. Gloo runs the CPU tests, and more than one rank on
one card (NCCL refuses two ranks on one GPU); gloo takes a CUDA tensor
through host memory, a property of that backend. A one-rank axis under
gloo runs no collective; under NCCL it runs one, so the production code
path also runs at world size 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
CTX_AXIS = "ctx"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

Axes = Union[str, Sequence[str]]


def ensure_process_group(device_type: str = "cuda",
                         backend: Optional[str] = None) -> None:
    """Initialize a one-process group (an in-memory store) when none
    exists, so a mesh of one rank needs no launcher. backend defaults to
    NCCL for "cuda", gloo otherwise."""
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device_type == "cuda" else "gloo"),
            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
              device_type: str = "cuda",
              backend: Optional[str] = None) -> DeviceMesh:
    """A named mesh over the first ranks of the world (mfa_tpu's make_mesh):
    make_mesh({"data": 2, "model": 4}). Default: every rank on "data".
    Every rank of the world calls it (its subgroups are made collectively);
    a rank past the mesh gets no coordinate. device_type "cpu" for CPU
    tensors; backend: of the one-process group made when none exists."""
    ensure_process_group(device_type, backend)
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: world}
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {total} ranks, "
                         f"got {world}")
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lies on a mesh (mfa_tpu's NamedSharding of a
    PartitionSpec): spec[i] is None (replicated), an axis name, or a tuple
    of names (their ranks row-major); missing trailing dims replicate."""

    mesh: DeviceMesh
    spec: tuple


def sharding(mesh: DeviceMesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def has_axis(mesh: Optional[DeviceMesh], axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Ranks on the axis (1 when the mesh has no such axis)."""
    if not has_axis(mesh, axis):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on the axis (lax.axis_index; 0 without it)."""
    return mesh.get_local_rank(axis) if has_axis(mesh, axis) else 0


def local_slice(n: int, mesh: Optional[DeviceMesh], axes: Axes,
                what: str = "dim"):
    """-> (start, length) of this rank's block of n along `axes`; raises
    ValueError when their ranks do not divide n."""
    parts, idx = 1, 0
    for a in _axes(axes):
        parts, idx = parts * axis_size(mesh, a), idx * axis_size(mesh, a) + axis_index(mesh, a)
    if n % parts:
        raise ValueError(f"{what}: the {'/'.join(_axes(axes))} axis "
                         f"({parts} ranks) must divide {n}")
    return idx * (n // parts), n // parts


def shard_tensor(t: torch.Tensor, sh: Sharding, what: str = "tensor"):
    """This rank's block of a full tensor under `sh` (a copy, so the full
    tensor can be freed; the tensor itself when no dim is sharded)."""
    out = t
    for dim, entry in enumerate(sh.spec):
        if entry is not None:
            start, length = local_slice(t.shape[dim], sh.mesh, entry,
                                        f"{what} dim {dim}")
            out = out.narrow(dim, start, length)
    return out if out is t else out.clone()


def _group(mesh: Optional[DeviceMesh], axis: Optional[str]):
    return None if mesh is None else mesh.get_group(axis)


def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _runs(mesh: Optional[DeviceMesh], axis: str) -> bool:
    """Whether a collective over the axis runs: it is on the mesh, and it
    holds more than one rank or its backend is NCCL."""
    return has_axis(mesh, axis) and (axis_size(mesh, axis) > 1
                                     or _is_nccl(_group(mesh, axis)))


def capturable(mesh: Optional[DeviceMesh]) -> bool:
    """Whether a CUDA graph can hold this mesh's collectives: every axis
    is NCCL or runs none (one rank under gloo)."""
    return mesh is None or all(
        axis_size(mesh, a) == 1 or _is_nccl(_group(mesh, a))
        for a in mesh.mesh_dim_names)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t on the device the group's backend reads:
    gloo takes CUDA tensors through host memory."""
    t = t.detach()
    if t.is_cuda and not _is_nccl(group):
        return t.to("cpu", memory_format=torch.contiguous_format)
    return t.clone(memory_format=torch.contiguous_format)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    buf = _staged(x, group)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _reducible_in_place(x: torch.Tensor, mesh, axes) -> bool:
    """Whether reduce_from may all-reduce x itself: NCCL on every axis
    that runs, and x a fresh contiguous tensor (no view, no leaf that
    requires grad)."""
    return (x.is_cuda and x.is_contiguous() and x._base is None
            and not (x.is_leaf and x.requires_grad)
            and all(_is_nccl(_group(mesh, a)) for a in axes if _runs(mesh, a)))


def psum(x: torch.Tensor, mesh: Optional[DeviceMesh], axes: Axes):
    """Sum over the ranks of `axes` (jax.lax.psum); no gradient."""
    for a in _axes(axes):
        if _runs(mesh, a):
            x = _all_reduce(x, _group(mesh, a), dist.ReduceOp.SUM)
    return x


def pmax(x: torch.Tensor, mesh: Optional[DeviceMesh], axes: Axes):
    """Maximum over the ranks of `axes` (jax.lax.pmax); no gradient."""
    for a in _axes(axes):
        if _runs(mesh, a):
            x = _all_reduce(x, _group(mesh, a), dist.ReduceOp.MAX)
    return x


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Optional[DeviceMesh],
               axis: str, shift: int = 1) -> list:
    """ppermute on the axis's ring: this rank's tensors go to the rank
    `shift` further on, and what arrives from `shift` back is returned.
    Every rank of the axis calls it with the same shapes; shift 0 (mod the
    ring) moves nothing."""
    n = axis_size(mesh, axis)
    shift %= n
    if shift == 0:
        return list(tensors)
    g = _group(mesh, axis)
    me = axis_index(mesh, axis)
    ranks = dist.get_process_group_ranks(g)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    sends = [_staged(t, g) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for tag, (s, r) in enumerate(zip(sends, recvs)):
        ops.append(dist.P2POp(dist.isend, s, dst, g, tag))
        ops.append(dist.P2POp(dist.irecv, r, src, g, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def send_to(x: torch.Tensor, mesh: DeviceMesh, axis: str, index: int) -> None:
    """Send x to the rank at `index` on the axis (blocking)."""
    g = _group(mesh, axis)
    dist.send(_staged(x, g), dist.get_process_group_ranks(g)[index], group=g)


def recv_from(shape, dtype, device, mesh: DeviceMesh, axis: str,
              index: int) -> torch.Tensor:
    """Receive a [shape] tensor of dtype from the rank at `index` on the
    axis (blocking), on `device`."""
    g = _group(mesh, axis)
    host = torch.device(device).type == "cuda" and not _is_nccl(g)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(buf, dist.get_process_group_ranks(g)[index], group=g)
    return buf.to(device)


def all_to_all(x: torch.Tensor, mesh: Optional[DeviceMesh],
               axis: str) -> torch.Tensor:
    """x [n, ...]: block i goes to rank i of the axis, and block i of the
    result came from rank i (jax.lax.all_to_all on axis 0); no gradient."""
    if not _runs(mesh, axis):
        return x
    g = _group(mesh, axis)
    buf = _staged(x, g)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g)
    return out.to(x.device)


def all_gather(x: torch.Tensor, mesh: Optional[DeviceMesh] = None,
               axis: Optional[str] = None) -> torch.Tensor:
    """[n, *x.shape]: every rank's x along the axis, or across the world
    when mesh is None (process_allgather)."""
    group = _group(mesh, axis)
    if mesh is not None and not _runs(mesh, axis):
        return x[None]
    if mesh is None and dist.get_world_size() == 1 and not _is_nccl(None):
        return x[None]
    buf = _staged(x, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.stack(parts).to(x.device)


def assert_replicated(x: torch.Tensor, mesh: Optional[DeviceMesh], axis: str,
                      what: str) -> None:
    """Raise unless x is equal on every rank of the axis (SPMD ranks that
    must agree, e.g. tokens sampled from all-reduced logits)."""
    if axis_size(mesh, axis) <= 1:
        return
    parts = all_gather(x.reshape(-1), mesh, axis)
    if not bool((parts == parts[:1]).all()):
        raise RuntimeError(f"{what} differ across the {axis!r} axis")


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the end of a row-parallel
    product whose output is replicated. Under NCCL the fresh product is
    reduced in place, with no copy."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        if not _reducible_in_place(x, mesh, axes):
            return psum(x, mesh, axes)
        for a in axes:
            if _runs(mesh, a):
                dist.all_reduce(x, group=_group(mesh, a))
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated value entering
    per-rank work (each rank's gradient is a partial sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.axes), None, None


def reduce_from(x: torch.Tensor, mesh: Optional[DeviceMesh], axes: Axes):
    """psum that autograd passes through unchanged (see _ReduceFrom). x is
    a product made for this call: under NCCL it is reduced in place."""
    axes = _axes(axes)
    if not any(_runs(mesh, a) for a in axes):
        return x
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, mesh: Optional[DeviceMesh], axes: Axes):
    """x itself, whose gradient autograd sums over `axes` (see _CopyTo)."""
    axes = _axes(axes)
    if not any(_runs(mesh, a) for a in axes) or not x.requires_grad:
        return x
    return _CopyTo.apply(x, mesh, axes)
