"""Model parameter save/load (counterpart of mfa_tpu/utils/checkpoint.py).

The same flattened-npz format and contract as the JAX package: every leaf
of the params tree (dicts, the list of layers, QWeight's qw and scale) is
stored as `leaf_i` beside a JSON list of the leaves' paths, and loading
checks that list against the structure of an initialized `like` tree,
raising ValueError on a mismatch. numpy has no bf16 (nor fp8), so such a
leaf is stored by its bit pattern as a same-width integer array, with each
leaf's torch dtype recorded in `__dtypes__`: the round trip is bit-exact.
Leaves load in `like`'s dtype, on `like`'s device.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from mfa_tpu_torch.models.wquant import QWeight

# dtypes numpy lacks -> the integer dtype of the same width that carries the bits
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}


def _flatten(node: Any, path: str = "") -> list:
    """-> [(path, tensor)] in a fixed order: dict keys sorted (as JAX's
    tree flattening orders them), list items in order, QWeight as qw then
    scale."""
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _flatten(node[k], f"{path}[{k!r}]")]
    if isinstance(node, (list, tuple)):
        return [leaf for i, v in enumerate(node) for leaf in _flatten(v, f"{path}[{i}]")]
    if isinstance(node, QWeight):
        return [(f"{path}.qw", node.qw), (f"{path}.scale", node.scale)]
    return [(path, node)]


def _unflatten(like: Any, leaves) -> Any:
    """`like`'s structure with its leaves taken in order from the iterator."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, QWeight):
        return QWeight(qw=next(leaves), scale=next(leaves), axis=like.axis)
    return next(leaves)


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize so
    save_params/load_params round-trip on any path the caller gives."""
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(_BITS[t.dtype]) if t.dtype in _BITS else t).numpy()


def save_params(path: str, params: Any) -> None:
    flat = _flatten(params)
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        __paths__=np.array(json.dumps([p for p, _ in flat])),
        __dtypes__=np.array(json.dumps([str(t.dtype) for _, t in flat])),
        **{f"leaf_{i}": _to_numpy(t) for i, (_, t) in enumerate(flat)},
    )


def load_params(path: str, like: Any) -> Any:
    """Load into the structure of `like` (an initialized params tree)."""
    flat = _flatten(like)
    with np.load(_npz_path(path)) as data:
        saved_paths = json.loads(str(data["__paths__"]))
        if saved_paths != [p for p, _ in flat]:
            raise ValueError(
                "checkpoint structure mismatch: "
                f"{len(saved_paths)} saved leaves vs {len(flat)} expected")
        dtypes = json.loads(str(data["__dtypes__"]))
        restored = []
        for i, (_, ref) in enumerate(flat):
            t = torch.from_numpy(data[f"leaf_{i}"])
            saved = getattr(torch, dtypes[i].removeprefix("torch."))
            if saved in _BITS:
                t = t.view(saved)
            restored.append(t.to(device=ref.device, dtype=ref.dtype))
    return _unflatten(like, iter(restored))
