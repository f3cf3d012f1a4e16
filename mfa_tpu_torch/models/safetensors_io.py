"""Minimal safetensors reader/writer (counterpart of mfa_tpu/models/safetensors_io.py).

No safetensors package and no ml_dtypes: the format is parsed directly,

    [8 bytes LE header length][JSON header][raw tensor bytes]

where the JSON header maps tensor name -> {dtype, shape, data_offsets}
(offsets relative to the end of the header). Payloads decode straight into
CPU torch tensors (`torch.frombuffer` on the bytes in the stored dtype:
bf16, fp8 e4m3 / e5m2 included) and are written back from torch dtypes,
so a file written by either package reads byte-equal in the other.
`LazyStateDict` exposes one or many shard files as a Mapping that reads
each tensor on access: models/convert.py:from_hf consumes tensors one at a
time, so peak host memory is one tensor, not the model.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import torch

__all__ = ["LazyStateDict", "read_safetensors", "write_safetensors",
           "shard_files"]

_ST_TO_TORCH = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}


def _read_header(path: str):
    """-> (header dict, data_start byte offset)."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    header.pop("__metadata__", None)
    return header, 8 + hlen


class LazyStateDict(Mapping):
    """Mapping over one or more safetensors shards; tensors are read from
    disk on access (one seek + read each, into a CPU tensor of the stored
    dtype), never all at once."""

    def __init__(self, files):
        self._index = {}  # name -> (path, torch dtype, shape, start, nbytes)
        for path in files:
            header, data_start = _read_header(path)
            for name, info in header.items():
                st_dtype = info["dtype"]
                if st_dtype not in _ST_TO_TORCH:
                    raise NotImplementedError(
                        f"safetensors dtype {st_dtype!r} ({name})")
                lo, hi = info["data_offsets"]
                self._index[name] = (path, _ST_TO_TORCH[st_dtype],
                                     tuple(info["shape"]), data_start + lo,
                                     hi - lo)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, dtype, shape, start, nbytes = self._index[name]
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(nbytes)
        with open(path, "rb") as f:
            f.seek(start)
            if f.readinto(buf) != nbytes:
                raise ValueError(f"{path}: {name} is truncated")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)


def shard_files(path: str) -> list[str]:
    """Resolve a checkpoint path to its safetensors shard file list.

    Accepts: a single .safetensors file, a directory containing either
    `model.safetensors`, a `*.safetensors.index.json` shard index (the HF
    multi-shard layout), or any set of .safetensors files."""
    if os.path.isfile(path):
        return [path]
    index = [f for f in os.listdir(path)
             if f.endswith(".safetensors.index.json")]
    if index:
        with open(os.path.join(path, index[0])) as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(path, f) for f in sorted(set(weight_map.values()))]
    shards = sorted(f for f in os.listdir(path)
                    if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return [os.path.join(path, f) for f in shards]


def read_safetensors(path: str) -> LazyStateDict:
    """Open a checkpoint (file or HF-layout directory) as a lazy Mapping."""
    return LazyStateDict(shard_files(path))


def write_safetensors(path: str, tensors: dict) -> None:
    """Write {name: tensor} to one safetensors file, in each tensor's own
    dtype (a tensor on the card is copied to the host one at a time)."""
    header = {}
    offset = 0
    for name, t in tensors.items():
        st = _TORCH_TO_ST.get(t.dtype)
        if st is None:
            raise NotImplementedError(f"dtype {t.dtype} ({name})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": st, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for t in tensors.values():
            if t.numel():
                raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                f.write(raw.numpy().data)
