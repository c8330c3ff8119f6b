"""The safetensors file format, read and written with numpy and torch
only (the ``safetensors`` package is not a dependency).

A file is an 8-byte little-endian header length N, then N bytes of JSON
— ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus
an optional ``"__metadata__"`` of strings — padded with spaces to a
multiple of 8, then the tensors' raw little-endian bytes, ``data_offsets``
counting from the end of the header.  A sharded checkpoint is a directory
of such files and ``model.safetensors.index.json``, whose ``weight_map``
names the shard of each tensor.

bf16 travels as its 16-bit pattern (read as int16, viewed as bf16).
Tensors are read and written in the host's byte order, which must be
little-endian (as on x86-64 and AArch64 Linux).
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import Iterator

import numpy as np
import torch

INDEX_NAME = "model.safetensors.index.json"
_MAX_HEADER = 100 * 1024 * 1024

# safetensors dtype -> (torch dtype the bytes are read as, bytes an element)
_DTYPES = {
    "BF16": (torch.int16, 2), "F16": (torch.float16, 2), "F32": (torch.float32, 4),
    "F64": (torch.float64, 8), "I8": (torch.int8, 1), "U8": (torch.uint8, 1),
    "I32": (torch.int32, 4), "I64": (torch.int64, 8),
}
_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
          torch.float64: "F64", torch.int8: "I8", torch.uint8: "U8",
          torch.int32: "I32", torch.int64: "I64"}


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data) of one
    file.  Raises ValueError on a truncated or malformed header."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > min(size - 8, _MAX_HEADER):
            raise ValueError(f"{path}: header length {n} past the end of the file "
                             f"({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    data_len = size - 8 - n
    for name, entry in header.items():
        try:
            dtype, shape, (begin, end) = entry["dtype"], entry["shape"], entry["data_offsets"]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad header entry {name!r}: {entry!r}") from e
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: {name!r} has unsupported dtype {dtype!r}")
        want = math.prod(shape) * _DTYPES[dtype][1]
        if not 0 <= begin <= end <= data_len or end - begin != want:
            raise ValueError(f"{path}: {name!r} data_offsets {[begin, end]} do not hold "
                             f"{dtype} {shape} in {data_len} data bytes")
    return header, 8 + n


def iter_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every tensor of one file, in offset order,
    one tensor in memory at a time."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        for name, e in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            read_as, _ = _DTYPES[e["dtype"]]
            begin, end = e["data_offsets"]
            f.seek(start + begin)
            buf = bytearray(end - begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name!r} is truncated")
            t = (torch.frombuffer(buf, dtype=read_as) if buf
                 else torch.empty((0,), dtype=read_as))
            if e["dtype"] == "BF16":
                t = t.view(torch.bfloat16)
            yield name, t.reshape(e["shape"])


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one file, on the CPU."""
    return dict(iter_file(path))


def checkpoint_files(path: str) -> list[str]:
    """The safetensors files of a checkpoint directory: the shards its
    index names, else every ``*.safetensors`` file, sorted."""
    index = os.path.join(path, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
    else:
        names = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    return [os.path.join(path, n) for n in names]


def iter_checkpoint(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) over every shard of a checkpoint directory."""
    for f in checkpoint_files(path):
        yield from iter_file(f)


def _as_tensor(x) -> torch.Tensor:
    """A tensor or numpy array (a numpy ``bfloat16`` array travels as its
    bits) → a contiguous CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def save_file(tensors: dict, path: str, metadata: dict[str, str] | None = None) -> None:
    """Write ``{name: tensor or numpy array}`` as one safetensors file,
    tensors in the dict's order."""
    ts = {k: _as_tensor(v) for k, v in tensors.items()}
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for name, t in ts.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in ts.values():
            if t.numel():
                bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                f.write(bits.numpy().tobytes())


def save_checkpoint(path: str, tensors: dict, max_shard_bytes: int) -> int:
    """Write a checkpoint directory: ``model.safetensors``, or shards of
    at most ``max_shard_bytes`` (a larger tensor gets a shard of its own)
    named as HF names them, with ``model.safetensors.index.json``.
    Returns the number of files."""
    os.makedirs(path, exist_ok=True)
    shards: list[dict] = [{}]
    size = 0
    total = 0
    for name, x in tensors.items():
        nbytes = int(x.numel() * x.element_size()) if isinstance(x, torch.Tensor) \
            else int(np.asarray(x).nbytes)
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = x
        size += nbytes
        total += nbytes
    if len(shards) == 1:
        save_file(shards[0], os.path.join(path, "model.safetensors"))
        return 1
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(path, fname))
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(path, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return len(shards)
