"""``tgq_torch.models.safetensors_io`` against the ``safetensors`` package:
files written by either read bit for bit in the other, for every dtype the
port supports, sharded checkpoints through the index, and malformed or
truncated files raise."""
import json
import os
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from tgq_torch.models import safetensors_io as sio

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
          torch.uint8, torch.int32, torch.int64]


def _tensor(dtype, shape=(3, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 100).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_port_writes_safetensors_reads(tmp_path, dtype):
    ts = {"x": _tensor(dtype), "scalar": _tensor(dtype, ()), "empty": _tensor(dtype, (0, 4)),
          "vec": _tensor(dtype, (7,), seed=1)}
    path = str(tmp_path / "a.safetensors")
    sio.save_file(ts, path, metadata={"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(ts)
        assert f.metadata() == {"format": "pt"}
        for k in ts:
            assert _same(f.get_tensor(k), ts[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_writes_port_reads(tmp_path, dtype):
    ts = {"x": _tensor(dtype), "scalar": _tensor(dtype, ()), "empty": _tensor(dtype, (0, 4)),
          "w": _tensor(dtype, (2, 3, 4), seed=2)}
    path = str(tmp_path / "b.safetensors")
    st_save_file(ts, path, metadata={"k": "v"})
    got = sio.load_file(path)
    assert set(got) == set(ts)
    for k in ts:
        assert _same(got[k], ts[k]), k


def test_numpy_bf16_arrays_travel_as_bits(tmp_path):
    """A numpy bfloat16 array (the JAX package's leaves) is written as BF16."""
    import ml_dtypes

    a = np.arange(-6, 6, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "c.safetensors")
    sio.save_file({"a": a}, path)
    got = sio.load_file(path)["a"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_checkpoint_with_index(tmp_path, n_shards):
    ts = {f"layer.{i}.w": _tensor(torch.bfloat16, (16, 16), seed=i) for i in range(6)}
    nbytes = 16 * 16 * 2
    files = sio.save_checkpoint(str(tmp_path), ts, max_shard_bytes=2 * nbytes if n_shards == 3
                                else 6 * nbytes)
    assert files == n_shards
    index = tmp_path / sio.INDEX_NAME
    assert index.exists() == (n_shards > 1)
    if n_shards > 1:
        meta = json.load(open(index))
        assert set(meta["weight_map"]) == set(ts)
        assert meta["metadata"]["total_size"] == 6 * nbytes
        for name, shard in meta["weight_map"].items():  # each shard reads in safetensors
            with safe_open(str(tmp_path / shard), framework="pt") as f:
                assert _same(f.get_tensor(name), ts[name])
    got = dict(sio.iter_checkpoint(str(tmp_path)))
    assert set(got) == set(ts) and all(_same(got[k], ts[k]) for k in ts)


def test_checkpoint_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        sio.checkpoint_files(str(tmp_path))


def _write_raw(path, header, data=b"", header_len=None):
    raw = header if isinstance(header, bytes) else json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw) if header_len is None else header_len))
        f.write(raw)
        f.write(data)


GOOD = {"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}
BAD = {
    "short_length": dict(raw=b"\x01\x02\x03"),
    "length_past_end": dict(header=GOOD, data=b"\0" * 8, header_len=10 ** 6),
    "not_json": dict(header=b"{not json", data=b""),
    "not_object": dict(header=[1, 2], data=b""),
    "missing_key": dict(header={"x": {"dtype": "F32", "shape": [2]}}, data=b"\0" * 8),
    "bad_dtype": dict(header={"x": {"dtype": "Q7", "shape": [2], "data_offsets": [0, 8]}},
                      data=b"\0" * 8),
    "offsets_past_data": dict(header=GOOD, data=b"\0" * 4),
    "size_mismatch": dict(header={"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
                          data=b"\0" * 8),
    "negative_offsets": dict(header={"x": {"dtype": "F32", "shape": [2],
                                           "data_offsets": [-8, 0]}}, data=b"\0" * 8),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_files_raise(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    spec = BAD[case]
    if "raw" in spec:
        with open(path, "wb") as f:
            f.write(spec["raw"])
    else:
        _write_raw(path, spec["header"], spec["data"], spec.get("header_len"))
    with pytest.raises(ValueError):
        sio.load_file(path)


def test_truncated_file_raises(tmp_path):
    """A file cut short inside its data (a partial download) raises."""
    path = str(tmp_path / "t.safetensors")
    sio.save_file({"a": _tensor(torch.float32, (64,)), "b": _tensor(torch.float32, (64,))}, path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 100)
    with pytest.raises(ValueError):
        sio.load_file(path)
    sio_ok = str(tmp_path / "ok.safetensors")
    sio.save_file({"a": _tensor(torch.float32, (64,))}, sio_ok)
    assert sio.load_file(sio_ok)["a"].shape == (64,)
