"""A reader and writer of the safetensors format in numpy (the port's own:
the card's machine has no ``safetensors`` package).

The layout: a little-endian u64 N, then N bytes of a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data that follows the header) and optionally ``"__metadata__"`` to a
string dict, the header padded with spaces to a multiple of 8 bytes; then the
tensors' bytes, little-endian, row-major, each one contiguous. numpy has no
bfloat16, so BF16 tensors are read and written as ``np.uint16`` bit patterns
(`bf16_to_f32` widens them). `load_torch` reads what the hub ships (a
diffusers or transformers folder, sharded or not) into torch tensors.
"""

from __future__ import annotations

import glob
import json
import struct
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

# safetensors dtype name -> numpy dtype (BF16 as its bit patterns)
DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
          "BOOL": np.bool_}
_NAMES = {np.dtype(v).newbyteorder("<"): k for k, v in DTYPES.items() if k not in ("BF16",)}


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """BF16 bit patterns (uint16) -> float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def save_file(tensors: Mapping[str, np.ndarray], path: str, bf16: tuple = ()) -> None:
    """Write ``tensors`` (numpy arrays) to ``path``. Names in ``bf16`` must be
    uint16 bit patterns and are stored as BF16."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])  # (np.ascontiguousarray would make a 0-d array 1-d)
        if name in bf16:
            if arr.dtype != np.uint16:
                raise TypeError(f"{name}: BF16 tensors are passed as uint16 bit patterns")
            dtype = "BF16"
        else:
            dtype = _NAMES.get(arr.dtype.newbyteorder("<"))
            if dtype is None:
                raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors name")
        data = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<"), copy=False))
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + data.nbytes]}
        blobs.append(data)
        offset += data.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data.data)  # the array's buffer, not a copy


def read_header(path: str) -> Dict:
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes is truncated")
    try:
        return json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a safetensors header ({e})") from e


def load_file(path: str, bf16_as_f32: bool = False) -> Dict[str, np.ndarray]:
    """Every tensor of ``path``: BF16 ones as uint16 bit patterns, or as
    float32 with ``bf16_as_f32``."""
    header = read_header(path)
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        f.seek(8 + n)
        data = f.read()
    out = {}
    for name, info in header.items():
        dtype = info["dtype"]
        if dtype not in DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {dtype}")
        begin, end = info["data_offsets"]
        npd = np.dtype(DTYPES[dtype]).newbyteorder("<")
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != count * npd.itemsize or end > len(data):
            raise ValueError(f"{path}: {name} spans bytes {begin}..{end}, not {info['shape']} "
                             f"of {dtype}")
        arr = np.frombuffer(data, npd, count, begin).reshape(info["shape"])
        arr = arr.astype(npd.newbyteorder("="))
        out[name] = bf16_to_f32(arr) if dtype == "BF16" and bf16_as_f32 else arr
    return out


def _mapped(path: str):
    """(name, dtype name, numpy array over the file's bytes) of each tensor of
    ``path``; the arrays are read-only views of a memory map."""
    header = read_header(path)
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    data = np.memmap(path, np.uint8, "r", offset=8 + n)
    for name, info in header.items():
        dtype = info["dtype"]
        if dtype not in DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {dtype}")
        begin, end = info["data_offsets"]
        npd = np.dtype(DTYPES[dtype]).newbyteorder("<")
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != count * npd.itemsize or end > data.shape[0]:
            raise ValueError(f"{path}: {name} spans bytes {begin}..{end}, not {info['shape']} "
                             f"of {dtype}")
        yield name, dtype, data[begin:end].view(npd).reshape(info["shape"])


def _to_torch(dtype: str, arr: np.ndarray) -> torch.Tensor:
    if dtype == "BF16":  # the bit patterns, reinterpreted
        return torch.from_numpy(arr.astype("<u2").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, arr.dtype.newbyteorder("=")))


def load_torch(patterns: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Every tensor of the files that ``patterns`` (globs) match, each in its
    file's dtype (F32, F16, BF16, and integer ones such as CLIP's
    ``position_ids``), each pattern's files in sorted order and later files
    overriding earlier keys, as `scripts/port_weights.py:load_safetensors`
    merges them. Raises FileNotFoundError when nothing matches."""
    out = {}
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            out.update((name, _to_torch(d, arr)) for name, d, arr in _mapped(path))
    if not out:
        raise FileNotFoundError(f"no safetensors tensors in {list(patterns)}")
    return out
