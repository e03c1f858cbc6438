"""HF checkpoint reading, streamed (port of ``ipex_llm_tpu/models/loader.py``).

A checkpoint is a weight source: tensors are read one name at a time from
local safetensors shards (or ``pytorch_model*.bin`` files) and handed to
``models/build.py::build_params``, which quantizes each before it reads
the next, so host memory stays about one layer ahead and no
full-precision model is ever built.

The port reads and writes the safetensors format itself with numpy (no
``safetensors`` package): an 8-byte little-endian header length, a JSON
header mapping each name to its ``dtype``, ``shape`` and ``data_offsets``
(relative to the end of the header; an optional ``__metadata__`` entry of
strings), then the raw bytes.  A file is mapped with ``np.memmap``, so
reading one tensor copies only that tensor's bytes.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np
import torch

# safetensors dtype names -> (numpy storage dtype, torch dtype).  bf16 has
# no numpy dtype: its bytes are read as int16 and reinterpreted.
_DTYPES = {
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "F64": (np.float64, torch.float64),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I16": (np.int16, torch.int16),
    "U16": (np.uint16, torch.uint16),
    "I32": (np.int32, torch.int32),
    "U32": (np.uint32, torch.uint32),
    "I64": (np.int64, torch.int64),
    "U64": (np.uint64, torch.uint64),
    "BOOL": (np.bool_, torch.bool),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
}
_NAME_OF_TORCH = {t: n for n, (_, t) in _DTYPES.items()}


class SafetensorsFile:
    """One safetensors file, mapped read-only; ``get`` copies one tensor."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self.entries = header
        self._base = 8 + n
        size = os.path.getsize(path)
        self._map = (np.memmap(path, np.uint8, mode="r")
                     if size > self._base else np.zeros(0, np.uint8))

    def keys(self) -> list[str]:
        return list(self.entries)

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored, on the CPU (a copy; bf16 stays bf16)."""
        e = self.entries[name]
        if e["dtype"] not in _DTYPES:
            raise NotImplementedError(
                f"{self.path}: {name} has safetensors dtype {e['dtype']!r}")
        np_dt, t_dt = _DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        raw = np.array(self._map[self._base + start:self._base + end])
        t = torch.from_numpy(raw.view(np_dt).reshape(e["shape"]))
        return t.view(t_dt) if t.dtype != t_dt else t


def save_safetensors(tensors: dict[str, torch.Tensor], path: str,
                     metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` as one safetensors file, in the given order, the
    header padded with spaces to 8 bytes as the format's own writer
    does."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, off = [], 0
    for name, x in tensors.items():
        t = x.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _NAME_OF_TORCH[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [off, off + raw.nbytes]}
        blobs.append(raw)
        off += raw.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw.data)


class CheckpointReader:
    """Lazy name -> tensor access over a local HF model directory: one
    ``model.safetensors``, shards listed in ``model.safetensors.index.json``,
    or ``pytorch_model*.bin`` files (``torch.load(weights_only=True)``)."""

    def __init__(self, path: str):
        self.path = path
        self._shard_of: dict[str, str] = {}
        self._torch_bins: list[str] = []
        self._torch_state = None
        st_files = sorted(f for f in os.listdir(path)
                          if f.endswith(".safetensors"))
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                self._shard_of = dict(json.load(f)["weight_map"])
        elif st_files:
            for shard in st_files:
                for name in self._open(shard).keys():
                    self._shard_of[name] = shard
        else:
            self._torch_bins = sorted(
                f for f in os.listdir(path)
                if f.endswith(".bin") and f.startswith("pytorch_model"))
            if not self._torch_bins:
                raise FileNotFoundError(
                    f"no safetensors or pytorch_model bins under {path}")

    @lru_cache(maxsize=8)
    def _open(self, shard: str) -> SafetensorsFile:
        return SafetensorsFile(os.path.join(self.path, shard))

    def _torch_tensors(self) -> dict:
        if self._torch_state is None:
            state: dict[str, torch.Tensor] = {}
            for b in self._torch_bins:
                state.update(torch.load(os.path.join(self.path, b),
                                        map_location="cpu",
                                        weights_only=True))
            self._torch_state = state
        return self._torch_state

    def names(self) -> list[str]:
        if self._shard_of:
            return sorted(self._shard_of)
        return sorted(self._torch_tensors())

    def has(self, name: str) -> bool:
        return name in self._shard_of or bool(
            self._torch_bins and name in self._torch_tensors())

    def get(self, name: str) -> torch.Tensor:
        """One tensor on the CPU, in its stored dtype (bf16, f16 and f32
        as stored; the reference widens bf16 and f16 to f32, exactly)."""
        if self._shard_of:
            return self._open(self._shard_of[name]).get(name)
        return self._torch_tensors()[name]


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)
