"""Minimal zero-copy safetensors reader (pure NumPy, no torch).

Replaces the reference's GGUF tensor streaming (src/gguf_loader.cpp:154-227)
as the primary weight path: this build loads HF checkpoints directly
(BASELINE.json north star: "weight loading moves from GGUF to a
safetensors-to-JAX converter").
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Dict, Iterator, Tuple

import numpy as np

try:
    import ml_dtypes
    _BF16 = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover
    _BF16 = None

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class SafetensorsFile:
    """mmap-backed random access to one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()
        (header_len,) = np.frombuffer(self._mm[:8], dtype="<u8")
        self.header = json.loads(self._mm[8: 8 + int(header_len)].decode("utf-8"))
        self._data_start = 8 + int(header_len)
        self.header.pop("__metadata__", None)

    def keys(self):
        return self.header.keys()

    def tensor(self, name: str) -> np.ndarray:
        info = self.header[name]
        start, end = info["data_offsets"]
        buf = self._mm[self._data_start + start: self._data_start + end]
        dt = info["dtype"]
        if dt == "BF16":
            if _BF16 is not None:
                arr = np.frombuffer(buf, dtype=_BF16)
            else:
                raw = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
                arr = raw.view(np.float32)
        else:
            arr = np.frombuffer(buf, dtype=_DTYPES[dt])
        return arr.reshape(info["shape"])


class SafetensorsDir:
    """All *.safetensors under a directory as one name->tensor namespace."""

    def __init__(self, path: str):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
        )
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
        self.files = [SafetensorsFile(p) for p in files]
        self.index: Dict[str, SafetensorsFile] = {}
        for sf in self.files:
            for k in sf.keys():
                self.index[k] = sf

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def keys(self):
        return self.index.keys()

    def tensor(self, name: str) -> np.ndarray:
        return self.index[name].tensor(name)

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for k in self.index:
            yield k, self.tensor(k)


_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Minimal safetensors writer (tests / checkpoint export)."""
    header = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if _BF16 is not None and arr.dtype == _BF16:
            dt = "BF16"
        else:
            dt = _DTYPE_NAMES[arr.dtype]
        blob = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(np.uint64(len(hdr)).tobytes())
        f.write(hdr)
        for blob in blobs:
            f.write(blob)
