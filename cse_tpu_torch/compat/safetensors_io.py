"""A reader of the safetensors format with torch alone (no ``safetensors``).

The format: a little-endian u64 header length N, N bytes of JSON mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end
within the data section; a ``__metadata__`` entry holds strings), then the
raw little-endian bytes. :class:`SafetensorsFile` maps the file and hands out
one tensor at a time as a view of the mapping (``torch.frombuffer``), so a
checkpoint of many GB is read by the page cache, tensor by tensor, and never
gathered into a host dict. bf16 has no numpy dtype: its bytes are read as
int16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import mmap
import struct

import torch

DTYPES = {"F32": (torch.float32, torch.float32), "F16": (torch.float16, torch.float16),
          "BF16": (torch.int16, torch.bfloat16)}


class SafetensorsFile:
    """``with SafetensorsFile(path) as f: f.get(name)`` -> a CPU tensor that
    shares the file's mapping (copy-on-write: writing to it never reaches the
    file). The tensors keep the mapping alive after the file is closed."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._header = header
        self._base = 8 + n

    def keys(self) -> list[str]:
        return list(self._header)

    def get(self, name: str) -> torch.Tensor:
        info = self._header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"safetensors dtype {info['dtype']!r} of {name!r} is not read "
                             f"(only {', '.join(DTYPES)})")
        raw, dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=raw).element_size()
        if count == 0:
            return torch.empty(info["shape"], dtype=dtype)
        t = torch.frombuffer(self._mm, dtype=raw, count=count, offset=self._base + begin)
        return t.view(dtype).reshape(info["shape"])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
