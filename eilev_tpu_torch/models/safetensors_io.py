"""safetensors files without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON that map
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end; relative to the end of the header), an optional ``__metadata__`` entry of
strings, then the raw little-endian buffers.

:class:`SafetensorsFile` reads one file through an mmap, one tensor at a
time, straight into the dtype and device asked for, so that loading a
checkpoint holds about one copy of it in host memory (the page cache), not a
dict of every tensor. :class:`SafetensorsDirectory` does the same over every
``*.safetensors`` of a ``save_pretrained`` directory (shards in sorted name
order, as ``eilev_tpu/models/convert.py:load_hf_checkpoint`` globs them).
:func:`save_file` writes one file; :func:`load_file` reads a whole file into
CPU tensors.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Any, Iterator, Mapping, Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
_ALIGN = 8  # the header is padded with spaces to a multiple of this, as the package pads it


class SafetensorsFile:
    """One ``.safetensors`` file, opened for reading (a context manager)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # copy-on-write: torch.frombuffer wants a writable buffer, and
            # nothing is ever written through it
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._base = 8 + n
        header.pop("__metadata__", None)
        self._header: dict[str, dict] = header
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")

    def keys(self) -> list[str]:
        return list(self._header)

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._header[name]["dtype"]]

    def get_tensor(self, name: str, *, dtype: Optional[torch.dtype] = None, device="cpu",
                   copy: bool = True) -> torch.Tensor:
        """A new tensor of ``name`` on ``device``, cast to ``dtype`` (default:
        as stored). Only this tensor's pages of the file are read. With
        ``copy=False`` on the CPU, a tensor of the stored dtype is a view of
        the mapped file (nothing is read until it is used), valid until the
        file is closed; a file with views alive cannot be closed."""
        info = self._header[name]
        stored = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = 1
        for n in shape:
            numel *= n
        if end - begin != numel * stored.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} holds {end - begin} bytes for shape {shape}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype or stored, device=device)
        view = torch.frombuffer(self._mm, dtype=stored, count=numel, offset=self._base + begin).reshape(shape)
        if torch.device(device).type == "cpu":
            return view.to(dtype=dtype or stored, copy=copy)
        # copy as stored, then cast on the device: a cast on the host first
        # runs there at a fraction of the copy's rate
        return view.to(device=device, copy=True).to(dtype or stored)

    def close(self) -> None:
        self._mm.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SafetensorsDirectory:
    """Every ``*.safetensors`` file under ``path`` (one or several shards), as
    one set of names (a context manager). Raises ``FileNotFoundError`` when
    there is none, as the JAX loader does."""

    def __init__(self, path: str):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        self.files = [SafetensorsFile(f) for f in files]
        self._where: dict[str, SafetensorsFile] = {}
        for sf in self.files:
            for name in sf.keys():
                self._where.setdefault(name, sf)

    def keys(self) -> list[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def dtype(self, name: str) -> torch.dtype:
        return self._where[name].dtype(name)

    def get_tensor(self, name: str, *, dtype: Optional[torch.dtype] = None, device="cpu",
                   copy: bool = True) -> torch.Tensor:
        return self._where[name].get_tensor(name, dtype=dtype, device=device, copy=copy)

    def view(self, *, dtype: Optional[torch.dtype] = None, device="cpu", copy: bool = True) -> "TensorView":
        return TensorView(self, dtype=dtype, device=device, copy=copy)

    def close(self) -> None:
        for sf in self.files:
            sf.close()

    def __enter__(self) -> "SafetensorsDirectory":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TensorView(Mapping):
    """A read-only name -> tensor mapping over a :class:`SafetensorsDirectory`
    that reads each tensor when it is looked up, on ``device``,
    floating-point tensors cast to ``dtype`` (default: as stored; integer
    tensors keep theirs); ``copy`` as :meth:`SafetensorsFile.get_tensor`'s."""

    def __init__(self, source: SafetensorsDirectory, *, dtype: Optional[torch.dtype] = None, device="cpu",
                 copy: bool = True):
        self.source, self.dtype, self.device, self.copy = source, dtype, device, copy

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self.source:
            raise KeyError(name)
        cast = self.dtype if self.source.dtype(name).is_floating_point else None
        return self.source.get_tensor(name, dtype=cast, device=self.device, copy=self.copy)

    def __contains__(self, name: object) -> bool:
        return name in self.source

    def __iter__(self) -> Iterator[str]:
        return iter(self.source.keys())

    def __len__(self) -> int:
        return len(self.source.keys())


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one file, as stored, on the CPU."""
    with SafetensorsFile(path) as sf:
        return {name: sf.get_tensor(name) for name in sf.keys()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (on any device) to ``path`` in their own dtypes, with
    the ``__metadata__`` that ``save_pretrained`` writes (``{"format":
    "pt"}``, which ``transformers`` checks). Each tensor is copied to the
    host on its own as it is written."""
    header: dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, tensor in tensors.items():
        if tensor.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {tensor.dtype}, not one of {list(_NAMES)}")
        nbytes = tensor.numel() * tensor.element_size()
        header[name] = {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for tensor in tensors.values():
            if tensor.numel():
                t = tensor.detach().to("cpu").contiguous()
                f.write(t.reshape(-1).view(torch.uint8).numpy())
