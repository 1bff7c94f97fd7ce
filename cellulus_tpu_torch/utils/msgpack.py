"""A msgpack decoder for the JAX package's ``.ckpt`` checkpoints.

The JAX package writes its train state with
``flax.serialization.msgpack_serialize`` (``cellulus_tpu/utils/checkpoint.py``):
a msgpack map whose array leaves are ext type 1, an ndarray whose payload
is itself msgpack ``(shape, dtype name, C-order bytes)``, and whose numpy
scalars are ext type 3 with the same payload. This module reads that
format with the standard library and numpy, since neither ``flax`` nor the
``msgpack`` package is a dependency of the port.

:func:`unpackb` decodes nil, bool, ints of every width, float32/64, str,
bin, arrays (as lists) and maps (as dicts), and the two ext types above:
an ndarray becomes a numpy array, except ``bfloat16``, which numpy lacks,
and becomes a ``torch.bfloat16`` tensor (a ``uint16`` view of the bytes); a
numpy scalar becomes a numpy scalar or a 0-dim tensor. Anything else
raises ``ValueError``: ext type 2 (complex), flax's chunked arrays
(``__msgpack_chunked_array__``, written only for leaves over 2**30 bytes),
a byte that starts no msgpack object, a truncated input, or bytes left
over after the top-level object.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

# fixed-width numbers: marker -> struct format
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FLOATS = {0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}
# marker -> (kind, bytes of its length field)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4),
          0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}
# fixext markers -> payload bytes
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(
                f"truncated: {n} bytes wanted at offset {self.pos} of {len(self.data)}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _INTS:
            return self.unpack(_INTS[b])
        if b in _FLOATS:
            return self.unpack(_FLOATS[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return self.read_ext(code, _FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LENGTHS[width])
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.read_str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.read_map(n)
            code = self.unpack(">b")
            return self.read_ext(code, n)
        raise ValueError(f"byte 0x{b:02x} at offset {at} starts no msgpack object")

    def read_str(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw_str else raw.decode("utf-8")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                "flax chunked array (a leaf over 2**30 bytes) is not supported"
            )
        return out

    def read_ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack ext type {code} is not supported")


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: msgpack ``(shape, dtype name, bytes)``."""
    reader = _Reader(payload, raw_str=True)
    item = reader.read()
    if reader.pos != len(payload):
        raise ValueError("bytes left over in an ndarray payload")
    if not (isinstance(item, list) and len(item) == 3):
        raise ValueError("an ndarray payload is not (shape, dtype, bytes)")
    shape, name, buffer = item
    if not isinstance(shape, list) or not all(isinstance(s, int) for s in shape):
        raise ValueError(f"an ndarray payload has shape {shape!r}")
    name = name.decode() if isinstance(name, bytes) else str(name)
    if name == "bfloat16":
        raw = np.frombuffer(buffer, dtype=np.uint16).reshape(shape, order="C")
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"ndarray dtype {name!r} is unknown") from e
    if dtype.hasobject or dtype.kind == "c":
        raise ValueError(f"ndarray dtype {name} is not supported")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C").copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes left over after the object")
    return out


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head``, a file's first bytes, starts a non-empty msgpack map
    (a flax checkpoint). 0x80, a map of no entries, is also a pickle's first
    byte (its PROTO opcode), and a zip starts with ``PK``: neither is taken."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
