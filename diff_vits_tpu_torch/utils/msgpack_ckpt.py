"""Read the JAX package's checkpoints without flax or msgpack.

``flax.serialization.msgpack_serialize`` (which the JAX package's
``train/checkpoint.py`` and vocoder checkpoints use) writes a msgpack map
whose array leaves are ext type 1: a msgpack array ``(shape, dtype name,
C-order bytes)`` packed into the ext's payload; numpy scalars are ext
type 3 in the same layout. This module decodes that subset of msgpack:
maps, arrays, str, bin, nil, bool, every int and float width, and ext
types 1 and 3. Array leaves come back as read-only numpy views of the
blob (no copy of the payload), ``bfloat16`` leaves as ``torch.bfloat16``
tensors. flax splits leaves over 2^30 bytes into
``__msgpack_chunked_array__`` maps; those are refused.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head`` (the first byte or more of a blob) opens a msgpack
    map, as every flax state blob does."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE,
                                                                      0xDF))


def _leaf(payload: memoryview, scalar: bool):
    shape, name, buf = _Reader(payload).read_all()
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    if name == "bfloat16":
        a = torch.from_numpy(np.frombuffer(buf, np.uint16).copy()).view(
            torch.bfloat16).reshape(tuple(shape))
        return a[()] if scalar else a
    a = np.frombuffer(buf, np.dtype(name)).reshape(tuple(shape))
    return a[()] if scalar else a


class _Reader:
    """A cursor over one msgpack blob."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def read_all(self):
        out = self.read()
        if self.pos != len(self.buf):
            raise ValueError(f"msgpack: {len(self.buf) - self.pos} bytes "
                             "after the object")
        return out

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(needs {n}, {len(self.buf) - self.pos} left)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            return _leaf(payload, code == EXT_NPSCALAR)
        raise ValueError(f"msgpack: ext type {code} is not a flax array")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            raise ValueError(
                "msgpack: a chunked array leaf (flax splits leaves over "
                "2^30 bytes) is not supported")
        return out

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = _SIMPLE.get(b)
        if simple is not None:
            return self._unpack(simple)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        kind, fmt = _SIZED.get(b, (None, None))
        if kind is None:
            if 0xD4 <= b <= 0xD8:          # fixext 1, 2, 4, 8, 16
                return self._ext(1 << (b - 0xD4))
            raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} "
                             "opens no object")
        n = self._unpack(fmt)
        if kind == "bin":
            return self._take(n)
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "ext":
            return self._ext(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        return self._map(n)


# scalars: byte -> struct format (big-endian)
_SIMPLE = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed objects: byte -> (kind, format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpack(data) -> Any:
    """The object of one msgpack blob (bytes or a buffer), flax's array ext
    types decoded."""
    return _Reader(data).read_all()


def read_flax_checkpoint(path: str) -> Tuple[int, Any]:
    """(step, state) of a ``model-<step>.ckpt`` the JAX package's
    ``train/checkpoint.save_checkpoint`` wrote."""
    with open(path, "rb") as f:
        data = unpack(f.read())
    if not isinstance(data, dict) or not {"step", "state"} <= set(data):
        raise ValueError(f"{path}: not a checkpoint of the JAX package "
                         "(no 'step' and 'state')")
    return int(data["step"]), data["state"]
