"""Read and write the JAX package's checkpoints without flax or msgpack.

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

``pack`` writes the same subset, byte for byte as
``flax.serialization.msgpack_serialize``: maps (keys sorted, as flax's
tree copy sorts them), lists, str, int, float, bool and nil, ndarrays as
ext type 1 and numpy scalars as ext type 3; a ``torch.Tensor`` leaf is
written as the ndarray it holds (``torch.bfloat16`` with dtype name
``"bfloat16"`` and its uint16 bytes). A leaf over 2^30 bytes, which flax
would chunk, is refused.
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


MAX_LEAF_BYTES = 2 ** 30       # flax chunks larger leaves (MAX_CHUNK_SIZE)


def _sized(out: bytearray, n: int, small: Tuple[int, int], codes) -> None:
    """The header of a length-prefixed object: the fix form ``small``
    (first byte, largest length) when it fits, else the 8/16/32-bit
    length form of ``codes`` (None where msgpack has no such form)."""
    first, most = small
    if n <= most:
        out.append(first | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: an object of {n} entries or bytes")


def _pack_int(out: bytearray, v: int) -> None:
    if -32 <= v < 128:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
        if v > 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                       (0xD3, ">q"))
    for code, fmt in forms:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise ValueError(f"msgpack: int {v} does not fit 64 bits")


def _pack_bytes(out: bytearray, b: bytes) -> None:
    _sized(out, len(b), (0, -1), (0xC4, 0xC5, 0xC6))
    out += b


def _leaf_bytes(a) -> Tuple[tuple, str, np.ndarray]:
    """(shape, dtype name, C-order bytes as a uint8 array) of an ndarray or
    tensor leaf."""
    name = None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            name, a = "bfloat16", a.view(torch.int16)
        a = a.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured arrays are not "
                         "flax leaves")
    data = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return a.shape, name or a.dtype.name, data


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_leaf(out: bytearray, a, scalar: bool) -> None:
    """Ext type 1 (3 for a scalar) holding flax's ``_ndarray_to_bytes``:
    the msgpack of (shape, dtype name, C-order bytes)."""
    nbytes = a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.nbytes
    if nbytes > MAX_LEAF_BYTES:
        raise ValueError(
            f"msgpack: a leaf of {nbytes} bytes (over 2^30, which flax "
            "writes as a chunked array) is not supported")
    shape, name, data = _leaf_bytes(a)
    head = bytearray([0x93])                    # a 3-array
    _pack(head, [int(n) for n in shape])
    _pack(head, name)
    _sized(head, data.size, (0, -1), (0xC4, 0xC5, 0xC6))
    n = len(head) + data.size
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _sized(out, n, (0, -1), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", EXT_NPSCALAR if scalar else EXT_NDARRAY)
    out += head
    out += memoryview(data)


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        b = obj.encode("utf-8")
        _sized(out, len(b), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bytes(out, bytes(obj))
    elif type(obj) is dict:
        _sized(out, len(obj), (0x80, 15), (None, 0xDE, 0xDF))
        for k in sorted(obj):
            if type(k) is not str:
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, obj[k])
    elif type(obj) is list:
        _sized(out, len(obj), (0x90, 15), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_leaf(out, obj, scalar=False)
    elif isinstance(obj, np.generic):
        _pack_leaf(out, np.asarray(obj), scalar=True)
    else:
        raise TypeError(f"msgpack: {type(obj).__name__} is not a flax "
                        "state leaf")


def pack(obj) -> bytes:
    """The msgpack blob of ``obj`` (a tree of str-keyed dicts and lists over
    the leaves above), as ``flax.serialization.msgpack_serialize`` writes
    it."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
