"""flax's msgpack checkpoint format on the standard library.

The JAX package writes its native ``.ntc`` checkpoints with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``. This module reads and writes the same bytes without
flax or msgpack:

- msgpack's nil, bool, int, float (read as 32 or 64 bit, written as 64),
  str, bin, array and map, each in the narrowest encoding msgpack-python's
  packer picks;
- numpy arrays as flax's ext type 1 and numpy scalars as ext type 3, whose
  payload is the msgpack of ``(shape, dtype name, C-order bytes)``;
- an array above ``MAX_CHUNK_SIZE`` bytes held in a dict (or the whole
  tree) as flax's ``{"__msgpack_chunked_array__": True, "shape": {...},
  "chunks": {...}}``;
- every map's keys in sorted order, as flax writes them.

So ``msgpack_serialize`` gives flax's bytes for any tree flax serializes
(tuples are written as arrays, which flax refuses), and ``msgpack_restore``
returns what flax would, with one exception: numpy has no bfloat16, so a
bfloat16 array is read as the float32 array of the same values.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization.MAX_CHUNK_SIZE: bytes an array leaf may hold
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# --- encoding ---------------------------------------------------------------

def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for limit, head, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if x <= limit:
                out.append(head)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")
    else:
        for limit, head, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q")):
            if x >= limit:
                out.append(head)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], heads: Tuple[int, ...]) -> None:
    """A length header: the fix form (base, limit) when n is below its limit,
    else the 8- (when heads has three), 16- or 32-bit form."""
    base, limit = fix
    if n < limit:
        out.append(base | n)
        return
    forms = list(zip(heads, (">B", ">H", ">I")[-len(heads):],
                     (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(heads):]))
    for head, fmt, top in forms:
        if n <= top:
            out.append(head)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_bin(out: bytearray, data: bytes) -> None:
    _pack_len(out, len(data), (0xC4, 0), (0xC4, 0xC5, 0xC6))
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), (0xC7, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(out, obj)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif kind is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif kind in (bytes, bytearray, memoryview):
        _pack_bin(out, bytes(obj))
    elif kind in (list, tuple):
        _pack_len(out, len(obj), (0x90, 16), (0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif kind is dict:
        _pack_len(out, len(obj), (0x80, 16), (0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {kind.__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (no chunking)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a flat array cut into chunks of MAX_CHUNK_SIZE bytes."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place`` without the in place: dicts are
    walked, lists are not."""
    if isinstance(tree, np.ndarray):
        return _chunk(tree) if tree.nbytes > MAX_CHUNK_SIZE else tree
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) if isinstance(v, (dict, np.ndarray)) else v
                for k, v in tree.items()}
    return tree


def _sorted_keys(tree: Any) -> Any:
    """The tree with every dict's keys in sorted order, as flax's copy of it
    (``jax.tree_util.tree_map``) has them."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_keys(v) for v in tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, for a tree of dicts,
    lists, Python scalars and numpy arrays."""
    return packb(_chunk_leaves(_sorted_keys(tree)))


# --- decoding ---------------------------------------------------------------

def _ndarray_from(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``."""
    shape, name, buffer = unpackb(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# head byte -> (length format, the _Reader method that reads that many)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
          0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(key).__name__} is not allowed")
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.number(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from(payload)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        head = self.number(">B")
        if head < 0x80:
            return head
        if head >= 0xE0:
            return head - 0x100
        if head < 0x90:
            return self.map(head & 0x0F)
        if head < 0xA0:
            return self.array(head & 0x0F)
        if head < 0xC0:
            return self.text(head & 0x1F)
        if head in _CONSTANTS:
            return _CONSTANTS[head]
        if head in _NUMBERS:
            return self.number(_NUMBERS[head])
        if head in _FIXEXT:
            return self.ext(_FIXEXT[head])
        if head in _SIZED:
            fmt, method = _SIZED[head]
            return getattr(self, method)(self.number(fmt))
        raise ValueError(f"invalid msgpack byte 0x{head:02x}")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """The object msgpack ``data`` holds; str as bytes when ``raw``."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: dicts are walked, lists are not."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                tree[key] = _unchunk_leaves(value)
    return tree


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``."""
    return _unchunk_leaves(unpackb(data))
