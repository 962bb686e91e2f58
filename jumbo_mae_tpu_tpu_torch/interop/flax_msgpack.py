"""The msgpack codec of ``flax.serialization``, in the standard library and
numpy.

``flax.serialization.msgpack_serialize`` writes a params tree as msgpack:
maps with string keys, and every array as extension type 1, whose payload
is itself msgpack of ``(shape, dtype name, C-order bytes)``; a numpy
scalar is type 3 with the same payload, a complex number type 2; an array
over 2**30 bytes is split into chunks under ``__msgpack_chunked_array__``.
:func:`packb` and :func:`unpackb` write and read that format without the
``msgpack`` package (the card's machine need not have it) or flax, so the
port reads the ``.msgpack`` params files the JAX package exports and
writes files its ``msgpack_restore`` reads.

A ``bfloat16`` array (numpy has no such dtype) reads as its exact
float32 upcast; a bfloat16 torch tensor is written as ``bfloat16``.
"""

from __future__ import annotations

import struct

import numpy as np

NDARRAY, COMPLEX, NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ write


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n < 2**8:
        out += b"\xcc" + struct.pack(">B", n)
    elif 0 <= n < 2**16:
        out += b"\xcd" + struct.pack(">H", n)
    elif 0 <= n < 2**32:
        out += b"\xce" + struct.pack(">I", n)
    elif 0 <= n < 2**64:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -(2**7) <= n:
        out += b"\xd0" + struct.pack(">b", n)
    elif -(2**15) <= n:
        out += b"\xd1" + struct.pack(">h", n)
    elif -(2**31) <= n:
        out += b"\xd2" + struct.pack(">i", n)
    elif -(2**63) <= n:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int], out: bytearray) -> None:
    """A length header: the fix form below ``fix_max`` (``fix`` is its
    base byte, ``None`` where the type has none), else 8/16/32-bit forms."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 2**8:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 2**16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < 2**32:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"a msgpack object of {n} entries or bytes is too long")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n < 2**8:
        out += b"\xc7" + struct.pack(">BB", n, code)
    elif n < 2**16:
        out += b"\xc8" + struct.pack(">HB", n, code)
    else:
        out += b"\xc9" + struct.pack(">IB", n, code)
    out += data


def _array_payload(arr) -> bytes:
    """``(shape, dtype name, bytes)`` as flax's ``_ndarray_to_bytes``
    writes it; a torch tensor is written as its numpy array (bfloat16 as
    its raw 16-bit words under the name ``bfloat16``)."""
    if not isinstance(arr, np.ndarray | np.generic):
        import torch

        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb((tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, np.integer):
        _pack_int(x, out)
    elif isinstance(x, float) and not isinstance(x, np.floating):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(x, bytes | bytearray | memoryview):
        b = bytes(x)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, (0, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, list | tuple):
        _pack_len(len(x), 0x90, 16, (0, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.generic):
        _pack_ext(NPSCALAR, _array_payload(x), out)
    elif isinstance(x, np.ndarray) or type(x).__module__ == "torch":
        _pack_ext(NDARRAY, _array_payload(x), out)
    else:
        raise TypeError(f"cannot write a {type(x).__name__} as flax msgpack")


def _chunk_leaves(x):
    if isinstance(x, dict):
        return {k: _chunk_leaves(v) for k, v in x.items()}
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def packb(tree) -> bytes:
    """``tree`` (dicts, lists, tuples, Python scalars, numpy arrays and
    scalars, torch tensors) as ``flax.serialization.msgpack_serialize``
    writes it: numpy arrays over 2**30 bytes split into chunks."""
    out = bytearray()
    _pack(_chunk_leaves(tree), out)
    return bytes(out)


# ------------------------------------------------------------------- read


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _compound(r: _Reader, kind: str, n: int, raw: bool):
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        b = bytes(r.take(n))
        return b if raw else b.decode("utf-8")
    if kind == "array":
        return [_read(r, raw) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _read(r: _Reader, raw: bool = False):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _compound(r, "map", b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return _compound(r, "array", b & 0x0F, raw)
    if 0xA0 <= b <= 0xBF:
        return _compound(r, "str", b & 0x1F, raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        return _compound(r, kind, r.unpack(fmt), raw)
    if b in _FIXEXT or b in _EXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_EXT[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack byte 0x{b:02x} is not a type this codec reads")


def _array_from(data) -> np.ndarray:
    r = _Reader(data)
    shape, name, buf = _read(r, raw=True)
    name = name.decode()
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return words.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data):
    if code == NDARRAY:
        return _array_from(data)
    if code == NPSCALAR:
        return _array_from(data)[()]
    if code == COMPLEX:
        re, im = _read(_Reader(data))
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _unchunk(x):
    if isinstance(x, dict):
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns for
    ``data``: dicts, lists, Python scalars and numpy arrays (read-only
    views of ``data``), chunked arrays joined."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
