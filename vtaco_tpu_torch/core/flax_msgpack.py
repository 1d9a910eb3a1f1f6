"""A reader of the msgpack files that flax writes (port of what
``flax.serialization.msgpack_restore`` reads; the JAX package's
``CheckpointIO.save`` writes its ``model.ckpt`` with
``msgpack_serialize``, vtaco_tpu/core/checkpoint.py:43-52).

The port reads JAX checkpoints wherever it runs, with neither JAX, flax
nor the ``msgpack`` package installed, so this module decodes the format
itself: maps, arrays, strings, bytes, nil, booleans, integers and floats,
and flax's extension types

  1  ndarray: a msgpack (shape, dtype name, C-order bytes) triple
  2  complex: a msgpack (real, imag) pair
  3  numpy scalar: an ndarray of shape ()

An array larger than flax's ``MAX_CHUNK_SIZE`` is written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": a0, ...}}`` of flat pieces; ``loads`` joins them back. Arrays come
back as numpy arrays (little-endian, as flax writes them on every host
the JAX package runs on), except ``bfloat16``, which numpy lacks: its
bytes are read as uint16 and viewed as a ``torch.bfloat16`` tensor. An
unknown extension type, dtype or header byte raises ValueError naming
it; nothing is returned half decoded.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# the dtype names numpy reads as they are (flax writes ``dtype.name``)
_DTYPES = frozenset(
    ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
     "uint64", "float16", "float32", "float64", "complex64", "complex128"])

# header byte → (struct format, size) of fixed-width scalars
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
            0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
            0xd2: (">i", 4), 0xd3: (">q", 8)}
# header byte → byte count of the length field (str, bin, array, map, ext)
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def value(self, raw=False):
        """The next object; ``raw`` keeps strings as bytes (flax's ndarray
        triples are read with ``raw=True``)."""
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value(raw) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f, raw)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            fmt, n = _SCALARS[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _STR:
            return self.string(self.uint(_STR[b]), raw)
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return [self.value(raw) for _ in range(self.uint(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.uint(_MAP[b]))
        if b in _EXT or b in _FIXEXT:
            n = self.uint(_EXT[b]) if b in _EXT else _FIXEXT[b]
            code = int.from_bytes(self.take(1), "big", signed=True)
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack header byte 0x{b:02x} at offset {self.pos - 1} "
                         f"is not one the format defines")

    def string(self, n, raw):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes, int)):
                raise ValueError(f"msgpack map key of type {type(k).__name__}")
            out[k] = self.value()
        return out


def _ndarray(data):
    """flax's (shape, dtype name, bytes) triple → numpy array, or a
    torch.bfloat16 tensor for a bfloat16 one."""
    r = _Reader(data)
    triple = r.value(raw=True)
    if r.pos != len(r.buf) or not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError("a flax ndarray extension is not one (shape, dtype, "
                         "bytes) triple")
    shape, name, buf = triple
    name = name.decode() if isinstance(name, bytes) else str(name)
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype="<u2").copy().reshape(shape)
        return torch.from_numpy(a.astype(np.int16, copy=False)).view(torch.bfloat16)
    if name not in _DTYPES:
        raise ValueError(f"a flax ndarray of dtype {name!r}, which the reader does "
                         f"not know")
    dt = np.dtype(name).newbyteorder("<")
    return np.frombuffer(buf, dtype=dt).astype(dt.newbyteorder("="),
                                                copy=True).reshape(shape)


def _ext(code, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        r = _Reader(data)
        re, im = r.value()
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code}, which flax does not write")


def _unchunk(tree):
    """Chunked arrays joined back, in place, as flax's
    ``_unchunk_array_leaves_in_place``."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def loads(data) -> object:
    """The object tree of one msgpack document as flax wrote it."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack document")
    return _unchunk(out)


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head``, a file's first bytes, opens a msgpack map with at
    least one entry (a fixmap, map16 or map32 header), as every flax
    checkpoint does."""
    return len(head) > 0 and (0x81 <= head[0] <= 0x8f or head[0] in _MAP)
