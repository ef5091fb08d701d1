"""Pytree <-> bytes serialization: msgpack with a compact array encoding.

The reference's wire and checkpoint format, written and read here without
the ``msgpack`` package: ``dumps(tree)`` gives, byte for byte, what
``msgpack.packb(_encode(tree), use_bin_type=True)`` gives in the reference
(``repro.comm.serialize``), and ``loads`` reads any such message back.  An
array — a numpy array or scalar, or a torch tensor on any device — becomes
the map ``{"__nd__": True, "d": dtype tag, "s": shape, "b": raw bytes}``; a
tuple becomes ``{"__tuple__": [...]}``; lists, dicts, None, bools, ints,
floats (float64), strings and bytes are msgpack's own.

Arrays read back as numpy arrays, except the tag ``"bfloat16"`` (numpy has
no such type without ``ml_dtypes``): a bfloat16 tensor is written as its
raw 2-byte words and read back as a ``torch.bfloat16`` tensor through an
``int16`` view.

``message_bytes`` (exact, serializes) is the oracle for
``estimate_message_bytes`` (O(number of leaves), from msgpack's header
sizes and each array's ``nbytes``, no serialization).
"""
from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

_NDARRAY = "__nd__"
_TUPLE = "__tuple__"
_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------


def _dtype_tag(dt: np.dtype) -> str:
    # extension dtypes (bfloat16, float8_*) have an unhelpful .str ("V2");
    # the reference tags them by name
    return dt.name if dt.str.lstrip("<>|=").startswith("V") else dt.str


def _torch_tag(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return _BF16
    return _dtype_tag(torch.empty(0, dtype=dtype).numpy().dtype)


def _is_array(obj) -> bool:
    # numpy scalars have a dtype and a shape too: the reference encodes
    # them as 0-d arrays
    return isinstance(obj, (np.ndarray, torch.Tensor)) or (
        hasattr(obj, "dtype") and hasattr(obj, "shape"))


def _host_array(obj):
    """-> (dtype tag, shape, C-contiguous host numpy array of the bytes)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, list(t.shape), t.view(torch.int16).numpy()
        arr = t.numpy()
    else:
        arr = np.asarray(obj)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
    return _dtype_tag(arr.dtype), list(arr.shape), arr


def _array_from(tag: str, shape, data) -> Any:
    if tag == _BF16:
        n = int(np.prod(shape, dtype=np.int64))
        if n == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.int16).view(
            torch.bfloat16).reshape(shape)
    try:
        dt = np.dtype(tag)
    except TypeError:
        raise ValueError(f"unsupported array dtype tag {tag!r} (only "
                         f"numpy's own dtypes and {_BF16!r} are read)")
    # bytearray gives a writable buffer: one copy, a writable array
    return np.frombuffer(bytearray(data), dtype=dt).reshape(shape)


# ---------------------------------------------------------------------------
# writer: the subset of msgpack the encoding produces
# ---------------------------------------------------------------------------


def _int(v: int, out: List) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes, out: List) -> None:
    """Length header: ``fix | n`` up to ``fix_max``, else the 8/16/32-bit
    form among ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


def _str(s: str, out: List) -> None:
    b = s.encode("utf-8")
    _header(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _bin(b, n: int, out: List) -> None:
    _header(n, None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _array_header(n: int, out: List) -> None:
    _header(n, 0x90, 0x0F, (None, 0xDC, 0xDD), out)


def _map_header(n: int, out: List) -> None:
    _header(n, 0x80, 0x0F, (None, 0xDE, 0xDF), out)


def _scalar(obj, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        _bin(bytes(obj), len(obj), out)
    elif isinstance(obj, str):
        _str(obj, out)
    elif isinstance(obj, memoryview):
        _bin(obj, obj.nbytes, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def _pack(obj, out: List) -> None:
    if _is_array(obj):
        tag, shape, arr = _host_array(obj)
        _map_header(4, out)
        _str(_NDARRAY, out)
        out.append(b"\xc3")
        _str("d", out)
        _str(tag, out)
        _str("s", out)
        _array_header(len(shape), out)
        for d in shape:
            _int(int(d), out)
        _str("b", out)
        # the array's own memory: the one copy is the final join or write
        _bin(memoryview(arr.reshape(-1).view(np.uint8)), arr.nbytes, out)
    elif isinstance(obj, tuple):
        _map_header(1, out)
        _str(_TUPLE, out)
        _array_header(len(obj), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, list):
        _array_header(len(obj), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _map_header(len(obj), out)
        for k, v in obj.items():
            _scalar(k, out)          # keys are written as they are
            _pack(v, out)
    else:
        _scalar(obj, out)


def chunks(tree: Any) -> List:
    """The message as a list of byte chunks (arrays' chunks are views of
    their host memory): what :func:`dumps` joins and :func:`dump` writes."""
    out: List = []
    _pack(tree, out)
    return out


def dumps(tree: Any) -> bytes:
    return b"".join(chunks(tree))


def dump(tree: Any, f) -> None:
    """Write the message of ``tree`` to the binary file ``f`` chunk by
    chunk, without first joining it in memory."""
    f.writelines(chunks(tree))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def _take(self, fmt: str):
        v = struct.unpack_from(fmt, self.mv, self.pos)
        self.pos += struct.calcsize(fmt)
        return v[0]

    def _raw(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack message")
        b = self.mv[self.pos: self.pos + n]
        self.pos += n
        return b

    def read(self):
        """One object; bin payloads come back as memoryviews (no copy)."""
        c = self._take("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._list(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return str(self._raw(c & 0x1F), "utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(c)
        if fmt:
            return self._raw(self._take(fmt))
        fmt = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
               0xD3: ">q"}.get(c)
        if fmt:
            return self._take(fmt)
        fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}.get(c)
        if fmt:
            return str(self._raw(self._take(fmt)), "utf-8")
        if c in (0xDC, 0xDD):
            return self._list(self._take(">H" if c == 0xDC else ">I"))
        if c in (0xDE, 0xDF):
            return self._map(self._take(">H" if c == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def _list(self, n: int):
        return [_bytes(self.read()) for _ in range(n)]

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = _bytes(self.read())
            d[k] = self.read()
        if d.get(_NDARRAY):
            return _array_from(d["d"], d["s"], d["b"])
        d = {k: _bytes(v) for k, v in d.items()}
        if _TUPLE in d:
            return tuple(d[_TUPLE])
        return d


def _bytes(v):
    return bytes(v) if isinstance(v, memoryview) else v


def loads(data) -> Any:
    r = _Reader(data)
    out = _bytes(r.read())
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} trailing bytes after the "
                         f"msgpack message")
    return out


def message_bytes(tree: Any) -> int:
    """Exact size of a serialized message (the estimator's test oracle)."""
    return sum(len(c) if isinstance(c, bytes) else c.nbytes
               for c in chunks(tree))


# ---------------------------------------------------------------------------
# O(number of leaves) size estimation: no serialization, no data copies
# ---------------------------------------------------------------------------


def array_nbytes(arr) -> int:
    """Raw payload bytes of a tensor or array-like without copying."""
    size = 1
    for d in arr.shape:
        size *= int(d)
    dtype = arr.dtype
    return size * (dtype.itemsize if isinstance(dtype, torch.dtype)
                   else np.dtype(dtype).itemsize)


def _str_bytes(s: str) -> int:
    n = len(s.encode())
    if n < 32:
        return 1 + n           # fixstr
    if n < 256:
        return 2 + n           # str8
    if n < 2**16:
        return 3 + n           # str16
    return 5 + n               # str32


def _bin_bytes(n: int) -> int:
    if n < 256:
        return 2 + n           # bin8
    if n < 2**16:
        return 3 + n           # bin16
    return 5 + n               # bin32


def _container_header(n: int) -> int:
    return 1 if n < 16 else (3 if n < 2**16 else 5)  # fix/16/32


def _int_bytes(v: int) -> int:
    if -32 <= v < 128:
        return 1
    if 0 <= v < 256 or -128 <= v < 0:
        return 2
    if 0 <= v < 2**16 or -2**15 <= v < 0:
        return 3
    if 0 <= v < 2**32 or -2**31 <= v < 0:
        return 5
    return 9


def _array_header_bytes(arr) -> int:
    """msgpack size of the array wrapper map, minus the raw data."""
    tag = (_torch_tag(arr.dtype) if isinstance(arr, torch.Tensor)
           else _dtype_tag(np.dtype(arr.dtype)))
    n = array_nbytes(arr)
    header = _container_header(4)                      # 4-key map
    header += _str_bytes(_NDARRAY) + 1                 # "__nd__": True
    header += _str_bytes("d") + _str_bytes(tag)
    header += _str_bytes("s") + _container_header(len(arr.shape)) + sum(
        _int_bytes(int(d)) for d in arr.shape)
    header += _str_bytes("b") + _bin_bytes(n) - n
    return header


def estimate_message_bytes(obj: Any) -> int:
    """Serialized size of a pytree in O(number of leaves): byte-exact for
    the encodings :func:`dumps` emits, without building any buffer."""
    if _is_array(obj):
        return _array_header_bytes(obj) + array_nbytes(obj)
    if isinstance(obj, tuple):
        return (_container_header(1) + _str_bytes(_TUPLE)
                + _container_header(len(obj))
                + sum(estimate_message_bytes(x) for x in obj))
    if isinstance(obj, list):
        return _container_header(len(obj)) + sum(
            estimate_message_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return _container_header(len(obj)) + sum(
            estimate_message_bytes(k) + estimate_message_bytes(v)
            for k, v in obj.items())
    if isinstance(obj, bool) or obj is None:
        return 1
    if isinstance(obj, int):
        return _int_bytes(obj)
    if isinstance(obj, float):
        return 9               # float64
    if isinstance(obj, str):
        return _str_bytes(obj)
    if isinstance(obj, (bytes, bytearray)):
        return _bin_bytes(len(obj))
    raise TypeError(f"cannot estimate size of {type(obj).__name__}")
