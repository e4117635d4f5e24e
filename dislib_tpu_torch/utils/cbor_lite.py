"""Self-contained CBOR codec (RFC 8949 definite-length subset).

Counterpart of ``dislib_tpu/utils/cbor_lite.py``, copied.
``save_model(..., save_format='cbor')`` uses the ``cbor2`` package where
it can be imported and this codec otherwise
(:mod:`dislib_tpu_torch.utils.saving`); for the payloads ``saving``
writes, both give the same bytes.

Scope: exactly the types `saving._encode` emits — None, bool, int, float,
str, bytes, list/tuple, dict — with definite lengths, the encoding cbor2
itself produces for these values.  The decoder additionally accepts
half/single-precision floats and 64-bit length arguments so files written
by cbor2 elsewhere load here.  Indefinite-length items and tags are
rejected with a clear error rather than silently misread.
"""

from __future__ import annotations

import struct


def dumps(obj) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def dump(obj, f) -> None:
    f.write(dumps(obj))


def loads(data: bytes):
    obj, off = _dec(memoryview(data), 0)
    if off != len(data):
        raise ValueError(f"trailing bytes after CBOR item ({len(data) - off})")
    return obj


def load(f):
    return loads(f.read())


# -- encoding ---------------------------------------------------------------

def _head(major: int, arg: int, out: bytearray) -> None:
    if arg < 24:
        out.append((major << 5) | arg)
    elif arg < 1 << 8:
        out.append((major << 5) | 24); out.append(arg)
    elif arg < 1 << 16:
        out.append((major << 5) | 25); out.extend(arg.to_bytes(2, "big"))
    elif arg < 1 << 32:
        out.append((major << 5) | 26); out.extend(arg.to_bytes(4, "big"))
    elif arg < 1 << 64:
        out.append((major << 5) | 27); out.extend(arg.to_bytes(8, "big"))
    else:
        raise OverflowError("integer exceeds 64-bit CBOR argument")


def _enc(obj, out: bytearray) -> None:
    if obj is False:
        out.append(0xF4)
    elif obj is True:
        out.append(0xF5)
    elif obj is None:
        out.append(0xF6)
    elif isinstance(obj, int):
        if obj >= 0:
            _head(0, obj, out)
        else:
            _head(1, -1 - obj, out)
    elif isinstance(obj, float):
        out.append(0xFB); out.extend(struct.pack(">d", obj))
    elif isinstance(obj, bytes):
        _head(2, len(obj), out); out.extend(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(3, len(b), out); out.extend(b)
    elif isinstance(obj, (list, tuple)):
        _head(4, len(obj), out)
        for o in obj:
            _enc(o, out)
    elif isinstance(obj, dict):
        _head(5, len(obj), out)
        for k, v in obj.items():
            _enc(k, out); _enc(v, out)
    else:
        raise TypeError(f"cbor_lite cannot encode {type(obj).__name__}")


# -- decoding ---------------------------------------------------------------
#
# Every length/argument read is BOUNDS-CHECKED: a truncated file used to
# surface as an IndexError from `mv[off]`, or worse, a short `mv[off:off+n]`
# slice silently decoding to a wrong (smaller) length argument — the
# "length decode" failure class.  All damage now raises ValueError with a
# position, which `saving.load_model` wraps into a clear model-file error.

def _need(mv, off, n):
    if off + n > len(mv):
        raise ValueError(
            f"truncated CBOR: need {n} byte(s) at offset {off}, "
            f"have {len(mv) - off}")


def _arg(mv, off, info):
    if info < 24:
        return info, off
    if info == 24:
        _need(mv, off, 1)
        return mv[off], off + 1
    if info == 25:
        _need(mv, off, 2)
        return int.from_bytes(mv[off:off + 2], "big"), off + 2
    if info == 26:
        _need(mv, off, 4)
        return int.from_bytes(mv[off:off + 4], "big"), off + 4
    if info == 27:
        _need(mv, off, 8)
        return int.from_bytes(mv[off:off + 8], "big"), off + 8
    raise ValueError(f"unsupported CBOR additional info {info} "
                     "(indefinite lengths are out of scope)")


def _dec(mv, off):
    _need(mv, off, 1)
    ib = mv[off]; off += 1
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _arg(mv, off, info)
    if major == 1:
        n, off = _arg(mv, off, info)
        return -1 - n, off
    if major == 2:
        n, off = _arg(mv, off, info)
        _need(mv, off, n)
        return bytes(mv[off:off + n]), off + n
    if major == 3:
        n, off = _arg(mv, off, info)
        _need(mv, off, n)
        return bytes(mv[off:off + n]).decode("utf-8"), off + n
    if major == 4:
        n, off = _arg(mv, off, info)
        items = []
        for _ in range(n):
            o, off = _dec(mv, off)
            items.append(o)
        return items, off
    if major == 5:
        n, off = _arg(mv, off, info)
        d = {}
        for _ in range(n):
            k, off = _dec(mv, off)
            v, off = _dec(mv, off)
            d[k] = v
        return d, off
    if major == 7:
        if info == 20:
            return False, off
        if info == 21:
            return True, off
        if info in (22, 23):          # null / undefined
            return None, off
        if info == 25:
            _need(mv, off, 2)
            return float(struct.unpack(">e", mv[off:off + 2])[0]), off + 2
        if info == 26:
            _need(mv, off, 4)
            return float(struct.unpack(">f", mv[off:off + 4])[0]), off + 4
        if info == 27:
            _need(mv, off, 8)
            return float(struct.unpack(">d", mv[off:off + 8])[0]), off + 8
        raise ValueError(f"unsupported CBOR simple value {info}")
    raise ValueError(f"unsupported CBOR major type {major} (tags are out "
                     "of scope)")
