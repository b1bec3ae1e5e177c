"""DSS — typed data serialization for the out-of-band plane (namesake:
``zhpe_ompi_tpu/utils/dss.py``; the port's own copy, carrying tensors).

Re-design of ``opal/dss``: the reference packs typed values (ints of every
width, strings, byte objects, nested containers) into self-describing
buffers for PMIx modex payloads and tool messages.  Same role here: the
host plane's wire format for the TCP transport — arrays carry their dtype
and shape, containers nest, and every value round-trips exactly.  The
format is the namesake's byte for byte, so a port rank and a JAX-package
rank read each other's frames.

Format: one type byte, then a varint length where needed, then the
payload; containers recurse.  Little-endian fixed-width scalars.

Zero-copy frame path: :func:`pack_frames` splits a frame into a
self-describing header stream plus out-of-band raw buffer segments —
contiguous array/bytes payloads are referenced as memoryviews, never
``tobytes()``-copied.  On the wire the frame is the header followed by the
segments in order, so ``header + b"".join(segments)`` is a valid
:func:`unpack` stream: the OOB tags carry the payload's offset from the
END of the frame.  :func:`unpack_from` builds arrays as views OVER a
writable receive buffer (``recv_into`` target) instead of copying them.

What the port adds, against the namesake:

- **CPU tensors** encode under the ndarray tag with the dtype string,
  shape and bytes numpy gives the same values (``Tensor.numpy()`` is a
  view, so nothing is copied to encode); on the frame path a contiguous
  one is an out-of-band memoryview segment of the tensor's own storage.
  Numpy arrays encode as in the namesake.
- **Decoding**: an ndarray record whose dtype torch has (native byte
  order: bool, int8–64, uint8–64, float16/32/64, complex64/128) decodes
  to a CPU ``torch.Tensor``; :func:`unpack_from` makes it a view of the
  receive buffer (the tensor keeps the buffer alive, and the buffer is
  dedicated to its frame, so a later receive never writes into it);
  :func:`unpack` returns a fresh copy, as the namesake does.  A record
  whose dtype torch lacks (strings, void, big-endian, datetime) decodes
  to a numpy array, as in the namesake.
- **Other devices are refused**: a tensor on any device but the CPU
  raises ``TypeError_`` (the namesake's class for an unpackable value)
  naming the explicit ``.cpu()`` the caller should make.  No copy to the
  host is ever made here.
- **bfloat16 is refused** with the same ``TypeError_``: numpy has no
  bfloat16, and the namesake writes an ``ml_dtypes.bfloat16`` array under
  the dtype string ``'<V2'``, which its receiver reads back as raw 2-byte
  voids.  The caller converts explicitly (``.float()``, or
  ``.view(torch.int16)`` to move the bits).  A ``'<V2'`` record from a
  JAX-package rank decodes here to the numpy void array the namesake's
  own receiver gets.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

from ..core import errors

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2       # arbitrary-precision python int (zigzag varint)
_T_FLOAT = 3     # python float, f64
_T_STR = 4
_T_BYTES = 5
_T_LIST = 6
_T_TUPLE = 7
_T_DICT = 8
_T_NDARRAY = 9
# out-of-band twins: the header carries dtype/shape/nbytes plus an 8-byte
# offset-from-frame-end; the raw payload travels as a trailing segment
_T_NDARRAY_OOB = 10
_T_BYTES_OOB = 11

_OFE = struct.Struct("<Q")  # offset-from-end slot, patched post-pack

# bytes/bytearray below this stay inline even on the frame path: their
# unpack must copy anyway (``bytes`` is immutable), so OOB only saves the
# pack-side copy — worth it for bulk blobs, not for tag strings
_BYTES_OOB_MIN = 4096


# torch dtypes with a numpy twin: the ones a tensor record may carry
_TORCH_TO_NP = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.uint8: np.dtype(np.uint8),
    torch.uint16: np.dtype(np.uint16),
    torch.uint32: np.dtype(np.uint32),
    torch.uint64: np.dtype(np.uint64),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.complex64: np.dtype(np.complex64),
    torch.complex128: np.dtype(np.complex128),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}


def refuse_tensor(t: torch.Tensor) -> None:
    """Raise the typed error for a tensor the wire cannot carry: one
    that is not on the CPU, or whose dtype numpy lacks (bfloat16 and the
    float8 types).  The message names the explicit conversion."""
    if t.device.type != "cpu":
        raise errors.TypeError_(
            f"dss cannot pack a tensor on {t.device}: the host plane moves "
            "host payloads; stage it explicitly with .cpu() before sending"
        )
    if t.dtype not in _TORCH_TO_NP:
        raise errors.TypeError_(
            f"dss cannot pack a {t.dtype} tensor: numpy has no such dtype; "
            "convert explicitly (.float(), or .view(torch.int16) to move "
            "the bits of a bfloat16 tensor)"
        )


def tensor_array(t: torch.Tensor) -> np.ndarray:
    """The numpy view a CPU tensor encodes as (no copy; raises the typed
    error for a tensor :func:`refuse_tensor` refuses)."""
    refuse_tensor(t)
    t = t.detach()
    if t.is_conj():
        t = t.resolve_conj()
    if t.is_neg():
        t = t.resolve_neg()
    return t.numpy()


def _pack_varint(n: int, out: bytearray) -> None:
    if n < 0:
        raise errors.ArgError("varint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _unpack_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _pack_one(obj: Any, out: bytearray) -> None:
    if isinstance(obj, torch.Tensor):
        obj = tensor_array(obj)
    if obj is None:
        out.append(_T_NONE)
    elif isinstance(obj, bool):
        out.append(_T_BOOL)
        out.append(1 if obj else 0)
    elif isinstance(obj, int):
        out.append(_T_INT)
        # zigzag so negatives stay compact
        z = (obj << 1) if obj >= 0 else ((-obj << 1) | 1)
        _pack_varint(z, out)
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack("<d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        _pack_varint(len(raw), out)
        out.extend(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        _pack_varint(len(obj), out)
        out.extend(obj)
    elif isinstance(obj, np.ndarray):
        out.append(_T_NDARRAY)
        dt = obj.dtype.str.encode("ascii")  # e.g. b'<f4'
        _pack_varint(len(dt), out)
        out.extend(dt)
        _pack_varint(obj.ndim, out)
        for d in obj.shape:
            _pack_varint(d, out)
        raw = np.ascontiguousarray(obj).tobytes()
        _pack_varint(len(raw), out)
        out.extend(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        _pack_varint(len(obj), out)
        for item in obj:
            _pack_one(item, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        _pack_varint(len(obj), out)
        for k, v in obj.items():
            _pack_one(k, out)
            _pack_one(v, out)
    elif isinstance(obj, np.generic):
        # numpy scalar: pack as a 0-d array so the dtype survives
        _pack_one(np.asarray(obj), out)
    else:
        raise errors.TypeError_(
            f"dss cannot pack {type(obj).__name__}"
        )


class _UnpackCtx:
    """Per-stream unpack state: ``copy`` forces fresh writable arrays
    (legacy semantics); ``oob`` accumulates trailing out-of-band bytes
    consumed, so the final truncation check still balances."""

    __slots__ = ("copy", "oob")

    def __init__(self, copy: bool):
        self.copy = copy
        self.oob = 0


def _ndarray_from(buf: memoryview, dt: np.dtype, shape: list[int],
                  ctx: _UnpackCtx):
    """Array over a region of the frame buffer: a VIEW when the caller
    allows it (writable recv buffer), else one fresh writable copy — as a
    CPU tensor when torch has the dtype, else as a numpy array."""
    arr = np.frombuffer(buf, dtype=dt).reshape(shape)
    if ctx.copy or not arr.flags.writeable:
        arr = arr.copy()
    if dt not in _NP_TO_TORCH:
        return arr
    return torch.from_numpy(arr)


def _unpack_one(buf: memoryview, pos: int,
                ctx: _UnpackCtx) -> tuple[Any, int]:
    t = buf[pos]
    pos += 1
    if t == _T_NONE:
        return None, pos
    if t == _T_BOOL:
        return bool(buf[pos]), pos + 1
    if t == _T_INT:
        z, pos = _unpack_varint(buf, pos)
        return ((z >> 1) if not z & 1 else -(z >> 1)), pos
    if t == _T_FLOAT:
        (v,) = struct.unpack_from("<d", buf, pos)
        return v, pos + 8
    if t == _T_STR:
        n, pos = _unpack_varint(buf, pos)
        return bytes(buf[pos : pos + n]).decode("utf-8"), pos + n
    if t == _T_BYTES:
        n, pos = _unpack_varint(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if t == _T_NDARRAY:
        n, pos = _unpack_varint(buf, pos)
        dt = np.dtype(bytes(buf[pos : pos + n]).decode("ascii"))
        pos += n
        ndim, pos = _unpack_varint(buf, pos)
        shape = []
        for _ in range(ndim):
            d, pos = _unpack_varint(buf, pos)
            shape.append(d)
        nbytes, pos = _unpack_varint(buf, pos)
        arr = _ndarray_from(buf[pos : pos + nbytes], dt, shape, ctx)
        return arr, pos + nbytes
    if t == _T_NDARRAY_OOB:
        n, pos = _unpack_varint(buf, pos)
        dt = np.dtype(bytes(buf[pos : pos + n]).decode("ascii"))
        pos += n
        ndim, pos = _unpack_varint(buf, pos)
        shape = []
        for _ in range(ndim):
            d, pos = _unpack_varint(buf, pos)
            shape.append(d)
        nbytes, pos = _unpack_varint(buf, pos)
        (ofe,) = _OFE.unpack_from(buf, pos)
        pos += _OFE.size
        start = len(buf) - ofe
        if start < 0 or start + nbytes > len(buf):
            raise errors.TruncateError(
                f"dss: out-of-band segment [{start}:{start + nbytes}] "
                f"outside frame of {len(buf)} bytes"
            )
        ctx.oob += nbytes
        return _ndarray_from(buf[start : start + nbytes], dt, shape,
                             ctx), pos
    if t == _T_BYTES_OOB:
        nbytes, pos = _unpack_varint(buf, pos)
        (ofe,) = _OFE.unpack_from(buf, pos)
        pos += _OFE.size
        start = len(buf) - ofe
        if start < 0 or start + nbytes > len(buf):
            raise errors.TruncateError(
                f"dss: out-of-band segment [{start}:{start + nbytes}] "
                f"outside frame of {len(buf)} bytes"
            )
        ctx.oob += nbytes
        return bytes(buf[start : start + nbytes]), pos
    if t in (_T_LIST, _T_TUPLE):
        n, pos = _unpack_varint(buf, pos)
        items = []
        for _ in range(n):
            item, pos = _unpack_one(buf, pos, ctx)
            items.append(item)
        return (items if t == _T_LIST else tuple(items)), pos
    if t == _T_DICT:
        n, pos = _unpack_varint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _unpack_one(buf, pos, ctx)
            v, pos = _unpack_one(buf, pos, ctx)
            d[k] = v
        return d, pos
    raise errors.TypeError_(f"dss: unknown type tag {t}")


def _oob_view(obj: Any) -> memoryview | None:
    """Flat byte view of a buffer-exporting object, or None when the
    buffer protocol declines (e.g. datetime64 arrays) — callers fall
    back to the inline copy path."""
    try:
        return memoryview(obj).cast("B")
    except (ValueError, TypeError, BufferError):
        return None


def _pack_one_frames(obj: Any, out: bytearray, segs: list[memoryview],
                     slots: list[int], oob_min: int) -> None:
    """Like :func:`_pack_one`, but contiguous ndarray/bytes payloads —
    at any container depth — emit an OOB tag and append a memoryview
    segment instead of copying their raw bytes into the header."""
    if isinstance(obj, torch.Tensor):
        obj = tensor_array(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        # scalar precedence must mirror _pack_one exactly: np.float64 IS
        # a float subclass and must stay a _T_FLOAT, not a 0-d array
        _pack_one(obj, out)
        return
    if isinstance(obj, np.ndarray):
        nbytes = int(obj.nbytes)
        if nbytes > 0 and nbytes >= oob_min and obj.flags.c_contiguous:
            view = _oob_view(obj)
            if view is not None:
                out.append(_T_NDARRAY_OOB)
                dt = obj.dtype.str.encode("ascii")
                _pack_varint(len(dt), out)
                out.extend(dt)
                _pack_varint(obj.ndim, out)
                for d in obj.shape:
                    _pack_varint(d, out)
                _pack_varint(nbytes, out)
                slots.append(len(out))
                out.extend(b"\x00" * _OFE.size)
                segs.append(view)
                return
        _pack_one(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n >= max(oob_min, _BYTES_OOB_MIN):
            out.append(_T_BYTES_OOB)
            _pack_varint(n, out)
            slots.append(len(out))
            out.extend(b"\x00" * _OFE.size)
            segs.append(memoryview(obj))
            return
        _pack_one(obj, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        _pack_varint(len(obj), out)
        for item in obj:
            _pack_one_frames(item, out, segs, slots, oob_min)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        _pack_varint(len(obj), out)
        for k, v in obj.items():
            _pack_one_frames(k, out, segs, slots, oob_min)
            _pack_one_frames(v, out, segs, slots, oob_min)
    elif isinstance(obj, np.generic):
        # numpy scalar: as a 0-d array so the dtype survives (and rides
        # OOB when big enough — np.float64 payloads are the ULFM
        # agreement currency)
        _pack_one_frames(np.asarray(obj), out, segs, slots, oob_min)
    else:
        _pack_one(obj, out)


def pack(*objs: Any) -> bytes:
    """Pack values into one self-describing buffer (opal_dss.pack)."""
    out = bytearray()
    _pack_varint(len(objs), out)
    for obj in objs:
        _pack_one(obj, out)
    return bytes(out)


class _BufferSink:
    """bytearray-shaped adapter over a caller-provided writable buffer:
    the pack machinery appends through it, writing header bytes straight
    into their final destination (a shared-memory ring slot) instead of
    an intermediate bytearray.  Overflow raises ``TruncateError`` — the
    partial write is garbage the caller must discard (an unpublished
    ring slot satisfies this by construction)."""

    __slots__ = ("mv", "pos")

    def __init__(self, buf):
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        if mv.readonly:
            raise errors.ArgError("pack_frames_into needs a writable "
                                  "buffer")
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        self.mv = mv
        self.pos = 0

    def append(self, b: int) -> None:
        if self.pos >= len(self.mv):
            raise errors.TruncateError("dss: pack_frames_into overflow")
        self.mv[self.pos] = b
        self.pos += 1

    def extend(self, data) -> None:
        n = len(data)
        if self.pos + n > len(self.mv):
            raise errors.TruncateError("dss: pack_frames_into overflow")
        self.mv[self.pos : self.pos + n] = bytes(data) \
            if not isinstance(data, (bytes, bytearray, memoryview)) \
            else data
        self.pos += n

    def __len__(self) -> int:
        return self.pos


def pack_frames_into(buf, *objs: Any, oob_min: int = 0
                     ) -> tuple[int, list[memoryview]]:
    """:func:`pack_frames`, but the header stream is packed directly
    into ``buf`` (any writable buffer) — the write-into-buffer variant
    the shared-memory ring's single-slot fast path uses to skip the
    intermediate header bytearray entirely.  Returns
    ``(header_nbytes, segments)``; the on-wire frame is
    ``buf[:header_nbytes]`` followed by the segments in order.  Raises
    ``TruncateError`` when the header alone outgrows ``buf`` (the
    caller discards the partial write and takes the two-step path)."""
    sink = _BufferSink(buf)
    segs: list[memoryview] = []
    slots: list[int] = []
    _pack_varint(len(objs), sink)
    for obj in objs:
        _pack_one_frames(obj, sink, segs, slots, oob_min)
    total = sum(s.nbytes for s in segs)
    prefix = 0
    for slot, seg in zip(slots, segs):
        _OFE.pack_into(sink.mv, slot, total - prefix)
        prefix += seg.nbytes
    return sink.pos, segs


def pack_frames(*objs: Any, oob_min: int = 0
                ) -> tuple[bytes, list[memoryview]]:
    """Pack values into a header stream plus out-of-band raw segments.

    Returns ``(header, segments)`` where the on-wire frame is the
    concatenation ``header + seg0 + seg1 + ...`` — a valid
    :func:`unpack`/:func:`unpack_from` stream.  Contiguous
    ndarray/bytes payloads of at least ``oob_min`` bytes are referenced
    as memoryviews of the CALLER's buffers: nothing is copied here, so
    the caller must keep those buffers unmutated until the segments are
    consumed (a blocking ``sendall``/``sendmsg`` satisfies this by
    construction).  Everything else — and a frame with no qualifying
    payload — degenerates to the legacy inline encoding."""
    out = bytearray()
    segs: list[memoryview] = []
    slots: list[int] = []
    _pack_varint(len(objs), out)
    for obj in objs:
        _pack_one_frames(obj, out, segs, slots, oob_min)
    # patch the offset-from-end slots now every segment size is known:
    # segment i starts (total_tail - prefix_i) bytes before frame end
    total = sum(s.nbytes for s in segs)
    prefix = 0
    for slot, seg in zip(slots, segs):
        _OFE.pack_into(out, slot, total - prefix)
        prefix += seg.nbytes
    return bytes(out), segs


def _unpack(buf: memoryview, copy: bool) -> list[Any]:
    ctx = _UnpackCtx(copy=copy)
    n, pos = _unpack_varint(buf, 0)
    out = []
    for _ in range(n):
        obj, pos = _unpack_one(buf, pos, ctx)
        out.append(obj)
    if pos + ctx.oob != len(buf):
        raise errors.TruncateError(
            f"dss: {len(buf) - pos - ctx.oob} trailing bytes after unpack"
        )
    return out


def unpack(data) -> list[Any]:
    """Unpack every value from a buffer (opal_dss.unpack).  Arrays come
    back as fresh writable copies regardless of the buffer's nature —
    the legacy contract every existing caller holds."""
    return _unpack(memoryview(data), copy=True)


def unpack_from(data) -> list[Any]:
    """Unpack a frame, building arrays as writable VIEWS over ``data``
    when it is a writable buffer (the ``recv_into`` bytearray of the
    zero-copy receive path) — no per-array copy.  The caller must
    dedicate the buffer to this frame: the views keep it alive and
    alias its storage.  Read-only buffers degrade to :func:`unpack`'s
    copy semantics, so delivered arrays are ALWAYS writable."""
    buf = memoryview(data)
    return _unpack(buf, copy=False)
