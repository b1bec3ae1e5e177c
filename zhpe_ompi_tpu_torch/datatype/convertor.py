"""Convertor: pack/unpack engine for (possibly non-contiguous) datatypes
(namesake: ``zhpe_ompi_tpu/datatype/convertor.py``).

Re-design of ``opal/datatype/opal_convertor.c:218-276``: the reference's
resumable iovec-producing state machine becomes

- **host path** — the native segment walk (``native/zompi_native.cpp``'s
  ``zompi_pack``/``unpack``/``pack_partial``/``unpack_partial``: one
  ``memcpy`` per contiguous run of the optimized segment description),
  where the namesake takes it.  When a switch (``ZOMPI_NATIVE=0``, the MCA
  var ``native_kernels``) turns the native kernels off, or the destination
  is read-only, it is a vectorized numpy byte gather/scatter instead: the
  whole byte index map is made once per (datatype, count) and cached, in
  the role of the reference's prepared convertor.  Buffers are numpy
  arrays, bytes, or CPU tensors (viewed as bytes, not copied or converted:
  a bfloat16 tensor, which has no numpy dtype, packs its bytes); packed
  streams are numpy ``uint8`` arrays, as in the namesake.
- **device path** — for homogeneous datatypes, pack and unpack are
  ``index_select`` and ``index_copy_`` with an element index tensor on the
  tensor's own device, so the data never leaves it (the inverse of the
  reference's CUDA path, which bounces device buffers through host memcpy,
  ``opal/datatype/opal_datatype_cuda.c``).
- **partial pack/unpack with a byte position** — MPI_Pack/Unpack semantics
  and the reference's convertor-position tests (``test/datatype/position.c``):
  byte-granular slices of the index map.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..core import errors
from .derived import DerivedDatatype, merge_typemap_segments
from .predefined import Datatype

_seg_cache: dict[tuple, np.ndarray] = {}


def _segs_array(datatype: Datatype) -> np.ndarray:
    """(nsegs, 2) int64 array of one element's optimized description, for
    the native pack/unpack kernels."""
    segs = _one_element_segments(datatype)
    key = (tuple(segs),)
    arr = _seg_cache.get(key)
    if arr is None:
        arr = np.asarray(segs, dtype=np.int64).reshape(-1, 2)
        if len(_seg_cache) > 256:
            _seg_cache.clear()
        _seg_cache[key] = arr
    return arr


def _vp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _one_element_segments(datatype: Datatype) -> list[tuple[int, int]]:
    if isinstance(datatype, DerivedDatatype):
        return datatype.segments()
    return merge_typemap_segments(datatype.typemap())


def packed_size(datatype: Datatype, count: int) -> int:
    """MPI_Pack_size."""
    return datatype.size * count


def span_bytes(datatype: Datatype, count: int) -> int:
    """Bytes of source buffer spanned by `count` elements (true extent)."""
    if count == 0:
        return 0
    segs = _one_element_segments(datatype)
    last = max((d + n) for d, n in segs) if segs else 0
    return (count - 1) * datatype.extent + last


_index_cache: dict[tuple, np.ndarray] = {}


def byte_index_map(datatype: Datatype, count: int) -> np.ndarray:
    """Byte offsets (into the source buffer) of every payload byte of `count`
    elements, in pack order.  The cached analog of a prepared convertor,
    keyed by the type's structure (segments + extent), not its identity."""
    segs = _one_element_segments(datatype)
    if segs and segs[0][0] < 0:
        raise errors.ArgError(
            f"datatype {datatype.name} has negative displacements "
            f"(lb={segs[0][0]}); pass a buffer starting at its true lower bound"
        )
    key = (tuple(segs), datatype.extent, count)
    cached = _index_cache.get(key)
    if cached is not None:
        return cached
    if not segs:
        idx = np.empty(0, dtype=np.int64)
    else:
        one = np.concatenate(
            [np.arange(d, d + n, dtype=np.int64) for d, n in segs]
        )
        starts = np.arange(count, dtype=np.int64) * datatype.extent
        idx = (starts[:, None] + one[None, :]).ravel()
    if len(_index_cache) > 256:
        _index_cache.clear()
    _index_cache[key] = idx
    return idx


def _as_byte_view(buffer) -> np.ndarray:
    if isinstance(buffer, torch.Tensor):
        if buffer.device.type != "cpu":
            raise errors.ArgError(
                f"the host convertor packs host memory; a tensor on "
                f"{buffer.device} goes through device_pack/device_unpack")
        if not buffer.is_contiguous():
            raise errors.ArgError(
                "convertor buffers must be contiguous; the datatype itself "
                "describes the strided layout")
        return buffer.reshape(-1).view(torch.uint8).numpy()
    if isinstance(buffer, np.ndarray):
        if not buffer.flags["C_CONTIGUOUS"]:
            raise errors.ArgError(
                "convertor buffers must be C-contiguous; the datatype itself "
                "describes the strided layout"
            )
        return buffer.reshape(-1).view(np.uint8)
    return np.frombuffer(buffer, dtype=np.uint8)


def _check_lb(datatype: Datatype) -> int:
    """Reject negative lower bounds (buffers are 0-based) and non-positive
    extents (elements live at i * extent); return lb."""
    if datatype.extent < 0 or (datatype.extent == 0 and datatype.size > 0):
        raise errors.ArgError(
            f"datatype {datatype.name} has non-positive extent "
            f"({datatype.extent}); the pack engine requires extent > 0"
        )
    segs = _one_element_segments(datatype)
    lb = segs[0][0] if segs else 0
    if lb < 0:
        raise errors.ArgError(
            f"datatype {datatype.name} has negative displacements "
            f"(lb={lb}); pass a buffer starting at its true lower bound"
        )
    return lb


def pack(buffer, datatype: Datatype, count: int) -> np.ndarray:
    """Pack `count` elements of `datatype` from `buffer` into a contiguous
    uint8 array (cf. opal_convertor_pack)."""
    view = _as_byte_view(buffer)
    lb = _check_lb(datatype)
    need = span_bytes(datatype, count)
    if view.nbytes < need:
        raise errors.TruncateError(
            f"buffer of {view.nbytes}B too small for {count} x {datatype.name} "
            f"({need}B)"
        )
    if datatype.is_contiguous:
        return view[lb:need].copy()
    lib = native.load()
    if lib is not None:
        segs = _segs_array(datatype)
        out = np.empty(packed_size(datatype, count), dtype=np.uint8)
        lib.zompi_pack(_vp(view), _vp(out), _i64p(segs), segs.shape[0],
                       datatype.extent, count)
        return out
    return view[byte_index_map(datatype, count)]


def unpack(packed, datatype: Datatype, count: int, out=None) -> np.ndarray:
    """Unpack a contiguous byte stream into the (strided) layout of `count`
    elements of `datatype` (cf. opal_convertor_unpack).  Returns the
    destination uint8 buffer (a byte view of ``out`` when given)."""
    src = _as_byte_view(packed)
    lb = _check_lb(datatype)
    need = packed_size(datatype, count)
    if src.nbytes < need:
        raise errors.TruncateError(
            f"packed stream of {src.nbytes}B too small ({need}B needed)"
        )
    span = span_bytes(datatype, count)
    if out is None:
        dest = np.zeros(span, dtype=np.uint8)
    else:
        dest = _as_byte_view(out)
        if dest.nbytes < span:
            raise errors.TruncateError("destination buffer too small")
    if datatype.is_contiguous:
        dest[lb : lb + need] = src[:need]
        return dest
    lib = native.load()
    if lib is not None and dest.flags["WRITEABLE"]:
        segs = _segs_array(datatype)
        lib.zompi_unpack(_vp(src), _vp(dest), _i64p(segs), segs.shape[0],
                         datatype.extent, count)
    else:
        dest[byte_index_map(datatype, count)] = src[:need]
    return dest


def pack_partial(
    buffer, datatype: Datatype, count: int, position: int, max_bytes: int
) -> tuple[np.ndarray, int]:
    """Resumable pack: emit up to `max_bytes` packed bytes starting at packed
    byte `position`; returns (chunk, new_position).  Byte-granular, so
    segment boundaries may be split exactly as the reference's convertor
    allows."""
    view = _as_byte_view(buffer)
    total = packed_size(datatype, count)
    if position < 0 or position > total:
        raise errors.ArgError(f"position {position} beyond packed size")
    need = span_bytes(datatype, count)
    if view.nbytes < need:
        raise errors.TruncateError(
            f"buffer of {view.nbytes}B too small for {count} x {datatype.name} "
            f"({need}B)"
        )
    end = min(position + max_bytes, total)
    lib = native.load()
    if lib is not None:
        _check_lb(datatype)
        segs = _segs_array(datatype)
        out = np.empty(end - position, dtype=np.uint8)
        newpos = lib.zompi_pack_partial(
            _vp(view), _vp(out), _i64p(segs), segs.shape[0],
            datatype.extent, count, position, end - position)
        return out[: newpos - position], newpos
    idx = byte_index_map(datatype, count)
    return view[idx[position:end]], end


def unpack_partial(
    chunk, buffer, datatype: Datatype, count: int, position: int
) -> int:
    """Resumable unpack of a chunk that starts at packed byte `position` into
    `buffer`; returns the new position.  Chunks may arrive out of order
    (cf. test/datatype/unpack_ooo.c): each lands at its own offsets."""
    src = _as_byte_view(chunk)
    dest = _as_byte_view(buffer)
    if position < 0:
        raise errors.ArgError(f"negative position {position}")
    end = position + src.nbytes
    if end > packed_size(datatype, count):
        raise errors.TruncateError("chunk overruns packed size")
    span = span_bytes(datatype, count)
    if dest.nbytes < span:
        raise errors.TruncateError(
            f"destination buffer of {dest.nbytes}B smaller than datatype "
            f"span ({span}B)"
        )
    lib = native.load()
    if lib is not None and dest.flags["WRITEABLE"]:
        _check_lb(datatype)
        segs = _segs_array(datatype)
        return lib.zompi_unpack_partial(
            _vp(src), src.nbytes, _vp(dest), _i64p(segs), segs.shape[0],
            datatype.extent, count, position)
    idx = byte_index_map(datatype, count)
    dest[idx[position:end]] = src
    return end


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------


def device_element_indices(datatype: Datatype, count: int) -> np.ndarray:
    """Element-granularity gather indices for `count` elements of a
    homogeneous datatype (the device path's precondition)."""
    if isinstance(datatype, DerivedDatatype):
        base = datatype.element_indices()
        dt = datatype.homogeneous_dtype
        stride = datatype.extent // dt.itemsize
    else:
        tm = datatype.typemap()
        if len({t for t, _ in tm}) != 1:
            raise errors.TypeError_(f"{datatype.name} is not homogeneous")
        dt = tm[0][0]
        base = np.asarray([d // dt.itemsize for _, d in tm])
        stride = datatype.extent // dt.itemsize
    starts = np.arange(count, dtype=np.int64) * stride
    return (starts[:, None] + base[None, :]).ravel()


_device_index_cache: dict[tuple, torch.Tensor] = {}


def _device_indices(datatype: Datatype, count: int, device) -> torch.Tensor:
    """:func:`device_element_indices` as an int64 tensor on ``device``,
    cached by the type's structure, the count and the device."""
    key = (tuple(_one_element_segments(datatype)), datatype.extent, count,
           str(device))
    idx = _device_index_cache.get(key)
    if idx is None:
        idx = torch.from_numpy(device_element_indices(datatype, count)).to(device)
        if len(_device_index_cache) > 64:
            _device_index_cache.clear()
        _device_index_cache[key] = idx
    return idx


def _element_width(datatype: Datatype, flat) -> int:
    item = flat.element_size()
    tm = datatype.typemap()
    if tm and tm[0][0].itemsize != item:
        raise errors.TypeError_(
            f"a {flat.dtype} tensor cannot hold {datatype.name}'s "
            f"{tm[0][0]} elements")
    return item


def device_pack(x, datatype: Datatype, count: int):
    """Pack on the tensor's device: a gather (``index_select``) of the
    flattened ``x``, whose elements are the datatype's homogeneous dtype.
    Returns a new 1-D tensor."""
    flat = x.reshape(-1)
    item = _element_width(datatype, flat)
    if datatype.is_contiguous and datatype.lb % item == 0:
        o = datatype.lb // item
        n = datatype.size * count // item
        return flat[o : o + n].clone()
    return flat.index_select(0, _device_indices(datatype, count, flat.device))


def device_unpack(packed, datatype: Datatype, count: int, out):
    """Unpack on the device: a scatter (``index_copy_``) of ``packed`` into
    the contiguous tensor ``out``, in place (the namesake returns an
    updated copy); returns ``out``."""
    if not out.is_contiguous():
        raise errors.ArgError("device_unpack writes into a contiguous tensor")
    flat_out = out.view(-1)
    item = _element_width(datatype, flat_out)
    if datatype.is_contiguous and datatype.lb % item == 0:
        o = datatype.lb // item
        n = packed.shape[0]
        flat_out[o : o + n] = packed[:n]
        return out
    idx = _device_indices(datatype, count, flat_out.device)
    flat_out.index_copy_(0, idx, packed[: idx.shape[0]])
    return out
