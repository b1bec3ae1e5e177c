"""external32 — MPI's canonical big-endian wire encoding (namesake:
``zhpe_ompi_tpu/datatype/external32.py``).

Re-design of the convertor's heterogeneous path (reference:
``opal/datatype/opal_convertor.c`` arch-conversion flags, exercised by
``test/datatype/external32.c``): MPI_Pack_external / MPI_Unpack_external
serialize any datatype into the standard big-endian "external32"
representation so heterogeneous peers (and persisted files) interoperate
regardless of host endianness.  Elements are emitted in typemap order, each
byteswapped to big endian (a complex number component by component); the
fixed-width types already match external32's sizes, so size ==
packed_size.  bfloat16 swaps as the 16-bit unit it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import errors
from .convertor import _as_byte_view, _check_lb, packed_size, span_bytes
from .predefined import Datatype


def _np_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype whose byte swap is ``dt``'s (uint16 for bfloat16,
    which numpy has no type for)."""
    if dt == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dt).numpy().dtype


def _element_layout(datatype: Datatype, count: int):
    """(np_dtype, source_byte_offset) per element, canonical order —
    absolute displacements, matching the convertor's convention (elements
    of instance c live at c*extent + disp in the 0-based buffer)."""
    ext = datatype.extent
    _check_lb(datatype)
    tm = [(_np_dtype(dt), disp) for dt, disp in datatype.typemap()]
    return [(dt, c * ext + disp) for c in range(count) for dt, disp in tm]


def pack_external(buffer, datatype: Datatype, count: int = 1) -> np.ndarray:
    """MPI_Pack_external("external32", ...): canonical big-endian bytes."""
    src = _as_byte_view(buffer)
    need = span_bytes(datatype, count)
    if src.size < need:
        raise errors.TruncateError(
            f"buffer holds {src.size} bytes, need {need}"
        )
    parts = []
    for dt, off in _element_layout(datatype, count):
        raw = src[off : off + dt.itemsize].tobytes()
        be = np.frombuffer(raw, dtype=dt).astype(dt.newbyteorder(">"))
        parts.append(np.frombuffer(be.tobytes(), dtype=np.uint8))
    if not parts:
        return np.zeros(0, np.uint8)
    return np.concatenate(parts)


def unpack_external(packed, datatype: Datatype, count: int = 1,
                    out=None) -> np.ndarray:
    """MPI_Unpack_external: canonical bytes back into a native buffer
    (``out``, a numpy array or CPU tensor, written in place; else a new
    uint8 array, which is returned)."""
    packed = np.asarray(packed, dtype=np.uint8).reshape(-1)
    expect = packed_size(datatype, count)
    if packed.size < expect:
        raise errors.TruncateError(
            f"packed stream holds {packed.size} bytes, need {expect}"
        )
    need = span_bytes(datatype, count)
    if out is None:
        out = np.zeros(need, np.uint8)
        dst = out
    else:
        dst = _as_byte_view(out)
        if dst.size < need:
            raise errors.TruncateError("output buffer too small")
    pos = 0
    for dt, off in _element_layout(datatype, count):
        raw = packed[pos : pos + dt.itemsize].tobytes()
        native = np.frombuffer(
            raw, dtype=dt.newbyteorder(">")
        ).astype(dt)
        dst[off : off + dt.itemsize] = np.frombuffer(
            native.tobytes(), dtype=np.uint8
        )
        pos += dt.itemsize
    return out
