"""Predefined MPI datatypes (namesake:
``zhpe_ompi_tpu/datatype/predefined.py``).

The port's own copy of the predefined type table
(``ompi/datatype/ompi_datatype_internal.h``): every basic type is bound to
its ``torch.dtype`` in place of the JAX package's numpy/JAX dtype pair.
``BFLOAT16`` is ``torch.bfloat16``.  Pair types (``FLOAT_INT`` etc.) serve
MINLOC/MAXLOC, whose operands on the device are ``(values, indices)``
tensor pairs.

``kind`` is the numpy dtype kind letter of the type (``f`` float, ``c``
complex, ``i`` signed, ``u`` unsigned, ``b`` bool), which the op table's
allowed-kinds checks read, as the JAX package reads ``np_dtype.kind``.
"""

from __future__ import annotations

import torch

_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def _kind(dt: torch.dtype) -> str:
    if dt == torch.bool:
        return "b"
    if dt.is_complex:
        return "c"
    if dt.is_floating_point:
        return "f"
    return "u" if dt in _UNSIGNED else "i"


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


class Datatype:
    """Base class of all datatypes.

    Attributes mirror the reference's ``ompi_datatype_t``: ``size`` (bytes of
    payload), ``extent`` (stride between consecutive elements), ``lb``/``ub``.
    """

    def __init__(self, name: str):
        self.name = name
        self.committed = True

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def extent(self) -> int:
        raise NotImplementedError

    @property
    def lb(self) -> int:
        return 0

    @property
    def ub(self) -> int:
        return self.lb + self.extent

    def typemap(self) -> list[tuple[torch.dtype, int]]:
        """Flattened (basic ``torch.dtype``, byte displacement) list for ONE
        element."""
        raise NotImplementedError

    @property
    def is_contiguous(self) -> bool:
        """True when one element's payload is a single gap-free run and
        extent == size."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"Datatype({self.name}, size={self.size}, extent={self.extent})"


class BasicDatatype(Datatype):
    """A predefined basic type backed by one ``torch.dtype``."""

    def __init__(self, name: str, torch_dtype: torch.dtype):
        super().__init__(name)
        self.torch_dtype = torch_dtype
        self.kind = _kind(torch_dtype)

    @property
    def size(self) -> int:
        return _itemsize(self.torch_dtype)

    @property
    def extent(self) -> int:
        return self.size

    def typemap(self):
        return [(self.torch_dtype, 0)]

    @property
    def is_contiguous(self) -> bool:
        return True


class PairDatatype(Datatype):
    """(value, index) pair type for MINLOC/MAXLOC (cf. ompi MPI_FLOAT_INT).
    The fields are packed, as in the JAX package's numpy structured dtype,
    so ``extent`` equals ``size``."""

    def __init__(self, name: str, value_dtype: torch.dtype,
                 index_dtype: torch.dtype):
        super().__init__(name)
        self.value_dtype = value_dtype
        self.index_dtype = index_dtype

    @property
    def size(self) -> int:
        return _itemsize(self.value_dtype) + _itemsize(self.index_dtype)

    @property
    def extent(self) -> int:
        return self.size

    def typemap(self):
        return [(self.value_dtype, 0),
                (self.index_dtype, _itemsize(self.value_dtype))]

    @property
    def is_contiguous(self) -> bool:
        return self.size == self.extent


# ---------------------------------------------------------------------------
# The predefined table (MPI name → datatype object)
# ---------------------------------------------------------------------------

BYTE = BasicDatatype("MPI_BYTE", torch.uint8)
CHAR = BasicDatatype("MPI_CHAR", torch.int8)
SIGNED_CHAR = BasicDatatype("MPI_SIGNED_CHAR", torch.int8)
UNSIGNED_CHAR = BasicDatatype("MPI_UNSIGNED_CHAR", torch.uint8)
SHORT = BasicDatatype("MPI_SHORT", torch.int16)
UNSIGNED_SHORT = BasicDatatype("MPI_UNSIGNED_SHORT", torch.uint16)
INT = BasicDatatype("MPI_INT", torch.int32)
UNSIGNED = BasicDatatype("MPI_UNSIGNED", torch.uint32)
LONG = BasicDatatype("MPI_LONG", torch.int64)
UNSIGNED_LONG = BasicDatatype("MPI_UNSIGNED_LONG", torch.uint64)
LONG_LONG = BasicDatatype("MPI_LONG_LONG", torch.int64)
INT8_T = BasicDatatype("MPI_INT8_T", torch.int8)
INT16_T = BasicDatatype("MPI_INT16_T", torch.int16)
INT32_T = BasicDatatype("MPI_INT32_T", torch.int32)
INT64_T = BasicDatatype("MPI_INT64_T", torch.int64)
UINT8_T = BasicDatatype("MPI_UINT8_T", torch.uint8)
UINT16_T = BasicDatatype("MPI_UINT16_T", torch.uint16)
UINT32_T = BasicDatatype("MPI_UINT32_T", torch.uint32)
UINT64_T = BasicDatatype("MPI_UINT64_T", torch.uint64)
FLOAT = BasicDatatype("MPI_FLOAT", torch.float32)
DOUBLE = BasicDatatype("MPI_DOUBLE", torch.float64)
FLOAT16 = BasicDatatype("MPI_FLOAT16", torch.float16)
BFLOAT16 = BasicDatatype("MPI_BFLOAT16", torch.bfloat16)
C_BOOL = BasicDatatype("MPI_C_BOOL", torch.bool)
C_FLOAT_COMPLEX = BasicDatatype("MPI_C_FLOAT_COMPLEX", torch.complex64)
C_DOUBLE_COMPLEX = BasicDatatype("MPI_C_DOUBLE_COMPLEX", torch.complex128)
AINT = BasicDatatype("MPI_AINT", torch.int64)
OFFSET = BasicDatatype("MPI_OFFSET", torch.int64)
COUNT = BasicDatatype("MPI_COUNT", torch.int64)
WCHAR = BasicDatatype("MPI_WCHAR", torch.uint32)

# MINLOC/MAXLOC pair types
FLOAT_INT = PairDatatype("MPI_FLOAT_INT", torch.float32, torch.int32)
DOUBLE_INT = PairDatatype("MPI_DOUBLE_INT", torch.float64, torch.int32)
LONG_INT = PairDatatype("MPI_LONG_INT", torch.int64, torch.int32)
TWOINT = PairDatatype("MPI_2INT", torch.int32, torch.int32)
SHORT_INT = PairDatatype("MPI_SHORT_INT", torch.int16, torch.int32)

_ALL = {
    d.name: d
    for d in list(globals().values())
    if isinstance(d, Datatype)
}

# dtype -> canonical predefined type (the fixed-width names win)
_BY_DTYPE = {
    torch.uint8: UINT8_T, torch.int8: INT8_T, torch.int16: INT16_T,
    torch.uint16: UINT16_T, torch.int32: INT32_T, torch.uint32: UINT32_T,
    torch.int64: INT64_T, torch.uint64: UINT64_T, torch.float16: FLOAT16,
    torch.bfloat16: BFLOAT16, torch.float32: FLOAT, torch.float64: DOUBLE,
    torch.bool: C_BOOL, torch.complex64: C_FLOAT_COMPLEX,
    torch.complex128: C_DOUBLE_COMPLEX,
}


def lookup(name: str) -> Datatype:
    return _ALL[name]


def from_torch_dtype(dt: torch.dtype) -> BasicDatatype:
    """Map a ``torch.dtype`` to the canonical predefined basic type."""
    if dt not in _BY_DTYPE:
        raise KeyError(f"no predefined datatype for torch dtype {dt}")
    return _BY_DTYPE[dt]


def from_np_dtype(dt) -> BasicDatatype:
    """Map a numpy dtype (or a dtype name such as ``"bfloat16"``, which
    numpy knows only through ml_dtypes) to the canonical predefined basic
    type."""
    import numpy as np

    if str(dt) == "bfloat16" or getattr(dt, "__name__", None) == "bfloat16":
        return BFLOAT16
    try:
        t = torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype
    except TypeError:
        raise KeyError(f"no predefined datatype for numpy dtype {dt}") from None
    return from_torch_dtype(t)
