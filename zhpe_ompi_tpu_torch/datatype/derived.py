"""Derived datatype constructors (namesake:
``zhpe_ompi_tpu/datatype/derived.py``; the port's own copy over its
``predefined`` types, whose typemap entries are torch dtypes).

Re-design of the reference's datatype construction
(``ompi/datatype/ompi_datatype_create_*.c`` over ``opal/datatype``): a derived
type is a typemap — a list of (basic ``torch.dtype``, byte displacement)
pairs — plus an extent.  The reference stores an optimized description alongside the raw one
(``opal/datatype/opal_datatype_optimize.c``); here :meth:`DerivedDatatype.segments`
plays that role, merging adjacent entries into maximal contiguous byte runs so
pack/unpack does few large copies instead of per-primitive copies.

Supported constructors (MPI names): contiguous, vector, hvector, indexed,
hindexed, indexed_block, hindexed_block, struct, subarray, darray, resized,
dup.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import errors
from .predefined import Datatype


def merge_typemap_segments(
    typemap: list[tuple[torch.dtype, int]],
) -> list[tuple[int, int]]:
    """Merge a displacement-sorted typemap into maximal contiguous
    (displacement, nbytes) byte runs — the optimized-description pass
    (cf. opal_datatype_optimize.c)."""
    segs: list[tuple[int, int]] = []
    for dt, disp in sorted(typemap, key=lambda e: e[1]):
        nbytes = dt.itemsize
        if segs and segs[-1][0] + segs[-1][1] == disp:
            segs[-1] = (segs[-1][0], segs[-1][1] + nbytes)
        else:
            segs.append((disp, nbytes))
    return segs


def _extent_of(typemap: list[tuple[torch.dtype, int]]) -> tuple[int, int]:
    """(lb, extent) of a typemap per MPI semantics: lb = min displacement,
    ub = max displacement+size, extent = ub - lb."""
    if not typemap:
        return 0, 0
    lb = min(d for _, d in typemap)
    ub = max(d + t.itemsize for t, d in typemap)
    return lb, ub - lb


class DerivedDatatype(Datatype):
    def __init__(
        self,
        name: str,
        typemap: list[tuple[torch.dtype, int]],
        extent: int,
        lb: int = 0,
    ):
        super().__init__(name)
        self.committed = False
        self._typemap = sorted(typemap, key=lambda e: e[1])
        self._lb = lb
        self._extent = extent
        self._size = sum(d.itemsize for d, _ in self._typemap)
        self._segments: list[tuple[int, int]] | None = None

    def commit(self) -> "DerivedDatatype":
        """MPI_Type_commit: precompute the optimized description."""
        self.segments()
        self.committed = True
        return self

    @property
    def size(self) -> int:
        return self._size

    @property
    def extent(self) -> int:
        return self._extent

    @property
    def lb(self) -> int:
        return self._lb

    def typemap(self):
        return list(self._typemap)

    def segments(self) -> list[tuple[int, int]]:
        """Optimized description: maximal contiguous (displacement, nbytes)
        runs of one element's typemap, in displacement order."""
        if self._segments is None:
            self._segments = merge_typemap_segments(self._typemap)
        return self._segments

    @property
    def is_contiguous(self) -> bool:
        segs = self.segments()
        return (
            len(segs) == 1
            and segs[0][0] == self._lb
            and segs[0][1] == self._size
            and self._size == self._extent
        )

    @property
    def homogeneous_dtype(self) -> torch.dtype | None:
        """The single basic dtype if every typemap entry shares it and all
        displacements are element-aligned (enables the on-device gather path)."""
        if not self._typemap:
            return None
        dt0 = self._typemap[0][0]
        item = dt0.itemsize
        for dt, disp in self._typemap:
            if dt != dt0 or disp % item != 0:
                return None
        if self._extent % item != 0:
            return None
        return dt0

    def element_indices(self) -> np.ndarray:
        """For homogeneous types: element-granularity displacements of one
        element of this datatype (used to build device gather indices)."""
        dt = self.homogeneous_dtype
        if dt is None:
            raise errors.TypeError_(
                f"datatype {self.name} is not homogeneous; no element view"
            )
        return np.asarray([disp // dt.itemsize for _, disp in self._typemap])


def _expand(datatype: Datatype, disp: int) -> list[tuple[torch.dtype, int]]:
    return [(dt, d + disp) for dt, d in datatype.typemap()]


def create_contiguous(count: int, oldtype: Datatype) -> DerivedDatatype:
    """MPI_Type_contiguous (cf. ompi_datatype_create_contiguous.c)."""
    if count < 0:
        raise errors.CountError(f"negative count {count}")
    tm = []
    for i in range(count):
        tm += _expand(oldtype, i * oldtype.extent)
    return DerivedDatatype(
        f"contig({count},{oldtype.name})", tm, count * oldtype.extent
    )


def create_vector(
    count: int, blocklength: int, stride: int, oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_vector: stride counted in oldtype extents
    (cf. ompi_datatype_create_vector.c)."""
    return create_hvector(count, blocklength, stride * oldtype.extent, oldtype)


def create_hvector(
    count: int, blocklength: int, stride_bytes: int, oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_create_hvector: stride counted in bytes."""
    if count < 0 or blocklength < 0:
        raise errors.CountError("negative count/blocklength")
    tm = []
    for i in range(count):
        base = i * stride_bytes
        for j in range(blocklength):
            tm += _expand(oldtype, base + j * oldtype.extent)
    lb, extent = _extent_of(tm)
    return DerivedDatatype(
        f"hvector({count},{blocklength},{stride_bytes},{oldtype.name})",
        tm,
        extent,
        lb,
    )


def create_indexed(
    blocklengths: list[int], displacements: list[int], oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_indexed: displacements in oldtype extents."""
    return create_hindexed(
        blocklengths, [d * oldtype.extent for d in displacements], oldtype
    )


def create_hindexed(
    blocklengths: list[int], byte_displacements: list[int], oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_create_hindexed: displacements in bytes."""
    if len(blocklengths) != len(byte_displacements):
        raise errors.ArgError("blocklengths and displacements length mismatch")
    tm = []
    for bl, disp in zip(blocklengths, byte_displacements):
        for j in range(bl):
            tm += _expand(oldtype, disp + j * oldtype.extent)
    lb, extent = _extent_of(tm)
    return DerivedDatatype(
        f"hindexed({len(blocklengths)},{oldtype.name})", tm, extent, lb
    )


def create_indexed_block(
    blocklength: int, displacements: list[int], oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_create_indexed_block."""
    return create_indexed([blocklength] * len(displacements), displacements, oldtype)


def create_hindexed_block(
    blocklength: int, byte_displacements: list[int], oldtype: Datatype
) -> DerivedDatatype:
    """MPI_Type_create_hindexed_block: equal-length blocks at byte
    displacements."""
    return create_hindexed(
        [blocklength] * len(byte_displacements), byte_displacements, oldtype
    )


def create_struct(
    blocklengths: list[int],
    byte_displacements: list[int],
    types: list[Datatype],
) -> DerivedDatatype:
    """MPI_Type_create_struct (cf. ompi_datatype_create_struct.c)."""
    if not (len(blocklengths) == len(byte_displacements) == len(types)):
        raise errors.ArgError("struct argument length mismatch")
    tm = []
    for bl, disp, t in zip(blocklengths, byte_displacements, types):
        for j in range(bl):
            tm += _expand(t, disp + j * t.extent)
    lb, extent = _extent_of(tm)
    return DerivedDatatype(f"struct({len(types)})", tm, extent, lb)


def create_subarray(
    sizes: list[int],
    subsizes: list[int],
    starts: list[int],
    oldtype: Datatype,
    order: str = "C",
) -> DerivedDatatype:
    """MPI_Type_create_subarray (cf. ompi_datatype_create_subarray.c).

    The extent covers the FULL array, as the standard requires, so counting
    over the type walks whole-array strides.
    """
    ndims = len(sizes)
    if not (len(subsizes) == len(starts) == ndims):
        raise errors.ArgError("subarray argument length mismatch")
    for d in range(ndims):
        if starts[d] + subsizes[d] > sizes[d]:
            raise errors.ArgError("subarray exceeds array bounds")
    if order not in ("C", "F"):
        raise errors.ArgError(f"bad order {order!r}")
    # byte strides per dim over the full array
    strides = [0] * ndims
    acc = oldtype.extent
    dims = range(ndims - 1, -1, -1) if order == "C" else range(ndims)
    for d in dims:
        strides[d] = acc
        acc *= sizes[d]
    total_bytes = acc
    tm: list[tuple[torch.dtype, int]] = []

    def rec(dim: int, base: int):
        if dim == ndims:
            tm.extend(_expand(oldtype, base))
            return
        for i in range(subsizes[dim]):
            rec(dim + 1, base + (starts[dim] + i) * strides[dim])

    rec(0, 0)
    return DerivedDatatype(f"subarray({sizes},{subsizes},{starts})", tm, total_bytes)


# MPI_Type_create_darray distribution constants
DISTRIBUTE_BLOCK = 1
DISTRIBUTE_CYCLIC = 2
DISTRIBUTE_NONE = 3
DISTRIBUTE_DFLT_DARG = -1


def create_darray(
    size: int,
    rank: int,
    gsizes: list[int],
    distribs: list[int],
    dargs: list[int],
    psizes: list[int],
    oldtype: Datatype,
    order: str = "C",
) -> DerivedDatatype:
    """MPI_Type_create_darray (cf. ompi_datatype_create_darray.c): the
    HPF-style decomposition of an ndims-dimensional global array over a
    process grid — the datatype parallel IO uses to give each rank its
    block/cyclic slice of a file.  Supports BLOCK, CYCLIC(k), and NONE
    per dimension; the extent covers the FULL global array, so counting
    over the type tiles whole-array strides (the subarray convention)."""
    ndims = len(gsizes)
    if not (len(distribs) == len(dargs) == len(psizes) == ndims):
        raise errors.ArgError("darray argument length mismatch")
    if int(np.prod(psizes)) != size:
        raise errors.ArgError(
            f"process grid {psizes} does not cover comm size {size}"
        )
    if order not in ("C", "F"):
        raise errors.ArgError(f"bad order {order!r}")
    # this rank's coordinates in the process grid: ROW-MAJOR regardless
    # of `order` (the MPI rule — ompi_datatype_create_darray.c:201
    # "calculate position in grid using row-major ordering"; `order`
    # affects only the storage strides below)
    coords = [0] * ndims
    r = rank
    for d in range(ndims - 1, -1, -1):
        coords[d] = r % psizes[d]
        r //= psizes[d]
    # per-dimension owned global indices
    owned: list[np.ndarray] = []
    for d in range(ndims):
        g, p, c = gsizes[d], psizes[d], coords[d]
        dist, darg = distribs[d], dargs[d]
        if dist == DISTRIBUTE_NONE:
            if p != 1:
                # MPI mandates psize 1 for NONE dims: p > 1 would hand
                # every grid coordinate the full range and silently
                # cover the array p times over
                raise errors.ArgError(
                    f"darray DISTRIBUTE_NONE requires psizes[{d}] == 1, "
                    f"got {p}"
                )
            idx = np.arange(g, dtype=np.int64)
        elif dist == DISTRIBUTE_BLOCK:
            blk = darg if darg != DISTRIBUTE_DFLT_DARG else -(-g // p)
            if blk * p < g:
                raise errors.ArgError(
                    f"darray BLOCK darg {blk} too small for dim {d}"
                )
            start = c * blk
            idx = np.arange(start, min(start + blk, g), dtype=np.int64)
        elif dist == DISTRIBUTE_CYCLIC:
            blk = darg if darg != DISTRIBUTE_DFLT_DARG else 1
            base = np.arange(g, dtype=np.int64)
            idx = base[(base // blk) % p == c]
        else:
            raise errors.ArgError(f"unknown distribution {dist}")
        owned.append(idx)
    # byte strides per dim over the full global array
    strides = [0] * ndims
    acc = oldtype.extent
    sdims = range(ndims - 1, -1, -1) if order == "C" else range(ndims)
    for d in sdims:
        strides[d] = acc
        acc *= gsizes[d]
    total_bytes = acc
    tm: list[tuple[torch.dtype, int]] = []

    def rec(dim: int, base: int):
        if dim == ndims:
            tm.extend(_expand(oldtype, base))
            return
        for i in owned[dim]:
            rec(dim + 1, base + int(i) * strides[dim])

    rec(0, 0)
    return DerivedDatatype(
        f"darray(r{rank}/{size},{gsizes},{psizes})", tm, total_bytes
    )


def create_resized(oldtype: Datatype, lb: int, extent: int) -> DerivedDatatype:
    """MPI_Type_create_resized.  MPI permits non-positive extents, but the
    pack/unpack engine addresses elements at `i * extent` from a 0-based
    buffer, so they are rejected here rather than corrupting memory later."""
    if extent < 0 or (extent == 0 and oldtype.size > 0):
        raise errors.ArgError(
            f"create_resized: extent must be positive, got {extent}"
        )
    return DerivedDatatype(f"resized({oldtype.name})", oldtype.typemap(), extent, lb)


def dup(oldtype: Datatype) -> DerivedDatatype:
    """MPI_Type_dup."""
    d = DerivedDatatype(
        f"dup({oldtype.name})", oldtype.typemap(), oldtype.extent, oldtype.lb
    )
    d.committed = oldtype.committed
    return d
