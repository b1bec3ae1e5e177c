"""Symmetric heap allocator (reference: ``oshmem/mca/memheap``; namesake:
``zhpe_ompi_tpu/shmem/memheap.py``, of which this is the port's own copy).

The reference offers buddy and ptmalloc components carving a pre-created
shared segment (``sshmem/{mmap,sysv}``).  What makes a heap *symmetric* is
not the allocator policy but determinism: every PE performs the same
allocation sequence, so identical offsets come out — remote addresses are
computed, never exchanged.  This first-fit free-list allocator is fully
deterministic, coalesces on free, and aligns to 64 bytes (the reference
aligns to cache lines; device memory likes wider alignment too).

The 64-byte floor is also what the direct-map one-sided plane leans on
(``osc/direct.py`` region-backed heaps): every element of every
allocation is NATURALLY aligned for its dtype, so typed AMOs against
the mapped region can never straddle an atomicity boundary.  The
``align`` parameter is the ``shmem_align`` contract — callers may raise
(never lower) the alignment, e.g. to page-align a buffer they intend to
hand to the device plane; determinism is preserved because the request
sequence, including alignments, is identical on every PE.
"""

from __future__ import annotations

from ..core import errors

ALIGN = 64


class SymmetricHeapAllocator:
    """First-fit free-list over a fixed-size arena of bytes."""

    def __init__(self, size: int):
        if size <= 0:
            raise errors.ArgError("heap size must be positive")
        self.size = size
        # sorted list of (offset, length) free extents
        self._free: list[tuple[int, int]] = [(0, size)]
        self._live: dict[int, int] = {}  # offset -> allocated length

    def alloc(self, nbytes: int, align: int = ALIGN) -> int:
        """Return the offset of a new block; raises when the arena is
        exhausted (the reference's memheap grows via mmap; a fixed arena
        keeps offsets stable, which symmetric addressing needs).
        ``align`` (shmem_align) must be a power of two; the 64-byte
        floor always applies, and alignment padding stays on the free
        list (no hidden per-allocation loss)."""
        if nbytes <= 0:
            raise errors.ArgError("alloc size must be positive")
        align = max(int(align), ALIGN)
        if align & (align - 1):
            raise errors.ArgError(
                f"alignment {align} is not a power of two"
            )
        want = -(-nbytes // ALIGN) * ALIGN
        for i, (off, length) in enumerate(self._free):
            aoff = -(-off // align) * align
            pad = aoff - off
            if length >= pad + want:
                pieces = []
                if pad:
                    pieces.append((off, pad))
                rest = length - pad - want
                if rest:
                    pieces.append((aoff + want, rest))
                self._free[i:i + 1] = pieces
                self._live[aoff] = want
                return aoff
        raise errors.ResourceError(
            f"symmetric heap exhausted: want {want} bytes"
        )

    def free(self, offset: int) -> None:
        length = self._live.pop(offset, None)
        if length is None:
            raise errors.ArgError(f"free of unallocated offset {offset}")
        self._free.append((offset, length))
        self._free.sort()
        # coalesce adjacent extents
        merged: list[tuple[int, int]] = []
        for off, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((off, ln))
        self._free = merged

    @property
    def live_bytes(self) -> int:
        return sum(self._live.values())
