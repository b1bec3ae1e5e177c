"""Cartesian topologies (MPI_Cart_*) (namesake: ``zhpe_ompi_tpu/topo/cart.py``;
the port's own copy).

Parity targets: ``ompi/mca/topo/base/topo_base_cart_create.c`` (row-major
rank→coords), ``topo_base_cart_shift.c`` (PROC_NULL at non-periodic edges),
``topo_base_cart_sub.c`` (keep/drop dims → sub-communicators),
``ompi/mpi/c/dims_create.c`` (balanced factorization).

``MPI_Cart_shift`` + ``MPI_Sendrecv`` is one permute of the SPMD plane
(``Communicator.permute``) with a static uniform pattern; non-periodic
boundary ranks receive zeros (the MPI_PROC_NULL contract: every rank
produces a value, so the value is zeros).  ``sub`` splits the
communicator, and each rank gets its own sub-grid's communicator (the
port's ``split``), with the whole partition kept in ``comm.partition``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import errors


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def dims_create(nnodes: int, ndims: int,
                dims: Sequence[int] | None = None) -> list[int]:
    """MPI_Dims_create: fill zero entries of `dims` so the product is
    `nnodes`, as balanced as possible (``ompi/mpi/c/dims_create.c``).
    Nonzero entries are constraints and are preserved."""
    if nnodes <= 0:
        raise errors.ArgError(f"nnodes must be positive, got {nnodes}")
    dims = list(dims) if dims is not None else [0] * ndims
    if len(dims) != ndims:
        raise errors.ArgError(f"dims has {len(dims)} entries, ndims={ndims}")
    fixed = 1
    for d in dims:
        if d < 0:
            raise errors.ArgError("negative dimension")
        if d > 0:
            fixed *= d
    if fixed == 0:
        raise errors.ArgError("zero nnodes")
    if nnodes % fixed:
        raise errors.ArgError(
            f"nnodes {nnodes} not divisible by fixed dims (product {fixed})"
        )
    free = [i for i, d in enumerate(dims) if d == 0]
    if not free:
        if fixed != nnodes:
            raise errors.ArgError("fully-constrained dims do not multiply "
                                  f"to nnodes ({fixed} != {nnodes})")
        return dims
    vals = [1] * len(free)
    # multiply each prime factor (largest first) into the smallest slot
    for f in sorted(_prime_factors(nnodes // fixed), reverse=True):
        vals[int(np.argmin(vals))] *= f
    # MPI requires monotonically non-increasing filled dims
    for slot, v in zip(free, sorted(vals, reverse=True)):
        dims[slot] = v
    return dims


class CartTopology:
    """Cartesian topology attached to a communicator.

    Rank numbering is row-major over `dims` exactly as
    ``topo_base_cart_create.c`` computes it; all maps are static numpy
    tables that every rank computes alike.
    """

    def __init__(self, comm, dims: Sequence[int],
                 periods: Sequence[bool] | None = None,
                 reorder: bool = False) -> None:
        self.comm = comm
        self.dims = tuple(int(d) for d in dims)
        self.ndims = len(self.dims)
        if any(d <= 0 for d in self.dims):
            raise errors.ArgError(f"bad dims {self.dims}")
        size = comm.size
        n = int(np.prod(self.dims))
        if n != size:
            raise errors.CommError(
                f"dims {self.dims} (={n}) != comm size {size}"
            )
        self.periods = tuple(
            bool(p) for p in (periods or [False] * self.ndims)
        )
        if len(self.periods) != self.ndims:
            raise errors.ArgError("periods length mismatch")
        # reorder is the identity (see the package docstring); the flag is
        # kept for API parity.
        self.reorder = bool(reorder)
        # rank -> coords (row-major), coords -> rank
        self._coords = np.stack(
            np.unravel_index(np.arange(n), self.dims), axis=1
        ).astype(np.int32)
        # memoized static tables (built on demand, reused across calls)
        self._shift_cache: dict[tuple[int, int], tuple[list, list]] = {}
        self._neighbor_table: list[list[int]] | None = None

    # -- introspection (MPI_Cartdim_get / MPI_Cart_get) -------------------

    def coords(self, rank: int) -> tuple[int, ...]:
        """MPI_Cart_coords (``topo_base_cart_coords.c``)."""
        if not 0 <= rank < len(self._coords):
            raise errors.RankError(f"rank {rank} out of range")
        return tuple(int(c) for c in self._coords[rank])

    def rank_of(self, coords: Sequence[int]) -> int:
        """MPI_Cart_rank; periodic dims wrap, non-periodic out-of-range is
        an error (``topo_base_cart_rank.c``)."""
        if len(coords) != self.ndims:
            raise errors.ArgError("coords length mismatch")
        fixed = []
        for c, d, p in zip(coords, self.dims, self.periods):
            c = int(c)
            if p:
                c %= d
            elif not 0 <= c < d:
                raise errors.RankError(
                    f"coordinate {c} out of range for non-periodic dim {d}"
                )
            fixed.append(c)
        return int(np.ravel_multi_index(fixed, self.dims))

    # -- shift (MPI_Cart_shift) ------------------------------------------

    def shift(self, dim: int, disp: int = 1
              ) -> tuple[list[int], list[int]]:
        """Per-rank (rank_source, rank_dest) lists; -1 is MPI_PROC_NULL
        (``topo_base_cart_shift.c``).  Vectorized and memoized: tables are
        static per topology, so a repeat pays a dict lookup, not O(size)."""
        if not 0 <= dim < self.ndims:
            raise errors.ArgError(f"dim {dim} out of range")
        cached = self._shift_cache.get((dim, disp))
        if cached is not None:
            return list(cached[0]), list(cached[1])  # copies: cache is live

        def moved(delta: int) -> list[int]:
            c = self._coords.astype(np.int64).copy()
            c[:, dim] += delta
            d = self.dims[dim]
            if self.periods[dim]:
                c[:, dim] %= d
                valid = np.ones(len(c), dtype=bool)
            else:
                valid = (c[:, dim] >= 0) & (c[:, dim] < d)
                c[:, dim] = np.clip(c[:, dim], 0, d - 1)
            ranks = np.ravel_multi_index(c.T, self.dims)
            return list(np.where(valid, ranks, -1).astype(int))

        result = (moved(-disp), moved(disp))  # (sources, dests)
        self._shift_cache[(dim, disp)] = result
        return list(result[0]), list(result[1])

    def shift_exchange(self, x, dim: int, disp: int = 1):
        """Every rank sends `x` to its +disp neighbor along `dim` and
        returns what arrives from its -disp neighbor (zeros at a
        non-periodic boundary).  The MPI_Cart_shift+MPI_Sendrecv idiom as
        one permute."""
        _, dst = self.shift(dim, disp)
        return self.comm.permute(x, dst)

    # -- sub-grids (MPI_Cart_sub) ----------------------------------------

    def sub(self, remain_dims: Sequence[bool], name: str | None = None):
        """Split into sub-communicators keeping `remain_dims` dims
        (``topo_base_cart_sub.c``).  Returns (comm, topo): this rank's
        sub-grid communicator (collective over the communicator; its
        partition lists every sub-grid, each ordered row-major over the
        kept dims), plus the kept-dims topology."""
        if len(remain_dims) != self.ndims:
            raise errors.ArgError("remain_dims length mismatch")
        keep = [i for i, k in enumerate(remain_dims) if k]
        drop = [i for i, k in enumerate(remain_dims) if not k]
        if not keep:
            raise errors.ArgError("must keep at least one dim")
        colors, keys = [], []
        for rank in range(len(self._coords)):
            c = self._coords[rank]
            drop_coords = tuple(int(c[i]) for i in drop)
            keep_coords = tuple(int(c[i]) for i in keep)
            color = 0 if not drop else int(np.ravel_multi_index(
                drop_coords, [self.dims[i] for i in drop]
            ))
            key = int(np.ravel_multi_index(
                keep_coords, [self.dims[i] for i in keep]
            ))
            colors.append(color)
            keys.append(key)
        sub = self.comm.split(colors, keys, name=name)
        topo = CartTopology.__new__(CartTopology)
        topo.comm = sub
        topo.dims = tuple(self.dims[i] for i in keep)
        topo.ndims = len(keep)
        topo.periods = tuple(self.periods[i] for i in keep)
        topo.reorder = False
        nsub = int(np.prod(topo.dims))
        topo._coords = np.stack(
            np.unravel_index(np.arange(nsub), topo.dims), axis=1
        ).astype(np.int32)
        topo._shift_cache = {}
        topo._neighbor_table = None
        return sub, topo

    # -- neighbor lists for neighbor collectives --------------------------

    def neighbor_ranks(self, rank: int) -> list[int]:
        """Ordered neighbors of `rank` for MPI_Neighbor_* on a cartesian
        communicator: for each dim, the -1 then +1 neighbor (the order
        MPI-3.1 §7.6 fixes); -1 = MPI_PROC_NULL."""
        if self._neighbor_table is None:
            shifts = [self.shift(d, 1) for d in range(self.ndims)]
            self._neighbor_table = [
                [t[r] for src_dst in shifts for t in src_dst]
                for r in range(len(self._coords))
            ]
        return list(self._neighbor_table[rank])

    # cartesian neighbor lists are symmetric: slot k both sends to and
    # receives from the k-th neighbor (MPI-3.1 §7.6 fixed order)
    def out_neighbors(self, rank: int) -> list[int]:
        return self.neighbor_ranks(rank)

    def in_neighbors(self, rank: int) -> list[int]:
        return self.neighbor_ranks(rank)

    @property
    def degree(self) -> int:
        return 2 * self.ndims

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CartTopology(dims={self.dims}, periods={self.periods}, "
                f"comm={self.comm.name})")
