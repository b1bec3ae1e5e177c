"""Graph and distributed-graph topologies (MPI_Graph_*, MPI_Dist_graph_*)
(namesake: ``zhpe_ompi_tpu/topo/graph.py``; the port's own copy).

Parity targets: ``ompi/mca/topo/base/topo_base_graph_create.c`` (the
index/edges flattened-adjacency encoding), ``topo_base_graph_neighbors.c``,
``topo_base_dist_graph_create_adjacent.c`` (per-rank sources/destinations
with weights), and the treematch reorder component
(``ompi/mca/topo/treematch/topo_treematch_dist_graph_create.c``) which maps
heavy-traffic ranks onto nearby cores — here a greedy placement onto a
ring order.

Every rank's constructor receives the FULL topology (what the reference
gathers from per-process adjacency via allgather at create time); neighbor
queries are host-side table lookups.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import errors


class GraphTopology:
    """MPI_Graph_create: flattened adjacency of an (optionally asymmetric)
    graph.  `index[i]` is the cumulative neighbor count through node i and
    `edges` the concatenated neighbor lists — the exact MPI encoding
    (``topo_base_graph_create.c``)."""

    def __init__(self, comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False) -> None:
        self.comm = comm
        size = comm.size
        if len(index) != size:
            raise errors.ArgError(
                f"index has {len(index)} entries for comm size {size}"
            )
        if list(index) != sorted(index) or (index and index[-1] != len(edges)):
            raise errors.ArgError("malformed index/edges arrays")
        if any(not 0 <= e < size for e in edges):
            raise errors.RankError("edge endpoint out of range")
        self.index = tuple(int(i) for i in index)
        self.edges = tuple(int(e) for e in edges)
        self.reorder = bool(reorder)
        self._adj: list[list[int]] = []
        lo = 0
        for hi in self.index:
            self._adj.append(list(self.edges[lo:hi]))
            lo = hi
        # in-neighbor lists, precomputed O(V+E) (queried per edge)
        self._in_adj: list[list[int]] = [[] for _ in range(size)]
        for r, outs in enumerate(self._adj):
            for d in outs:
                self._in_adj[d].append(r)

    def neighbors_count(self, rank: int) -> int:
        """MPI_Graph_neighbors_count."""
        self._check(rank)
        return len(self._adj[rank])

    def neighbors(self, rank: int) -> list[int]:
        """MPI_Graph_neighbors (``topo_base_graph_neighbors.c``)."""
        self._check(rank)
        return list(self._adj[rank])

    # For MPI graph topologies, neighbor collectives treat the adjacency
    # as both the send and the receive direction (MPI-3.1 §7.6).
    def out_neighbors(self, rank: int) -> list[int]:
        return self.neighbors(rank)

    def in_neighbors(self, rank: int) -> list[int]:
        self._check(rank)
        return list(self._in_adj[rank])

    def _check(self, rank: int) -> None:
        if not 0 <= rank < self.comm.size:
            raise errors.RankError(f"rank {rank} out of range")

    @property
    def degree(self) -> int:
        return max((len(a) for a in self._adj), default=0)


class DistGraphTopology:
    """MPI_Dist_graph_create_adjacent, whole-topology form: the caller
    supplies every rank's in-neighbor (`sources_of`) and out-neighbor
    (`destinations_of`) lists, optionally with weights
    (``topo_base_dist_graph_create_adjacent.c``)."""

    def __init__(self, comm, sources_of: Sequence[Sequence[int]],
                 destinations_of: Sequence[Sequence[int]],
                 source_weights: Sequence[Sequence[int]] | None = None,
                 dest_weights: Sequence[Sequence[int]] | None = None,
                 reorder: bool = False) -> None:
        size = comm.size
        if len(sources_of) != size or len(destinations_of) != size:
            raise errors.ArgError("adjacency lists must cover every rank")
        self.comm = comm
        self.sources_of = [list(map(int, s)) for s in sources_of]
        self.destinations_of = [list(map(int, d)) for d in destinations_of]
        for adj in (self.sources_of, self.destinations_of):
            for lst in adj:
                if any(not 0 <= r < size for r in lst):
                    raise errors.RankError("neighbor rank out of range")
        # consistency: r lists s as a source  <=>  s lists r as a dest
        want = sorted(
            (s, r) for r, srcs in enumerate(self.sources_of) for s in srcs
        )
        have = sorted(
            (r, d) for r, dsts in enumerate(self.destinations_of) for d in dsts
        )
        if want != have:
            raise errors.ArgError(
                "sources_of and destinations_of describe different edge sets"
            )
        self.source_weights = (
            [list(map(int, w)) for w in source_weights]
            if source_weights is not None
            else [[1] * len(s) for s in self.sources_of]
        )
        self.dest_weights = (
            [list(map(int, w)) for w in dest_weights]
            if dest_weights is not None
            else [[1] * len(d) for d in self.destinations_of]
        )
        self.reorder = bool(reorder)

    @classmethod
    def from_edges(cls, comm, edge_list: Sequence[tuple[int, int]],
                   reorder: bool = False) -> "DistGraphTopology":
        """Build from a global (src, dst) edge list."""
        size = comm.size
        srcs: list[list[int]] = [[] for _ in range(size)]
        dsts: list[list[int]] = [[] for _ in range(size)]
        for s, d in edge_list:
            dsts[int(s)].append(int(d))
            srcs[int(d)].append(int(s))
        return cls(comm, srcs, dsts, reorder=reorder)

    def neighbors_count(self, rank: int) -> tuple[int, int, bool]:
        """MPI_Dist_graph_neighbors_count → (indegree, outdegree, weighted)
        (``topo_base_dist_graph_neighbors_count.c``)."""
        return (len(self.sources_of[rank]),
                len(self.destinations_of[rank]), True)

    def neighbors(self, rank: int) -> tuple[list[int], list[int],
                                            list[int], list[int]]:
        """MPI_Dist_graph_neighbors → (sources, source_weights,
        destinations, dest_weights)."""
        return (list(self.sources_of[rank]),
                list(self.source_weights[rank]),
                list(self.destinations_of[rank]),
                list(self.dest_weights[rank]))

    def out_neighbors(self, rank: int) -> list[int]:
        return list(self.destinations_of[rank])

    def in_neighbors(self, rank: int) -> list[int]:
        return list(self.sources_of[rank])

    @property
    def degree(self) -> int:
        return max(
            [len(s) for s in self.sources_of]
            + [len(d) for d in self.destinations_of] + [0]
        )


def reorder_greedy(traffic: np.ndarray) -> list[int]:
    """Treematch-style traffic-aware reorder for a 1-D ring: return a
    permutation `perm` where `perm[new_position] = old_rank`, placing
    heavily-communicating ranks adjacently.

    The reference's treematch builds a hierarchical grouping over the
    hardware tree (``topo_treematch_dist_graph_create.c``); along a ring
    the locality gradient is position, so a greedy chain works: start
    from the heaviest edge and repeatedly append
    (at either chain end) the unplaced rank with the most traffic to that
    end.
    """
    t = np.asarray(traffic, dtype=np.float64)
    n = t.shape[0]
    if t.shape != (n, n):
        raise errors.ArgError("traffic matrix must be square")
    sym = t + t.T
    np.fill_diagonal(sym, -1.0)
    if n == 1:
        return [0]
    a, b = np.unravel_index(int(np.argmax(sym)), sym.shape)
    chain = [int(a), int(b)]
    placed = set(chain)
    while len(chain) < n:
        head, tail = chain[0], chain[-1]
        best, best_w, at_head = -1, -np.inf, True
        for r in range(n):
            if r in placed:
                continue
            if sym[head, r] > best_w:
                best, best_w, at_head = r, sym[head, r], True
            if sym[tail, r] > best_w:
                best, best_w, at_head = r, sym[tail, r], False
        if at_head:
            chain.insert(0, best)
        else:
            chain.append(best)
        placed.add(best)
    return chain
