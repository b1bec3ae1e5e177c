"""Neighbor collectives (MPI_Neighbor_allgather / _alltoall) on topologies
(namesake: ``zhpe_ompi_tpu/topo/neighbor.py``).

Reference shape: the coll framework's neighbor entries
(``ompi/mca/coll/coll.h:572-576``) implemented by coll/basic as loops of
irecv/isend over the topology's neighbor lists
(``ompi/mca/coll/basic/coll_basic_neighbor_allgather.c``).

The topology is static, so the exchange is a short, fixed sequence of
permute rounds (``Communicator.ppermute``).  Edges are greedily
edge-coloured so every round is a partial permutation (each rank sends at
most once and receives at most once per round); a cartesian topology
needs exactly 2*ndims rounds, a general graph at most ~2*maxdegree.
Every rank takes part in every round.  Receive slots with no edge
(MPI_PROC_NULL at a non-periodic boundary, or an indegree below the
padded maximum) hold zeros: every rank produces the same shape, so "recv
buffer not written" becomes "slot is zero".

Message pairing for duplicate edges follows MPI's non-overtaking rule: the
j-th send from src to dst matches the j-th receive slot naming src at dst.
"""

from __future__ import annotations


def _edge_rounds(topo):
    """Build edge-colored rounds: each round is (pairs, send_slot_table,
    recv_slot_table) over comm-relative ranks; tables hold -1 for ranks
    idle in that round."""
    size = topo.comm.size
    # snapshot neighbor lists once (queries can be O(size) per call)
    out_lists = [topo.out_neighbors(r) for r in range(size)]
    in_lists = [topo.in_neighbors(r) for r in range(size)]
    edges = []  # (src, dst, send_slot, recv_slot)
    for src in range(size):
        seen: dict[int, int] = {}
        for j, dst in enumerate(out_lists[src]):
            if dst < 0:  # MPI_PROC_NULL
                continue
            occurrence = seen.get(dst, 0)
            seen[dst] = occurrence + 1
            # match the occurrence-th appearance of src in dst's in-list
            hits = [k for k, r in enumerate(in_lists[dst]) if r == src]
            recv_slot = hits[occurrence]
            edges.append((src, dst, j, recv_slot))
    # greedy edge coloring: first color where src isn't sending and dst
    # isn't receiving yet (≤ 2*maxdeg-1 colors, Vizing-adjacent bound)
    rounds: list[dict] = []
    for src, dst, sslot, rslot in edges:
        for rnd in rounds:
            if src not in rnd["senders"] and dst not in rnd["receivers"]:
                break
        else:
            rnd = {"senders": set(), "receivers": set(), "edges": []}
            rounds.append(rnd)
        rnd["senders"].add(src)
        rnd["receivers"].add(dst)
        rnd["edges"].append((src, dst, sslot, rslot))
    out = []
    for rnd in rounds:
        pairs = [(s, d) for s, d, _, _ in rnd["edges"]]
        send_tab = [-1] * size
        recv_tab = [-1] * size
        for s, d, sslot, rslot in rnd["edges"]:
            send_tab[s] = sslot
            recv_tab[d] = rslot
        out.append((pairs, send_tab, recv_tab))
    return out


def _in_degree_max(topo) -> int:
    return max(
        (len(topo.in_neighbors(r)) for r in range(topo.comm.size)), default=0
    )


def _exchange(topo, x, alltoall: bool):
    comm = topo.comm
    rank = comm.rank
    elem_shape = x.shape[1:] if alltoall else x.shape
    out = x.new_zeros((_in_degree_max(topo),) + tuple(elem_shape))
    for pairs, send_tab, recv_tab in _edge_rounds(topo):
        payload = x[max(send_tab[rank], 0)] if alltoall else x
        recv = comm.ppermute(payload, pairs)
        if recv_tab[rank] >= 0:
            out[recv_tab[rank]] = recv
    return out


def neighbor_allgather(topo, x):
    """MPI_Neighbor_allgather: each rank contributes `x` to all its
    out-neighbors; returns [max_indegree, *x.shape] where slot k holds the
    buffer from the k-th in-neighbor (zeros where none)."""
    return _exchange(topo, x, alltoall=False)


def neighbor_alltoall(topo, x):
    """MPI_Neighbor_alltoall: `x[j]` goes to the j-th out-neighbor;
    returns [max_indegree, *x.shape[1:]] with slot k from the k-th
    in-neighbor."""
    if x.dim() < 1:
        raise ValueError("alltoall payload needs a leading neighbor dim")
    return _exchange(topo, x, alltoall=True)
