"""Topo framework: process topologies (namesake: ``zhpe_ompi_tpu/topo``).

Re-design of ``ompi/mca/topo`` (interface ``ompi/mca/topo/topo.h:296-343``,
base implementations ``ompi/mca/topo/base/topo_base_cart_create.c`` et al.):

- A topology is a static host-side description attached to a
  communicator: rank↔coordinate maps are numpy tables every rank computes
  alike, not negotiated state.
- ``MPI_Cart_shift`` + sendrecv is one permute with a uniform shift
  pattern; neighbor collectives are a short sequence of permute rounds
  (one per cart direction, or per colour class of a greedy edge colouring
  for general graphs) instead of per-edge send/recv.
- ``reorder=True`` for cartesian topologies is the identity; distributed
  graphs get a treematch-style greedy traffic reorder
  (``graph.reorder_greedy``, cf.
  ``ompi/mca/topo/treematch/topo_treematch_dist_graph_create.c``).
"""

from __future__ import annotations

from .cart import CartTopology, dims_create
from .graph import DistGraphTopology, GraphTopology, reorder_greedy
from .neighbor import (
    neighbor_allgather,
    neighbor_alltoall,
)

__all__ = [
    "CartTopology",
    "GraphTopology",
    "DistGraphTopology",
    "dims_create",
    "reorder_greedy",
    "neighbor_allgather",
    "neighbor_alltoall",
]
