"""coll/basic — reference-semantics fallback component (namesake:
``zhpe_ompi_tpu/coll/basic.py``).

Analog of ``ompi/mca/coll/basic`` (SURVEY.md §2.3): the simplest correct
implementation of every operation, used when higher-priority components
decline and as the semantic baseline tests compare against.  Linear/naive
algorithms only; rank-order reductions (correct for non-commutative ops).
"""

from __future__ import annotations

from . import algorithms as alg
from .framework import CollComponent, CollModule


class BasicCollComponent(CollComponent):
    name = "basic"
    default_priority = 10

    def comm_query(self, comm) -> CollModule | None:
        return CollModule(
            allreduce=alg.allreduce_linear,
            reduce=alg.reduce_linear,
            bcast=alg.bcast_binomial,
            barrier=alg.barrier_dissemination,
            allgather=alg.allgather_ring,
            allgatherv=alg.allgatherv_concat,
            alltoall=alg.alltoall_pairwise,
            alltoallv=alg.alltoallv_padded,
            reduce_scatter=alg.reduce_scatter_block_linear,
            reduce_scatter_block=alg.reduce_scatter_block_linear,
            scan=alg.scan_linear,
            exscan=alg.exscan_linear,
            gather=alg.gather_ring,
            scatter=alg.scatter_linear,
        )
