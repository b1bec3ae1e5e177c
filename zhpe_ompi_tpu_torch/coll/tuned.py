"""coll/tuned — the decision layer (namesake: ``zhpe_ompi_tpu/coll/tuned.py``).

Re-design of ``ompi/mca/coll/tuned`` (SURVEY.md §2.4): picks an algorithm
per (operation, message size, comm size).

- Algorithm names are the JAX package's, so a rules file or an
  environment variable means the same in both packages.  ``xla`` means
  "the process group's native collective": the ``nccl`` component
  (``coll/nccl.py``), whichever backend (NCCL or gloo) runs the group.
- Forced algorithms are MCA vars holding names:
  ``ZMPI_MCA_coll_tuned_allreduce_algorithm=ring``.
- ``coll_tuned_dynamic_rules`` names a decision table
  (``<op> <comm_size_min> <msg_bytes_min> <algorithm>`` lines, with
  optional ``[topology ...]`` sections; see ``coll/ztable.py``); the most
  specific matching line wins, else the builtin fixed decisions apply.
- Non-commutative reductions always take ``linear``, the only algorithm
  that reduces in rank order, ahead of any table.

In the JAX package ``decide`` runs once, at trace time.  Here a collective
runs eagerly, so each communicator's module memoises its decisions per
(operation, message bytes, reduction op), and drops them when an MCA
variable changes (the registry's generation), when the rules file is
rewritten or when ``ZMPI_PMIX`` changes.

No decision profile is shipped: the JAX package's v5e-8 ICI profile was
derived for a TPU ring and does not carry over; an H100 profile starts
empty until a sweep on the card fills it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..mca import output as mca_output
from ..mca import var as mca_var
from . import algorithms as alg
from . import nccl as native
from . import ztable
from .framework import CollComponent, CollModule

_stream = mca_output.open_stream("coll_tuned")

ALLREDUCE_ALGS = {
    # forced-alg name surface mirrors coll_tuned_allreduce_decision.c:37-46
    "xla": None,  # delegate to the native path (coll/nccl)
    "linear": alg.allreduce_linear,
    "nonoverlapping": alg.allreduce_nonoverlapping,
    "recursive_doubling": alg.allreduce_recursive_doubling,
    "ring": alg.allreduce_ring,
    "segmented_ring": alg.allreduce_segmented_ring,
    "rabenseifner": alg.allreduce_rabenseifner,
}
BCAST_ALGS = {
    # cf. coll_tuned_bcast_decision.c:37-49
    "xla": None,
    "linear": alg.bcast_linear,
    "chain": alg.bcast_chain,
    "pipeline": alg.bcast_pipeline,
    "split_binary": alg.bcast_split_binary,
    "binary": alg.bcast_binary,
    "binomial": alg.bcast_binomial,
    "knomial": alg.bcast_knomial,
    "scatter_allgather": alg.bcast_scatter_allgather,
}
REDUCE_ALGS = {
    # cf. coll_tuned_reduce_decision.c
    "xla": None,
    "linear": alg.reduce_linear,
    "chain": alg.reduce_chain,
    "pipeline": alg.reduce_pipeline,
    "binary": alg.reduce_binary,
    "binomial": alg.reduce_binomial,
    "in_order_binary": alg.reduce_in_order_binary,
    "rabenseifner": alg.reduce_rabenseifner,
}
ALLGATHER_ALGS = {
    # cf. coll_tuned_allgather_decision.c
    "xla": None,
    "linear": alg.allgather_linear,
    "bruck": alg.allgather_bruck,
    "recursive_doubling": alg.allgather_recursive_doubling,
    "ring": alg.allgather_ring,
    "neighbor_exchange": alg.allgather_neighbor_exchange,
    "two_proc": alg.allgather_two_proc,
}
ALLTOALL_ALGS = {
    # cf. coll_tuned_alltoall_decision.c:35-43
    "xla": None,
    "linear": alg.alltoall_linear,
    "pairwise": alg.alltoall_pairwise,
    "bruck": alg.alltoall_bruck,
    "linear_sync": alg.alltoall_linear_sync,
    "two_proc": alg.alltoall_two_proc,
}
REDUCE_SCATTER_ALGS = {
    "xla": None,
    "nonoverlapping": alg.reduce_scatter_nonoverlapping,
    "recursive_halving": alg.reduce_scatter_recursive_halving,
    "ring": alg.reduce_scatter_ring,
    "butterfly": alg.reduce_scatter_butterfly,
    "linear": alg.reduce_scatter_block_linear,
}
REDUCE_SCATTER_BLOCK_ALGS = {
    # cf. coll_base_reduce_scatter_block.c:55,128,326,567
    "xla": None,
    "linear": alg.reduce_scatter_block_linear,
    "recursive_doubling": alg.reduce_scatter_block_recursive_doubling,
    "recursive_halving": alg.reduce_scatter_block_recursive_halving,
    "butterfly": alg.reduce_scatter_block_butterfly,
}
BARRIER_ALGS = {
    # cf. coll_base_barrier.c:100,172,253,291,330,404
    "xla": None,
    "linear": alg.barrier_linear,
    "double_ring": alg.barrier_double_ring,
    "recursive_doubling": alg.barrier_recursive_doubling,
    "bruck": alg.barrier_dissemination,
    "two_proc": alg.barrier_two_proc,
    "tree": alg.barrier_tree,
}
SCAN_ALGS = {
    "linear": alg.scan_linear,
    "recursive_doubling": alg.scan_recursive_doubling,
}
EXSCAN_ALGS = {
    "linear": alg.exscan_linear,
    "recursive_doubling": alg.exscan_recursive_doubling,
}
GATHER_ALGS = {
    # cf. coll_base_gather.c:41,208
    "xla": None,
    "binomial": alg.gather_binomial,
    "linear_sync": alg.gather_linear_sync,
    "ring": alg.gather_ring,
}
SCATTER_ALGS = {
    # cf. coll_base_scatter.c:63,285
    "xla": None,
    "binomial": alg.scatter_binomial,
    "linear": alg.scatter_linear,
}
ALLGATHERV_ALGS = {
    "xla": None,
    "concat": alg.allgatherv_concat,
}
ALLTOALLV_ALGS = {
    "xla": None,
    "pairwise": alg.alltoallv_padded,
}

_ALG_TABLES = {
    "allreduce": ALLREDUCE_ALGS,
    "bcast": BCAST_ALGS,
    "reduce": REDUCE_ALGS,
    "allgather": ALLGATHER_ALGS,
    "alltoall": ALLTOALL_ALGS,
    "reduce_scatter": REDUCE_SCATTER_ALGS,
    "reduce_scatter_block": REDUCE_SCATTER_BLOCK_ALGS,
    "barrier": BARRIER_ALGS,
    "scan": SCAN_ALGS,
    "exscan": EXSCAN_ALGS,
    "gather": GATHER_ALGS,
    "scatter": SCATTER_ALGS,
    "allgatherv": ALLGATHERV_ALGS,
    "alltoallv": ALLTOALLV_ALGS,
}

# ops whose first positional arg after the buffer is the reduction op
_OPS_WITH_REDUCTION = (
    "allreduce", "reduce", "reduce_scatter", "reduce_scatter_block",
    "scan", "exscan",
)

# Host-plane ops for which "han" is a valid rule-line algorithm in the JAX
# package (its coll/host.HAN_OPS).  The port has no host plane yet; such a
# line parses, and the device decision falls through it, as there.
_HAN_RULE_OPS = frozenset((
    "allreduce", "bcast", "reduce", "barrier", "allgather",
    "reduce_scatter", "alltoall", "alltoallv",
))

# Decision thresholds (bytes); MCA-tunable.  The JAX package's defaults
# (the reference's 10KB/1MB order of magnitude); not yet measured on an
# H100.
_DEFAULT_SMALL = 16 * 1024
_DEFAULT_LARGE = 1 * 1024 * 1024


def _register_params():
    for opname, table in _ALG_TABLES.items():
        mca_var.register(
            f"coll_tuned_{opname}_algorithm",
            "auto",
            f"Forced algorithm for {opname}: one of "
            + ", ".join(["auto"] + list(table)),
            enum=tuple(["auto"] + list(table)),
        )
    mca_var.register(
        "coll_tuned_small_msg", _DEFAULT_SMALL,
        "Message size (bytes) below which latency-optimal algorithms win",
        type=int,
    )
    mca_var.register(
        "coll_tuned_large_msg", _DEFAULT_LARGE,
        "Message size (bytes) above which bandwidth-optimal algorithms win",
        type=int,
    )
    mca_var.register(
        "coll_tuned_dynamic_rules", "",
        "Path to a dynamic decision-rules file "
        "(<op> <comm_size_min> <msg_bytes_min> <algorithm> per line; "
        "optional [topology n_hosts n_domains ranks_per_domain] sections "
        "scope rules to a topology shape — see coll/ztable.py)",
    )


def _valid_rule_alg(op: str, algname: str) -> bool:
    if algname == "builtin":
        # explicit band terminator: "keep the builtin decision here"
        return True
    table = _ALG_TABLES.get(op)
    if table is not None and algname in table:
        return True
    return algname == "han" and op in _HAN_RULE_OPS


# ztable owns shape parsing; which algorithm names exist is this module's
ztable.set_alg_validator(_valid_rule_alg)


def invalidate_rules_cache() -> None:
    """Drop every cached decision table, so the next decision re-reads
    it."""
    ztable.invalidate_cache()


def _nbytes(x) -> int:
    """Bytes of a tensor or a tuple of tensors (a non-tensor counts 8)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return 0 if x is None else 8


def profiles() -> dict[str, str]:
    """Shipped decision profiles (coll_tuned_dynamic_file.c analogs): name
    -> path, loadable through ``coll_tuned_dynamic_rules``.  None is
    shipped yet: an H100 profile comes from a sweep on the card."""
    return {}


def decide(opname: str, comm, x, op=None) -> str:
    """Pick an algorithm name for this call, as the JAX package's decide
    does for the same (operation, comm size, bytes, reduction op)."""
    table = _ALG_TABLES[opname]
    forced = mca_var.get(f"coll_tuned_{opname}_algorithm", "auto")
    if forced != "auto" and forced in table:
        return forced
    n = comm.size
    nbytes = _nbytes(x)
    # Non-commutative ops must reduce in rank order: only linear preserves
    # it.  Checked BEFORE dynamic rules — a tuning profile is a
    # performance hint and must never override correctness (forced
    # algorithms remain the user's explicit responsibility).
    if op is not None and not op.commute and opname in (
        "allreduce", "reduce", "reduce_scatter", "reduce_scatter_block",
    ):
        return "linear"
    dyn = ztable.resolve_rule(opname, n, nbytes, ztable.job_topology_key())
    if dyn in table:
        return dyn
    small = mca_var.get("coll_tuned_small_msg", _DEFAULT_SMALL)
    large = mca_var.get("coll_tuned_large_msg", _DEFAULT_LARGE)
    native_op = op is not None and op.reduce_op is not None
    if opname == "allreduce":
        if native_op:
            return "xla"
        if nbytes < small:
            return "recursive_doubling"
        if n and n & (n - 1) == 0 and nbytes >= large:
            return "rabenseifner"
        return "ring"
    if opname == "bcast":
        if nbytes < small:
            return "xla"
        return "scatter_allgather" if nbytes >= large else "binomial"
    if opname == "reduce":
        return "xla" if native_op else "binomial"
    if opname in ("scatter", "gather"):
        # the native forms move p x the payload (scatter = bcast+slice,
        # gather = allgather): right at latency-bound sizes only
        return "xla" if nbytes < large else "binomial"
    if opname in ("allgather", "alltoall", "barrier",
                  "allgatherv", "alltoallv"):
        return "xla"
    if opname in ("reduce_scatter", "reduce_scatter_block"):
        # the JAX package's native reduce-scatter is psum_scatter: SUM only
        if op is not None and op.reduce_op == dist.ReduceOp.SUM:
            return "xla"
        if n and n & (n - 1) == 0:
            return "recursive_halving"
        return "ring" if opname == "reduce_scatter" else "recursive_doubling"
    if opname in ("scan", "exscan"):
        return "recursive_doubling"
    return next(iter(table))


class _Decisions:
    """One communicator's memo of ``decide``, resolved to the function
    that serves the call (an algorithm, or the native ``coll/nccl``
    one), valid while the MCA variables, the rules file and
    ``ZMPI_PMIX`` stay as they were: a repeated call costs the stamp
    check and one dict lookup."""

    def __init__(self) -> None:
        self._memo: dict = {}
        self._generation = None
        self._rules_path = ""
        self._stamp = None

    def _current_stamp(self):
        gen = mca_var.registry.generation
        if gen != self._generation:
            self._generation = gen
            self._rules_path = str(mca_var.get("coll_tuned_dynamic_rules", ""))
        rules = ztable.file_stamp(self._rules_path) if self._rules_path else None
        return (gen, rules, os.environ.get("ZMPI_PMIX", ""))

    def impl(self, opname, comm, x, op):
        stamp = self._current_stamp()
        if stamp != self._stamp:
            self._memo.clear()
            self._stamp = stamp
        key = (opname, _nbytes(x),
               None if op is None else (op.commute, op.reduce_op))
        fn = self._memo.get(key)
        if fn is None:
            algname = decide(opname, comm, x, op)
            mca_output.verbose(9, _stream, "%s size=%s -> %s", opname,
                               comm.size, algname)
            fn = _ALG_TABLES[opname][algname] or getattr(native, opname)
            self._memo[key] = fn
        return fn


def _dispatch(opname, decisions):
    reduces = opname in _OPS_WITH_REDUCTION

    def fn(comm, *args, **kwargs):
        x = args[0] if args else kwargs.get("token")
        op = args[1] if reduces and len(args) > 1 else None
        return decisions.impl(opname, comm, x, op)(comm, *args, **kwargs)

    return fn


class TunedCollComponent(CollComponent):
    name = "tuned"
    default_priority = 50

    def __init__(self) -> None:
        super().__init__()
        _register_params()

    def comm_query(self, comm) -> CollModule | None:
        decisions = _Decisions()
        return CollModule(
            **{opname: _dispatch(opname, decisions) for opname in _ALG_TABLES},
        )
