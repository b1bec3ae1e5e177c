"""Host-plane collectives: the full collective set over endpoint
send/recv, for universe (thread) and TCP ranks (namesake:
``zhpe_ompi_tpu/coll/host.py``; the port's own copy, over tensors).

The reference's collective algorithms run over the PML regardless of which
BTL carries the bytes — ``coll_base_allreduce.c:130-225`` is written in
``MCA_PML_CALL(send/recv)`` and therefore works over tcp for free.  Every
function here takes any endpoint exposing ``rank``/``size``/``send``/
``recv``/``sendrecv`` (universe ``RankContext``, ``TcpProc``) and speaks
only that surface.  (The device plane keeps NCCL and its own algorithms
in ``coll/nccl.py``/``coll/algorithms.py``; this is the control/host plane
the reference runs everything on.)

Algorithm choices mirror coll_base: binomial bcast/reduce (in-order linear
reduce for non-commutative ops), recursive-doubling allreduce with the
non-power-of-2 pre/post fold, ring allreduce above
``host_coll_large_msg``, pipelined bcast/reduce, ring allgather,
pairwise-exchange (or Bruck) alltoall, linear scan/exscan.  Operand order
is preserved for non-commutative ops: every combine keeps the lower-rank
contribution on the left.  Tags, chunk bounds and message order are the
namesake's, so port and JAX-package ranks run one collective together.

**Payloads.**  The collectives take CPU tensors, numpy arrays and Python
values (and lists/tuples of them, reduced blockwise).  Reductions combine
with the port's torch :class:`~zhpe_ompi_tpu_torch.ops.Op`, so every
operand is made a tensor first (a numpy array through ``torch.from_numpy``,
no copy; a Python number as a 0-d tensor).  What each returns:

- ``reduce`` (at root), ``allreduce``, ``scan``, ``exscan`` (rank > 0)
  and ``reduce_scatter`` return the kind the caller passed: a tensor for a
  tensor, a numpy array for a numpy array (a numpy scalar for a numpy
  scalar), a Python number for a Python number.
- The data-movement collectives (``bcast``, ``gather``, ``scatter``,
  ``allgather``, ``alltoall`` and the v-variants) return the payloads as
  the transport delivers them: on the thread plane, copies of the objects
  sent; over TCP, what :mod:`~zhpe_ompi_tpu_torch.utils.dss` decodes (an
  array — numpy or tensor — arrives as a CPU tensor).  The pipelined
  bcast returns a CPU tensor at the non-root ranks (a numpy array for a
  dtype torch lacks).

The ring allreduce runs in torch on the operand's own device (a CUDA
tensor on the thread plane stays on the card); the pipelined bcast and
reduce stream host bytes, so they take numpy arrays and CPU tensors.

**coll/han.**  ``_han_route`` and ``_rule_alg`` are the namesake's
seams: each collective with a hierarchical schedule (``HAN_OPS``) asks
``_han_route`` first and runs ``coll/han.py``'s two- or three-level
schedule when it answers (``coll_han_enable=auto`` on a qualified
topology, ``on``, or a ``han`` line of the rules table).  The phases of
han run on ``GroupView`` sub-endpoints, which re-enter the flat
algorithms here.  A rules table naming a flat algorithm (``ring``,
``pipeline``, ``bruck``) works through the port's
``coll/ztable.resolve_rule`` (the store rung under ``ZMPI_PMIX``, then
the file rung), keyed by ``han.topology_key``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..utils import dss
from ..utils.payload import payload_size_estimate as payload_bytes

_stream = mca_output.open_stream("coll_host")

mca_var.register(
    "host_coll_large_msg", 256 * 1024,
    "Array payload size (bytes) above which host-plane collectives switch "
    "to bandwidth-optimal algorithms (ring allreduce).  Provenance: the "
    "committed pt2pt ladder (benchmarks/baseline_cpu8.json) crosses from "
    "latency- to bandwidth-dominated between 16KB and 256KB one-way",
    type=int,
)
mca_var.register(
    "coll_han_enable", "auto",
    "Hierarchical (han) host collectives: auto = two-level schedules "
    "when the modex-derived locality topology has >= 2 same-host groups "
    "with >= 2 members each; on = forced (degenerate topologies fall "
    "back to the flat algorithms loudly via han_flat_fallbacks); off = "
    "always flat.  A 'han' line in coll_tuned_dynamic_rules requests "
    "the hierarchical path per op/size like a forced enable",
    enum=("auto", "on", "off"),
)
mca_var.register(
    "coll_tuned_dynamic_rules", "",
    "Path to a dynamic decision-rules file "
    "(<op> <comm_size_min> <msg_bytes_min> <algorithm> per line); the "
    "host-plane han decision honors 'han' lines, so the var registers "
    "with the host collectives too (the tuned component re-registers "
    "idempotently with its own surface)",
)


# the collectives with a hierarchical (coll/han) two-level schedule —
# the canonical set: the dispatch seam below, coll/han.py's decision,
# and coll/tuned.py's rules-line validation all read THIS name
HAN_OPS = frozenset((
    "allreduce", "bcast", "reduce", "barrier", "allgather",
    "reduce_scatter", "alltoall", "alltoallv",
))


def _han_route(ctx, opname: str, payload: Any = None, op=None):
    """The coll/han dispatch seam (the comm_select interposition point
    of the host plane): returns the han module when this collective
    should take the hierarchical schedule, None for the flat algorithms
    below.  Kept UPSTREAM of the algorithm bodies so han's own phases —
    GroupView sub-endpoints, marked ``_han_subview`` — re-enter the flat
    paths unconditionally (no recursive hierarchy)."""
    if getattr(ctx, "_han_subview", False):
        return None
    mode = str(mca_var.get("coll_han_enable", "auto"))
    if mode == "off":
        return None
    if mode == "auto" and getattr(ctx, "size", 1) < 4 \
            and not mca_var.get("coll_tuned_dynamic_rules", ""):
        # cheap pre-topology out: < 4 ranks cannot hold two >=2-member
        # groups, and no rules file means nothing can request han
        return None
    from . import han as han_mod

    if han_mod.wants_han(ctx, opname, payload, op, mode):
        return han_mod
    return None


# Flat host-plane algorithms a tuned decision table may name per op —
# the ztune candidate surface (besides "han", which routes through
# _han_route/wants_han above).  Every name here maps onto an existing
# eligibility-guarded body below; a rule naming one for an INELIGIBLE
# call (non-commutative op, scalar payload) degrades loudly to the
# builtin decision, never to a wrong answer.
HOST_RULE_ALGS = {
    "allreduce": ("recursive_doubling", "ring"),
    "reduce": ("binomial", "pipeline"),
    "alltoall": ("pairwise", "bruck"),
    "alltoallv": ("pairwise",),
}


def _rule_alg(ctx, opname: str, payload: Any = None) -> "str | None":
    """The host plane's tuned-table consult (coll/ztable.py's store rung
    under ``ZMPI_PMIX``, then its file rung), topology-keyed from this
    endpoint's locality probe.  Returns a flat algorithm name from
    ``HOST_RULE_ALGS`` or None — builtin thresholds and the auto han
    decision apply.  "han" rules return None HERE: the _han_route seam
    owns them (via han's ``_rule_requests_han``)."""
    if getattr(ctx, "_han_subview", False):
        return None  # phase traffic re-enters the builtin decisions
    from . import ztable

    if not ztable.active():
        return None
    from . import han as han_mod

    algname = ztable.resolve_rule(
        opname, getattr(ctx, "size", 0), payload_bytes(payload),
        han_mod.topology_key(ctx),
    )
    if algname is not None and algname in HOST_RULE_ALGS.get(opname, ()):
        return algname
    return None

# Reserved context id for host-plane collective traffic (the
# MCA_COLL_BASE_TAG_* space; barrier already uses cid 0x7FFF).
COLL_CID = 0x7FFD

# Per-operation base tags (the MCA_COLL_BASE_TAG_* table).
TAG_BCAST = 0x7E01
TAG_REDUCE = 0x7E02
TAG_ALLREDUCE = 0x7E03
TAG_ALLGATHER = 0x7E04
TAG_GATHER = 0x7E05
TAG_SCATTER = 0x7E06
TAG_ALLTOALL = 0x7E07
TAG_SCAN = 0x7E08
TAG_RSCAT = 0x7E09
TAG_GATHERV = 0x7E0B
TAG_SCATTERV = 0x7E0C
TAG_ALLGATHERV = 0x7E0D
TAG_ALLTOALLV = 0x7E0E
TAG_NEIGHBOR = 0x7E0F


def _next_tag(ctx, base: int) -> int:
    """Instance tag = base kind tag + a per-endpoint collective sequence
    number.

    MPI requires every rank to issue collectives on a communicator in the
    same program order, so the k-th collective gets the same tag on every
    rank — and two overlapping collectives (a nonblocking one outstanding
    across a blocking one, two outstanding nonblocking ones progressed in
    different orders) can never cross-match, even though their rounds
    interleave arbitrarily on the wire.  Base tags alone are NOT enough:
    round numbering differs per rank (a fold rank's round 1 is a
    non-fold rank's round 0), so posted-recv order need not match send
    order across instances.  The reference solves this the same way via
    libnbc's schedule tags (nbc.c `schedule->tag`)."""
    seq = getattr(ctx, "_coll_seq", 0)
    ctx._coll_seq = seq + 1
    return ((seq % 0x8000) << 16) | base


def _operand(x: Any) -> Any:
    """``x`` as a tensor operand of a torch ``Op``: a tensor as is, a
    numpy array through ``torch.from_numpy`` (no copy), a numpy scalar or
    a Python number as a 0-d tensor.  A Python float or complex keeps its
    double precision (float64/complex128, as numpy reduces it in the
    namesake), not torch's float32 default."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.generic):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x if x.flags.writeable else x.copy())
    if isinstance(x, (bool, int)):
        return torch.tensor(x)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64)
    if isinstance(x, complex):
        return torch.tensor(x, dtype=torch.complex128)
    return x


def _combine(op, a: Any, b: Any) -> Any:
    """a ⊕ b, mapped elementwise through lists/tuples (blockwise reduce);
    a pair op (MINLOC/MAXLOC) combines its ``(values, indices)`` pairs
    whole."""
    if getattr(op, "pair_op", False) and isinstance(a, (list, tuple)) \
            and len(a) == 2 and not isinstance(a[0], (list, tuple)):
        return op(tuple(_operand(x) for x in a),
                  tuple(_operand(x) for x in b))
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise errors.ArgError("blockwise reduce of mismatched sequences")
        return type(a)(_combine(op, x, y) for x, y in zip(a, b))
    out = op(_operand(a), _operand(b))
    if isinstance(a, _SCALARS) and isinstance(b, _SCALARS):
        # a numpy scalar, as the namesake's ufunc gives: a partial result
        # crosses the wire as its 10-byte scalar record, not a 0-d tensor
        return out.numpy()[()]
    return out


#: the operands a scalar reduction combines
_SCALARS = (np.generic, bool, int, float, complex)


def _like(value: Any, like: Any) -> Any:
    """A reduction's result in the kind the caller passed (``like``): a
    tensor for a tensor, a numpy array (or numpy scalar) for numpy, a
    Python number for a Python number; lists/tuples map elementwise."""
    if isinstance(value, (list, tuple)) and isinstance(like, (list, tuple)) \
            and len(value) == len(like):
        return type(like)(_like(v, w) for v, w in zip(value, like))
    if isinstance(like, torch.Tensor):
        return _operand(value) if isinstance(value, np.ndarray) else value
    if isinstance(value, np.generic) and isinstance(like, _SCALARS) \
            and not isinstance(like, np.generic):
        return value.item()
    if not isinstance(value, torch.Tensor):
        return value
    if isinstance(like, np.ndarray):
        return value.numpy()
    if isinstance(like, np.generic):
        return value.numpy()[()]
    if isinstance(like, (bool, int, float, complex)):
        return value.item()
    return value


def _host_array(x: Any) -> np.ndarray:
    """A host array as numpy (a CPU tensor's numpy view, no copy; a tensor
    on another device raises dss's typed error): the pipelined algorithms
    stream host bytes."""
    if isinstance(x, torch.Tensor):
        return dss.tensor_array(x)
    return np.asarray(x)


def _decoded(arr: np.ndarray) -> Any:
    """An array built here from received bytes, in the kind dss decodes
    an array record to: a CPU tensor, or numpy for a dtype torch lacks."""
    return torch.from_numpy(arr) if arr.dtype in dss._NP_TO_TORCH else arr


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(x.size)


def _ordered(op, lo_val, hi_val):
    """Combine preserving rank order: lo ⊕ hi."""
    return _combine(op, lo_val, hi_val)


# -------------------------------------------------------------- broadcast


mca_var.register(
    "host_coll_segment", 64 * 1024,
    "Segment size (bytes) of pipelined host-plane collectives (the "
    "reference's per-algorithm segsize knobs)",
    type=int,
)
mca_var.register(
    "host_reduce_algorithm", "auto",
    "Host-plane reduce algorithm: auto (binomial tree; in-order linear "
    "for non-commutative ops) or pipeline (chain-pipelined segments for "
    "large commutative array reductions)",
    enum=("auto", "pipeline"),
)
mca_var.register(
    "host_bcast_algorithm", "binomial",
    "Host-plane bcast algorithm: binomial (latency-optimal tree) or "
    "pipeline (chain-pipelined segments, bandwidth-optimal for large "
    "arrays).  Unlike MPI, non-root ranks don't pass a count here, so "
    "size-based auto-selection has no size to look at — selection is "
    "explicit, by this var or the algorithm argument",
    enum=("binomial", "pipeline"),
)


def bcast(ctx, obj: Any = None, root: int = 0,
          algorithm: str | None = None) -> Any:
    """Broadcast; ``obj`` is significant at root only; every rank
    returns the payload.

    binomial: coll_base_bcast.c:207-259 shape.  pipeline:
    coll_base_bcast.c:273 shape — the payload streams through a
    root-rotated chain in ``host_coll_segment``-byte pieces so link i
    forwards piece k while receiving piece k+1 (requires an ndarray
    payload at root; every rank must select the same algorithm)."""
    alg = algorithm or mca_var.get("host_bcast_algorithm", "binomial")
    if alg not in ("binomial", "pipeline"):
        raise errors.ArgError(
            f"unknown bcast algorithm {alg!r} (binomial|pipeline)"
        )
    if algorithm is None and alg == "binomial":
        # explicit algorithm selection — argument OR a non-default
        # host_bcast_algorithm var — outranks the topology layer
        # (forced algorithms are the user's responsibility, as in
        # tuned).  The payload is significant at root ONLY, so the
        # size-matched dynamic-rules check sees 0 bytes on every rank
        # (a root-only size would split the decision across ranks);
        # han bcast rules therefore use msg_bytes_min 0.
        han = _han_route(ctx, "bcast", None)
        if han is not None:
            return han.bcast(ctx, obj, root)
    size, rank = ctx.size, ctx.rank
    if size == 1:
        return obj
    if alg == "pipeline":
        return _bcast_pipeline(ctx, obj, root)
    tag = _next_tag(ctx, TAG_BCAST)
    vrank = (rank - root) % size
    # receive from parent (clear lowest set bit of vrank)
    if vrank != 0:
        parent = ((vrank & (vrank - 1)) + root) % size
        obj = ctx.recv(parent, tag=tag, cid=COLL_CID)
    # forward to children: set bits above the lowest set bit
    mask = 1
    while mask < size:
        if vrank & (mask - 1) == 0 and vrank | mask != vrank:
            child = vrank | mask
            if child < size:
                ctx.send(obj, (child + root) % size, tag=tag,
                         cid=COLL_CID)
        mask <<= 1
    return obj


def _bcast_pipeline(ctx, obj: Any, root: int) -> Any:
    """Chain-pipelined broadcast: root-rotated chain, segment stream.
    2(p-1)+nseg-1 message steps vs binomial's log2(p) — wins when
    nbytes/bandwidth dominates latency (large arrays over sockets)."""
    from ..pt2pt.requests import wait_all

    size, rank = ctx.size, ctx.rank
    vrank = (rank - root) % size
    succ = (rank + 1) % size
    pred = (rank - 1) % size
    tag = _next_tag(ctx, TAG_BCAST)
    last = vrank == size - 1
    if vrank == 0:
        # only the root's segment size matters: receivers take nseg from
        # the header and reassemble whatever piece sizes arrive
        seg = max(1, int(mca_var.get("host_coll_segment", 64 * 1024)))
        arr = np.ascontiguousarray(_host_array(obj))
        flat = arr.reshape(-1).view(np.uint8)
        nseg = max(1, -(-flat.size // seg))
        ctx.send((arr.dtype.str, arr.shape, nseg), succ, tag=tag,
                 cid=COLL_CID)
        # segment VIEWS: the zero-copy wire path references them as
        # out-of-band buffers; root never mutates obj mid-broadcast, and
        # the thread plane's eager/handoff copy preserves buffer reuse
        reqs = [
            ctx.isend(flat[i * seg : (i + 1) * seg], succ,
                      tag=tag, cid=COLL_CID)
            for i in range(nseg)
        ]
        wait_all(reqs)
        return obj
    dtype_str, shape, nseg = ctx.recv(pred, tag=tag, cid=COLL_CID)
    if not last:
        ctx.send((dtype_str, shape, nseg), succ, tag=tag, cid=COLL_CID)
    dt = np.dtype(dtype_str)
    # single preallocated buffer: pieces fill slices as they arrive (a
    # parts-list + concatenate would hold ~2x the payload at peak, on
    # exactly the large-array workloads this algorithm targets)
    flat = np.empty(int(np.prod(shape or (1,))) * dt.itemsize, np.uint8)
    pos, reqs = 0, []
    for _ in range(nseg):
        piece = ctx.recv(pred, tag=tag, cid=COLL_CID)
        raw = np.asarray(_host_array(piece), np.uint8).reshape(-1)
        flat[pos : pos + raw.size] = raw
        pos += raw.size
        if not last:
            # forward while the next segment is still in flight — the
            # pipeline overlap that makes the chain bandwidth-optimal
            reqs.append(ctx.isend(piece, succ, tag=tag, cid=COLL_CID))
    wait_all(reqs)
    if pos != flat.size:
        raise errors.TruncateError(
            f"pipelined bcast: got {pos}B of {flat.size}B"
        )
    return _decoded(flat.view(dt).reshape(shape))


# ----------------------------------------------------------------- reduce


def _reduce_linear(ctx, value, op, root, tag):
    """In-order linear reduce: rank order is preserved exactly, so this is
    the non-commutative path (the reference's in-order variants)."""
    size, rank = ctx.size, ctx.rank
    if rank != root:
        ctx.send(value, root, tag=tag, cid=COLL_CID)
        return None
    acc = None
    for r in range(size):
        contrib = value if r == root else ctx.recv(r, tag=tag, cid=COLL_CID)
        acc = contrib if acc is None else _ordered(op, acc, contrib)
    return acc


def _reduce_pipeline(ctx, value, op, root: int):
    """Chain-pipelined reduce (coll_base_reduce.c:409 pipeline shape):
    segments flow down a root-rotated chain, each hop combining its own
    slice before forwarding — bandwidth-optimal for large arrays.
    Chain combine order is vrank-descending onto ascending, which only
    equals rank order for commutative ops; callers route non-commutative
    ops to the in-order variants."""
    from ..pt2pt.requests import wait_all

    size, rank = ctx.size, ctx.rank
    vrank = (rank - root) % size
    # chain orientation: segments flow from the far end (vrank size-1)
    # toward the root (vrank 0)
    toward_root = (rank - 1) % size
    away = (rank + 1) % size
    tag = _next_tag(ctx, TAG_REDUCE)
    arr = np.ascontiguousarray(_host_array(value))
    flat = arr.reshape(-1)
    if vrank == size - 1:
        # the stream originator decides the geometry and announces it in
        # a header (the bcast-pipeline discipline): per-rank
        # host_coll_segment or dtype skew must not desynchronize the
        # chain's message counts
        seg = max(1, int(mca_var.get("host_coll_segment", 64 * 1024)))
        elems = max(1, -(-seg // max(arr.dtype.itemsize, 1)))
        nseg = max(1, -(-flat.size // elems))
        ctx.send(("hdr", arr.dtype.str, arr.shape, nseg, elems),
                 toward_root, tag=tag, cid=COLL_CID)
        # segment views (see _bcast_pipeline): the originator only reads
        # flat until wait_all returns, so the per-segment copy was waste
        reqs = [
            ctx.isend(flat[i * elems : (i + 1) * elems],
                      toward_root, tag=tag, cid=COLL_CID)
            for i in range(nseg)
        ]
        wait_all(reqs)
        return None
    header = ctx.recv(away, tag=tag, cid=COLL_CID)
    if header[0] == "err":
        # upstream congruence failure: poison the rest of the chain so
        # every downstream rank raises instead of blocking on segments
        # that will never come
        if vrank != 0:
            ctx.send(header, toward_root, tag=tag, cid=COLL_CID)
        raise errors.TypeError_(f"pipelined reduce: {header[1]}")
    _hdr, dtype_str, shape, nseg, elems = header
    if tuple(shape) != arr.shape or np.dtype(dtype_str) != arr.dtype:
        reason = (
            f"payload mismatch — local {arr.shape}/{arr.dtype} vs chain "
            f"{tuple(shape)}/{dtype_str} (reduce requires congruent "
            "arrays on every rank)"
        )
        if vrank != 0:
            ctx.send(("err", reason), toward_root, tag=tag, cid=COLL_CID)
        # NOTE: ranks upstream of this one (toward the originator) may
        # still block in their segment sends until timeout — an
        # erroneous program; the err header bounds the damage downstream
        raise errors.TypeError_(f"pipelined reduce: {reason}")
    if vrank != 0:
        ctx.send(header, toward_root, tag=tag, cid=COLL_CID)
    # only the root materializes a result buffer; intermediates forward
    out = np.empty_like(flat) if vrank == 0 else None
    reqs = []
    for i in range(nseg):
        sl = slice(i * elems, (i + 1) * elems)
        contrib = ctx.recv(away, tag=tag, cid=COLL_CID)
        # combine own slice with the accumulated higher-vrank slice,
        # keeping the lower contribution on the left
        merged = _combine(op, flat[sl], contrib)
        if vrank == 0:
            out[sl] = _host_array(merged)
        else:
            reqs.append(ctx.isend(merged, toward_root, tag=tag,
                                  cid=COLL_CID))
    wait_all(reqs)
    if vrank != 0:
        return None
    return out.reshape(arr.shape)


def reduce(ctx, value: Any, op, root: int = 0,
           algorithm: str | None = None) -> Any:
    """Reduce to root; binomial tree for commutative ops, in-order linear
    otherwise; ``algorithm="pipeline"`` selects the chain-pipelined
    large-array variant (commutative ops + host array payloads).  Result
    significant at root (others return None), in the caller's kind."""
    out = _reduce(ctx, value, op, root, algorithm)
    return None if out is None else _like(out, value)


def _reduce(ctx, value: Any, op, root: int, algorithm: str | None) -> Any:
    size, rank = ctx.size, ctx.rank
    alg = algorithm or mca_var.get("host_reduce_algorithm", "auto")
    if alg not in ("auto", "pipeline"):
        raise errors.ArgError(
            f"unknown reduce algorithm {alg!r} (auto|pipeline)"
        )
    if algorithm is None and alg == "auto":
        # tuned-table consult first (see allreduce): an explicit rule
        # outranks the auto han decision; explicit user/var algorithm
        # selection above outranks BOTH
        ruled = _rule_alg(ctx, "reduce", value)
        if ruled == "pipeline":
            if getattr(op, "commute", True):
                alg = "pipeline"
            else:
                mca_output.verbose(
                    2, _stream,
                    "tuned rule names pipeline reduce but the op is "
                    "non-commutative (chain order != rank order); "
                    "builtin decision applies",
                )
                ruled = None
        if ruled is None:
            han = _han_route(ctx, "reduce", value, op)
            if han is not None:
                return han.reduce(ctx, value, op, root)
    if size == 1:
        return value
    if alg == "pipeline":
        if not getattr(op, "commute", True):
            raise errors.ArgError(
                "pipeline reduce requires a commutative op (chain order "
                "!= rank order); use the default in-order path"
            )
        return _reduce_pipeline(ctx, value, op, root)
    tag = _next_tag(ctx, TAG_REDUCE)
    if not getattr(op, "commute", True):
        return _reduce_linear(ctx, value, op, root, tag)
    vrank = (rank - root) % size
    acc = value
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + root) % size
            ctx.send((vrank, acc), parent, tag=tag, cid=COLL_CID)
            return None
        child = vrank | mask
        if child < size:
            cvrank, contrib = ctx.recv(
                (child + root) % size, tag=tag, cid=COLL_CID
            )
            # child subtree covers higher vranks: acc ⊕ contrib
            acc = _ordered(op, acc, contrib)
        mask <<= 1
    return acc


# -------------------------------------------------------------- allreduce


def _allreduce_ring(ctx, value: Any, op, tag: int) -> torch.Tensor:
    """Ring allreduce (reduce-scatter + allgather,
    coll_base_allreduce.c:341 shape): 2(p-1) steps moving ~2·nbytes/p per
    step — the bandwidth-optimal choice for large arrays on a wire.
    Commutative ops only (ring combine order is ring order, not rank
    order); the caller guards.  Runs in torch on the operand's device;
    the chunk bounds are the namesake's (``np.linspace``), so a mixed
    universe cuts the array identically on every rank."""
    size, rank = ctx.size, ctx.rank
    t = _operand(value)
    flat = t.contiguous().reshape(-1)
    bounds = np.linspace(0, flat.numel(), size + 1).astype(np.int64)
    # chunk VIEWS, not copies: the wire plane ships contiguous slices as
    # out-of-band segments (dss.pack_frames) and the combine below
    # rebinds list entries with fresh op() results — EXCEPT this rank's
    # own chunk, the only entry still aliasing the caller's buffer when
    # sent (the thread plane parks rendezvous payloads by reference past
    # sendrecv's return, so an aliased chunk could see a post-collective
    # caller mutation); one 1/p-sized copy keeps that contract
    chunks = [flat[int(bounds[i]):int(bounds[i + 1])] for i in range(size)]
    chunks[rank] = chunks[rank].clone()
    right, left = (rank + 1) % size, (rank - 1) % size
    # reduce-scatter phase: after p-1 steps, chunk (rank+1)%size is done
    for step in range(size - 1):
        send_idx = (rank - step) % size
        recv_idx = (rank - step - 1) % size
        got = ctx.sendrecv(
            chunks[send_idx], right, source=left,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        )
        chunks[recv_idx] = op(_operand(got), chunks[recv_idx])
    # allgather phase: circulate the finished chunks
    for step in range(size - 1):
        send_idx = (rank + 1 - step) % size
        recv_idx = (rank - step) % size
        chunks[recv_idx] = _operand(ctx.sendrecv(
            chunks[send_idx], right, source=left,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        ))
    return torch.cat(chunks).reshape(t.shape).to(t.dtype)


def allreduce(ctx, value: Any, op) -> Any:
    """Allreduce with host-plane algorithm selection — recursive doubling
    with the non-power-of-two pre/post fold (coll_base_allreduce.c:130-225
    shape) for latency-bound payloads, ring reduce-scatter+allgather above
    ``host_coll_large_msg`` for large commutative array payloads (numpy
    arrays and tensors).  In-order combines keep non-commutative ops
    correct on the doubling path.  Returns the caller's kind."""
    return _like(_allreduce(ctx, value, op), value)


def _allreduce(ctx, value: Any, op) -> Any:
    size, rank = ctx.size, ctx.rank
    if size == 1:
        return value
    # tuned-table consult first: an explicit per-cell rule outranks the
    # auto han decision AND the builtin size thresholds (the reference's
    # dynamic-rules precedence); "han" rules still route below
    ruled = _rule_alg(ctx, "allreduce", value)
    if ruled is None:
        han = _han_route(ctx, "allreduce", value, op)
        if han is not None:
            return han.allreduce(ctx, value, op)
    tag = _next_tag(ctx, TAG_ALLREDUCE)
    large = int(mca_var.get("host_coll_large_msg", 256 * 1024))
    ring_eligible = (
        size > 2
        and isinstance(value, (np.ndarray, torch.Tensor))
        and _numel(value) >= size
        and getattr(op, "commute", False)
    )
    if ruled == "ring" and not ring_eligible:
        mca_output.verbose(
            2, _stream,
            "tuned rule names ring allreduce but the call is ineligible "
            "(need > 2 ranks, commutative op, array with >= %d "
            "elements); builtin decision applies", size,
        )
        ruled = None
    if ruled == "ring" or (
        ruled is None and ring_eligible and value.nbytes >= large
    ):
        return _allreduce_ring(ctx, value, op, tag)
    pof2 = 1
    while pof2 * 2 <= size:
        pof2 *= 2
    rem = size - pof2
    acc = value
    # fold phase: the first 2*rem ranks pair up; odd member carries on
    if rank < 2 * rem:
        if rank % 2 == 0:
            ctx.send(acc, rank + 1, tag=tag, cid=COLL_CID)
            newrank = -1
        else:
            other = ctx.recv(rank - 1, tag=tag, cid=COLL_CID)
            acc = _ordered(op, other, acc)  # lower rank's operand left
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank >= 0:
        mask = 1
        while mask < pof2:
            pnew = newrank ^ mask
            partner = pnew * 2 + 1 if pnew < rem else pnew + rem
            other = ctx.sendrecv(
                acc, partner, source=partner,
                sendtag=tag, recvtag=tag, cid=COLL_CID,
            )
            if partner < rank:
                acc = _ordered(op, other, acc)
            else:
                acc = _ordered(op, acc, other)
            mask <<= 1
    # unfold: odd members hand the result back to their even partner
    if rank < 2 * rem:
        if rank % 2 == 0:
            acc = ctx.recv(rank + 1, tag=tag, cid=COLL_CID)
        else:
            ctx.send(acc, rank - 1, tag=tag, cid=COLL_CID)
    return acc


# -------------------------------------------------------------- allgather


def allgather(ctx, value: Any) -> list:
    """Ring allgather (coll_base_allgather.c ring): p-1 steps, each rank
    forwards the block it just received.  Returns the rank-indexed list."""
    size, rank = ctx.size, ctx.rank
    if size == 1:
        return [value]
    # size-matched rules see 0 bytes here: allgather payloads need not
    # be congruent across ranks (arbitrary per-rank objects), so a
    # local size would split the han/flat decision and deadlock —
    # allgather han rules therefore use msg_bytes_min 0 (the bcast
    # discipline; reduce/allreduce payloads ARE congruent by contract)
    han = _han_route(ctx, "allgather", None)
    if han is not None:
        return han.allgather(ctx, value)
    out: list = [None] * size
    out[rank] = value
    tag = _next_tag(ctx, TAG_ALLGATHER)
    right = (rank + 1) % size
    left = (rank - 1) % size
    blk_idx, blk = rank, value
    for _ in range(size - 1):
        recv_idx, recv_blk = ctx.sendrecv(
            (blk_idx, blk), right, source=left,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        )
        out[recv_idx] = recv_blk
        blk_idx, blk = recv_idx, recv_blk
    return out


# --------------------------------------------------------- gather/scatter


def gather(ctx, value: Any, root: int = 0) -> list | None:
    """Linear gather (coll_base_gather.c basic_linear): rank-indexed list
    at root, None elsewhere."""
    size, rank = ctx.size, ctx.rank
    tag = _next_tag(ctx, TAG_GATHER)
    if rank != root:
        ctx.send(value, root, tag=tag, cid=COLL_CID)
        return None
    out = [None] * size
    out[root] = value
    for r in range(size):
        if r != root:
            out[r] = ctx.recv(r, tag=tag, cid=COLL_CID)
    return out


def scatter(ctx, values: list | None = None, root: int = 0) -> Any:
    """Linear scatter from root; ``values`` (rank-indexed, significant at
    root) must have one entry per rank.  Returns this rank's block."""
    size, rank = ctx.size, ctx.rank
    tag = _next_tag(ctx, TAG_SCATTER)
    if rank == root:
        if values is None or len(values) != size:
            raise errors.ArgError(
                f"scatter root needs {size} blocks, got "
                f"{'None' if values is None else len(values)}"
            )
        for r in range(size):
            if r != root:
                ctx.send(values[r], r, tag=tag, cid=COLL_CID)
        return values[root]
    return ctx.recv(root, tag=tag, cid=COLL_CID)


# --------------------------------------------------------------- alltoall


def _alltoall_bruck(ctx, blocks: list, tag: int) -> list:
    """Bruck alltoall (coll_base_alltoall.c:191 shape): local rotation,
    then ceil(log2(p)) store-and-forward rounds — round k ships every
    slot whose index has bit k set to rank+k — then an inverse rotation.
    O(log p) messages per rank against pairwise's O(p), each carrying up
    to half the slots: the latency-bound regime's trade, and the leader
    exchange coll/han's alltoall family uses above a leader-count bar."""
    size, rank = ctx.size, ctx.rank
    tmp = [blocks[(rank + i) % size] for i in range(size)]
    k = 1
    while k < size:
        idxs = [i for i in range(size) if i & k]
        got = ctx.sendrecv(
            [tmp[i] for i in idxs], (rank + k) % size,
            source=(rank - k) % size, sendtag=tag, recvtag=tag,
            cid=COLL_CID,
        )
        for i, blk in zip(idxs, got):
            tmp[i] = blk
        k <<= 1
    return [tmp[(rank - src) % size] for src in range(size)]


def alltoall(ctx, values: list) -> list:
    """Pairwise-exchange alltoall (coll_base_alltoall.c:383-444 shape):
    p-1 rounds, round i exchanges with rank±i.  ``values`` is the
    rank-indexed send list; returns the rank-indexed receive list.
    A tuned rule may pin "bruck" (log-round store-and-forward) or "han"
    (hierarchical two-level schedule) instead."""
    size, rank = ctx.size, ctx.rank
    if len(values) != size:
        raise errors.ArgError(f"alltoall needs {size} blocks")
    # Payloads are per-rank send lists — never congruent across ranks —
    # so the size-matched dynamic-rules consult sees 0 bytes everywhere
    # (the bcast discipline): alltoall rules use msg_bytes_min 0.  An
    # explicit flat rule outranks the auto han decision (the reference's
    # dynamic-rules precedence, same as allreduce/reduce above).
    ruled = _rule_alg(ctx, "alltoall", None)
    if ruled is None:
        han = _han_route(ctx, "alltoall", None)
        if han is not None:
            return han.alltoall(ctx, values)
    if size == 1:
        return [values[0]]
    tag = _next_tag(ctx, TAG_ALLTOALL)
    if ruled == "bruck":
        return _alltoall_bruck(ctx, list(values), tag)
    out: list = [None] * size
    out[rank] = values[rank]
    for i in range(1, size):
        sendto = (rank + i) % size
        recvfrom = (rank - i) % size
        out[recvfrom] = ctx.sendrecv(
            values[sendto], sendto, source=recvfrom,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        )
    return out


# ------------------------------------------------------- v-variants
# Variable-count collectives (coll_base_allgatherv.c:93,
# coll_base_alltoallv.c:125 shapes).  The host plane carries arbitrary
# objects, so blocks may differ per rank freely; the *v surface exists so
# MPI-shaped programs (flat buffer + counts/displacements) port directly.


def _displs_from(counts):
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += c
    return out


def _blocks_from(sendbuf, counts, displs, size):
    """Slice a flat buffer into per-rank blocks by (counts, displs) — the
    shared *v decomposition (displacements default to the running sum)."""
    if len(counts) != size:
        raise errors.ArgError(f"v-collective needs {size} counts")
    displs = _displs_from(counts) if displs is None else displs
    if len(displs) != size:
        raise errors.ArgError(f"v-collective needs {size} displacements")
    return [sendbuf[displs[r] : displs[r] + counts[r]] for r in range(size)]


def gatherv(ctx, value: Any, root: int = 0) -> list | None:
    """Linear gatherv: per-rank variable-size blocks, rank-indexed list at
    root (object payloads carry their own size — MPI's recvcounts are
    implicit)."""
    size, rank = ctx.size, ctx.rank
    tag = _next_tag(ctx, TAG_GATHERV)
    if rank != root:
        ctx.send(value, root, tag=tag, cid=COLL_CID)
        return None
    out = [None] * size
    out[root] = value
    for r in range(size):
        if r != root:
            out[r] = ctx.recv(r, tag=tag, cid=COLL_CID)
    return out


def scatterv(ctx, sendbuf=None, counts: list | None = None,
             displs: list | None = None, root: int = 0):
    """Linear scatterv: root slices a flat buffer by (counts, displs) —
    the MPI signature — and ships each rank its block."""
    size, rank = ctx.size, ctx.rank
    tag = _next_tag(ctx, TAG_SCATTERV)
    if rank == root:
        if sendbuf is None or counts is None:
            raise errors.ArgError(
                f"scatterv root needs a buffer and {size} counts"
            )
        blocks = _blocks_from(sendbuf, counts, displs, size)
        for r in range(size):
            if r != root:
                ctx.send(blocks[r], r, tag=tag, cid=COLL_CID)
        return blocks[root]
    return ctx.recv(root, tag=tag, cid=COLL_CID)


def allgatherv(ctx, value: Any) -> list:
    """Ring allgatherv (coll_base_allgatherv.c ring): identical schedule
    to allgather — blocks ride with their sizes, so no recvcounts
    negotiation round is needed."""
    size, rank = ctx.size, ctx.rank
    out: list = [None] * size
    out[rank] = value
    if size == 1:
        return out
    tag = _next_tag(ctx, TAG_ALLGATHERV)
    right = (rank + 1) % size
    left = (rank - 1) % size
    blk_idx, blk = rank, value
    for _ in range(size - 1):
        recv_idx, recv_blk = ctx.sendrecv(
            (blk_idx, blk), right, source=left,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        )
        out[recv_idx] = recv_blk
        blk_idx, blk = recv_idx, recv_blk
    return out


def alltoallv(ctx, sendbuf, counts: list, displs: list | None = None
              ) -> list:
    """Pairwise-exchange alltoallv (coll_base_alltoallv.c:125 shape):
    `sendbuf` is flat, `counts[r]` elements go to rank r (displacements
    default to the running sum).  Returns the rank-indexed list of
    received blocks."""
    size, rank = ctx.size, ctx.rank
    blocks = _blocks_from(sendbuf, counts, displs, size)
    # same non-congruent-payload discipline as alltoall above:
    # alltoallv rules match with msg_bytes_min 0, and an explicit flat
    # rule outranks the auto han decision
    ruled = _rule_alg(ctx, "alltoallv", None)
    if ruled is None:
        han = _han_route(ctx, "alltoallv", None)
        if han is not None:
            return han.alltoallv(ctx, sendbuf, counts, displs)
    tag = _next_tag(ctx, TAG_ALLTOALLV)
    out: list = [None] * size
    out[rank] = blocks[rank]
    for i in range(1, size):
        sendto = (rank + i) % size
        recvfrom = (rank - i) % size
        out[recvfrom] = ctx.sendrecv(
            blocks[sendto], sendto, source=recvfrom,
            sendtag=tag, recvtag=tag, cid=COLL_CID,
        )
    return out


# ------------------------------------------------------------ scan/exscan


def scan(ctx, value: Any, op) -> Any:
    """Inclusive prefix reduction, linear chain (coll_base_scan shape):
    rank r returns buf_0 ⊕ ... ⊕ buf_r."""
    rank = ctx.rank
    tag = _next_tag(ctx, TAG_SCAN)
    acc = value
    if rank > 0:
        prev = ctx.recv(rank - 1, tag=tag, cid=COLL_CID)
        acc = _ordered(op, prev, acc)
    if rank + 1 < ctx.size:
        ctx.send(acc, rank + 1, tag=tag, cid=COLL_CID)
    return _like(acc, value)


def exscan(ctx, value: Any, op) -> Any:
    """Exclusive prefix reduction: rank r returns buf_0 ⊕ ... ⊕ buf_{r-1};
    rank 0's result is undefined (None)."""
    rank = ctx.rank
    tag = _next_tag(ctx, TAG_SCAN)
    prev = None
    if rank > 0:
        prev = ctx.recv(rank - 1, tag=tag, cid=COLL_CID)
    if rank + 1 < ctx.size:
        mine = value if prev is None else _ordered(op, prev, value)
        ctx.send(mine, rank + 1, tag=tag, cid=COLL_CID)
    return None if prev is None else _like(prev, value)


# ---------------------------------------------------------- reduce_scatter


def reduce_scatter(ctx, values: list, op) -> Any:
    """Blockwise reduce + scatter (coll_base_reduce_scatter.c
    non-overlapping shape): ``values`` is the rank-indexed list of blocks;
    rank r returns the fully-reduced block r, in the kind of the caller's
    block r."""
    size = ctx.size
    if len(values) != size:
        raise errors.ArgError(f"reduce_scatter needs {size} blocks")
    han = _han_route(ctx, "reduce_scatter", values, op)
    if han is not None:
        return han.reduce_scatter(ctx, values, op)
    reduced = reduce(ctx, values, op, root=0, algorithm="auto")
    return _like(scatter(ctx, reduced, root=0), values[ctx.rank])


class HostCollectives:
    """Mixin giving any send/recv endpoint the collective API (the
    mca_coll_base_comm_select analog for host endpoints: one composed
    table, methods delegate to the module algorithms)."""

    def bcast(self, obj: Any = None, root: int = 0,
              algorithm: str | None = None) -> Any:
        return bcast(self, obj, root, algorithm)

    def reduce(self, value: Any, op, root: int = 0,
               algorithm: str | None = None) -> Any:
        return reduce(self, value, op, root, algorithm)

    def allreduce(self, value: Any, op) -> Any:
        return allreduce(self, value, op)

    def allgather(self, value: Any) -> list:
        return allgather(self, value)

    def gather(self, value: Any, root: int = 0):
        return gather(self, value, root)

    def scatter(self, values: list | None = None, root: int = 0) -> Any:
        return scatter(self, values, root)

    def alltoall(self, values: list) -> list:
        return alltoall(self, values)

    def scan(self, value: Any, op) -> Any:
        return scan(self, value, op)

    def exscan(self, value: Any, op) -> Any:
        return exscan(self, value, op)

    def reduce_scatter(self, values: list, op) -> Any:
        return reduce_scatter(self, values, op)

    def gatherv(self, value: Any, root: int = 0):
        return gatherv(self, value, root)

    def scatterv(self, sendbuf=None, counts: list | None = None,
                 displs: list | None = None, root: int = 0):
        return scatterv(self, sendbuf, counts, displs, root)

    def allgatherv(self, value: Any) -> list:
        return allgatherv(self, value)

    def alltoallv(self, sendbuf, counts: list,
                  displs: list | None = None) -> list:
        return alltoallv(self, sendbuf, counts, displs)
