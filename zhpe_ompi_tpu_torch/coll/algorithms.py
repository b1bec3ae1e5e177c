"""Collective algorithm library (namesake: ``zhpe_ompi_tpu/coll/algorithms.py``).

The reference's ``ompi/mca/coll/base`` algorithms (SURVEY.md §2.4) as
static schedules of point-to-point rounds over :mod:`..pt2pt.spmd`: each
round is one batched permute, as each is one ``collective_permute`` in the
JAX package.  Every function keeps its namesake's name, pattern and
reduction order, so results are equal on every rank, including the
partial values a rooted reduce or gather leaves on non-root ranks.

Conventions:

- all functions take ``(comm, x, ...)`` and are called by every rank of
  ``comm`` in the same order (SPMD collective semantics);
- ``comm.rank`` is a plain int here, so the JAX package's ``jnp.where``
  masks on the traced rank are Python branches;
- ``x`` may be a tuple of tensors for the mask-based algorithms
  (MINLOC/MAXLOC ``(values, indices)`` pairs); chunked algorithms (ring,
  Bruck, pairwise) require a single dense tensor;
- inputs are never written: an algorithm that updates a buffer works on
  its own copy.
"""

from __future__ import annotations

import math

import torch

from ..core import errors
from ..pt2pt import spmd


def _tmap(fn, *trees):
    """Apply ``fn`` leafwise over tensors or tuples of tensors."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tmap(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _ring(m):
    return [(i, (i + 1) % m) for i in range(m)]


def _pad_rows(t, rows: int):
    """``t`` with ``rows`` zero rows appended on dim 0."""
    if rows <= 0:
        return t
    return torch.cat([t, t.new_zeros((rows,) + tuple(t.shape[1:]))])


def _chunked(x, n):
    """A padded (n, chunk) copy of a dense tensor, and its length."""
    flat = x.reshape(-1)
    length = flat.shape[0]
    chunk = -(-length // n)  # ceil
    return _pad_rows(flat, n * chunk - length).reshape(n, chunk).clone(), length


def _segments(x, segments):
    """Pad-and-view a dense tensor as ``segments`` equal flat pieces."""
    flat = x.reshape(-1)
    length = flat.shape[0]
    seg = -(-length // segments)
    return _pad_rows(flat, segments * seg - length), seg, length


# ---------------------------------------------------------------------------
# Allreduce (cf. coll_base_allreduce.c)
# ---------------------------------------------------------------------------


def allreduce_recursive_doubling(comm, x, op):
    """Recursive doubling (reference: coll_base_allreduce.c:130): log2(p)
    exchange rounds; non-power-of-two handled by folding the tail into the
    leading block first (the reference's pow2 adjust at :175-185)."""
    n = comm.size
    if n == 1:
        return x
    rank = comm.rank
    p2 = _pow2_floor(n)
    extra = n - p2
    if extra:
        recv = spmd.ppermute(comm, x, [(p2 + i, i) for i in range(extra)])
        if rank < extra:
            x = op(recv, x)
    k = 1
    while k < p2:
        recv = spmd.ppermute(comm, x, [(i, i ^ k) for i in range(p2)])
        if rank < p2:
            x = op(recv, x)
        k <<= 1
    if extra:
        recv = spmd.ppermute(comm, x, [(i, p2 + i) for i in range(extra)])
        if rank >= p2:
            x = recv
    return x


def allreduce_ring(comm, x, op):
    """Ring allreduce: reduce-scatter ring + allgather ring (reference:
    coll_base_allreduce.c:341).  Bandwidth-optimal — 2(p-1)/p of the data
    crosses each link."""
    n = comm.size
    if n == 1:
        return x
    if not isinstance(x, torch.Tensor):
        raise errors.ArgError("ring allreduce requires a dense tensor")
    rank = comm.rank
    buf, length = _chunked(x, n)
    for k in range(n - 1):
        send_idx = (rank - k) % n
        recv_idx = (rank - k - 1) % n
        sent = spmd.ppermute(comm, buf[send_idx], _ring)
        buf[recv_idx] = op(sent, buf[recv_idx])
    for k in range(n - 1):
        send_idx = (rank + 1 - k) % n
        recv_idx = (rank - k) % n
        buf[recv_idx] = spmd.ppermute(comm, buf[send_idx], _ring)
    return buf.reshape(-1)[:length].reshape(x.shape)


def allreduce_rabenseifner(comm, x, op):
    """Rabenseifner: recursive-halving reduce-scatter + recursive-doubling
    allgather (reference: coll_base_allreduce.c:970).  Power-of-two ranks;
    falls back to ring otherwise."""
    n = comm.size
    if n & (n - 1):
        return allreduce_ring(comm, x, op)
    if n == 1:
        return x
    rank = comm.rank
    buf, length = _chunked(x, n)

    # reduce-scatter by recursive halving; rank ends owning chunk `rank`
    lo = 0
    bit = n >> 1
    while bit:
        pairs = [(i, i ^ bit) for i in range(n)]
        on_upper = (rank & bit) != 0
        send_lo = lo if on_upper else lo + bit  # give away the other half
        keep_lo = lo + bit if on_upper else lo
        sent = spmd.ppermute(comm, buf[send_lo:send_lo + bit], pairs)
        buf[keep_lo:keep_lo + bit] = op(sent, buf[keep_lo:keep_lo + bit])
        lo = keep_lo
        bit >>= 1

    # allgather by recursive doubling
    w = 1
    while w < n:
        pairs = [(i, i ^ w) for i in range(n)]
        my_lo = rank & ~(w - 1)
        partner_lo = (rank ^ w) & ~(w - 1)
        sent = spmd.ppermute(comm, buf[my_lo:my_lo + w], pairs)
        buf[partner_lo:partner_lo + w] = sent
        w <<= 1
    return buf.reshape(-1)[:length].reshape(x.shape)


def allreduce_nonoverlapping(comm, x, op):
    """Reduce-then-bcast (reference: coll_base_allreduce.c:54)."""
    if comm.size == 1:
        return x
    reduced = reduce_binomial(comm, x, op, root=0)
    return bcast_binomial(comm, reduced, root=0)


def allreduce_segmented_ring(comm, x, op, segments: int = 4):
    """Segmented ring (reference: coll_base_allreduce.c:618 with its
    ``segment_size`` knob): the message is cut into independent segments,
    each running its own ring."""
    n = comm.size
    if n == 1:
        return x
    length = x.numel()
    segments = max(1, min(segments, max(1, length // n)))
    flat, seg, length = _segments(x, segments)
    parts = [allreduce_ring(comm, flat[i * seg:(i + 1) * seg], op)
             for i in range(segments)]
    return torch.cat(parts)[:length].reshape(x.shape)


def allreduce_linear(comm, x, op):
    """Basic linear (reference: coll_base_allreduce.c:881): gather everything
    everywhere, reduce locally in strict rank order — the only algorithm
    whose reduction order matches MPI's canonical order for non-commutative
    ops (rank 0's value ⊕ rank 1's ⊕ ...)."""
    n = comm.size
    if n == 1:
        return x
    # every rank's contribution stacked: leaf shape (n, *leaf.shape)
    gathered = _tmap(lambda a: allgather_ring(comm, a[None]), x)
    acc = _tmap(lambda g: g[0], gathered)
    for i in range(1, n):
        acc = op(acc, _tmap(lambda g, i=i: g[i], gathered))
    return _tmap(lambda o, xx: o.reshape(xx.shape), acc, x)


# ---------------------------------------------------------------------------
# Bcast (cf. coll_base_bcast.c)
# ---------------------------------------------------------------------------


def bcast_binomial(comm, x, root=0):
    """Binomial tree (reference: coll_base_bcast.c:329): round k, virtual
    ranks < 2^k forward to vrank+2^k."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    k = 1
    while k < n:
        pairs = [((v + root) % n, (v + k + root) % n)
                 for v in range(min(k, n - k))]
        recv = spmd.ppermute(comm, x, pairs)
        if k <= vrank < 2 * k:
            x = recv
        k <<= 1
    return x


def bcast_chain(comm, x, root=0, segments: int = 4):
    """Chain/pipeline bcast (reference: coll_base_bcast.c:273,301): the
    message is cut into segments flowing down a rank chain; segment s
    reaches chain position v at step v-1+s."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    segments = max(1, min(segments, x.numel()))
    flat, seg, length = _segments(x, segments)
    segs = flat.reshape(segments, seg).clone()
    pairs = [((v + root) % n, (v + 1 + root) % n) for v in range(n - 1)]
    for t in range((n - 1) + (segments - 1)):
        sent = spmd.ppermute(comm, segs, pairs)
        s_idx = t - vrank + 1
        if vrank > 0 and 0 <= s_idx < segments:
            segs[s_idx] = sent[s_idx]
    return segs.reshape(-1)[:length].reshape(x.shape)


def bcast_linear(comm, x, root=0):
    """Basic linear bcast (reference: coll_base_bcast.c:624): root sends the
    whole message to each rank individually, one permute per rank."""
    n = comm.size
    if n == 1:
        return x
    out = x
    for i in range(n):
        if i == root:
            continue
        got = spmd.ppermute(comm, x, [(root, i)])
        if comm.rank == i:
            out = got
    return out


def bcast_binary(comm, x, root=0):
    """Binary-tree bcast (reference: coll_base_bcast.c:245): complete binary
    tree in virtual-rank space (vrank v forwards to 2v+1 and 2v+2), one
    permute per child side per level."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    depth = 0
    x_have = x
    while (1 << depth) - 1 < n:
        lo, hi = (1 << depth) - 1, min((1 << (depth + 1)) - 1, n)
        any_pairs = False
        for side in (1, 2):
            pairs = [((v + root) % n, (2 * v + side + root) % n)
                     for v in range(lo, hi) if 2 * v + side < n]
            if not pairs:
                continue
            any_pairs = True
            recv = spmd.ppermute(comm, x_have, pairs)
            parent = (vrank - side) // 2
            if (vrank - side) % 2 == 0 and lo <= parent < hi and vrank >= side:
                x_have = recv
        if not any_pairs:
            break
        depth += 1
    return x_have


def bcast_pipeline(comm, x, root=0, segments: int = 8):
    """Pipelined single-chain bcast (reference: coll_base_bcast.c:273 — the
    chain algorithm with fanout 1)."""
    return bcast_chain(comm, x, root=root, segments=segments)


def bcast_split_binary(comm, x, root=0):
    """Split-binary bcast (reference: coll_base_bcast.c:357): the message is
    split in two halves broadcast down a binomial and a binary tree."""
    if comm.size == 1:
        return x
    flat = x.reshape(-1)
    length = flat.shape[0]
    if length < 2:
        return bcast_binomial(comm, x, root)
    half = length // 2
    a = bcast_binomial(comm, flat[:half], root)
    b = bcast_binary(comm, flat[half:], root)
    return torch.cat([a, b]).reshape(x.shape)


def bcast_knomial(comm, x, root=0, radix: int = 4):
    """K-nomial tree bcast (reference: coll_base_bcast.c:714): round d, every
    vrank that is a multiple of radix^(d+1) sends to vrank + j*radix^d for
    j in 1..radix-1, one permute per child arm."""
    n = comm.size
    if n == 1:
        return x
    if radix < 2:
        raise errors.ArgError(f"knomial radix must be >= 2, got {radix}")
    vrank = (comm.rank - root) % n
    strides = []
    s = 1
    while s < n:
        strides.append(s)
        s *= radix
    for stride in reversed(strides):
        for j in range(1, radix):
            pairs = [((v + root) % n, (v + j * stride + root) % n)
                     for v in range(0, n, stride * radix)
                     if v + j * stride < n]
            if not pairs:
                continue
            recv = spmd.ppermute(comm, x, pairs)
            if vrank % (stride * radix) == j * stride:
                x = recv
    return x


def bcast_scatter_allgather(comm, x, root=0):
    """Scatter + allgather bcast (reference: coll_base_bcast.c
    scatter_allgather): linear scatter of chunks then ring allgather."""
    if comm.size == 1:
        return x
    own = scatter_linear(comm, x, root)
    gathered = allgather_ring(comm, own)
    return gathered.reshape(-1)[:x.numel()].reshape(x.shape)


# ---------------------------------------------------------------------------
# Reduce (cf. coll_base_reduce.c)
# ---------------------------------------------------------------------------


def reduce_binomial(comm, x, op, root=0):
    """Binomial-tree reduce (reference: coll_base_reduce.c:471).  Result is
    significant at root (other ranks hold partials)."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    k = 1
    while k < n:
        pairs = [((v + k + root) % n, (v + root) % n)
                 for v in range(0, n - k, 2 * k)]
        recv = spmd.ppermute(comm, x, pairs)
        # op(x, recv): x holds [v, v+k), recv holds [v+k, v+2k) — keeps
        # the tree's reduction in ascending vrank order
        if vrank % (2 * k) == 0 and vrank + k < n:
            x = op(x, recv)
        k <<= 1
    return x


def reduce_linear(comm, x, op, root=0):
    """Linear reduce preserving strict rank order for non-commutative ops;
    every rank computes the rank-ordered result."""
    return allreduce_linear(comm, x, op)


def reduce_chain(comm, x, op, root=0, segments: int = 4):
    """Chain/pipelined reduce (reference: coll_base_reduce.c:379 chain, :409
    pipeline): partial sums flow down a single chain toward root, segment
    by segment."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    segments = max(1, min(segments, x.numel()))
    flat, seg, length = _segments(x, segments)
    # chain toward root in vrank space: v -> v-1, accumulated at each hop
    pairs = [((v + root) % n, (v - 1 + root) % n) for v in range(1, n)]

    def one_segment(acc):
        for t in range(n - 1):
            recv = spmd.ppermute(comm, acc, pairs)
            # at hop t, vrank n-2-t absorbs the partial from vrank n-1-t;
            # op(acc, recv) keeps MPI's rank order x_v ⊕ (x_{v+1} ⊕ ...)
            if vrank == n - 2 - t:
                acc = op(acc, recv)
        return acc

    parts = [one_segment(flat[i * seg:(i + 1) * seg]) for i in range(segments)]
    return torch.cat(parts)[:length].reshape(x.shape)


def reduce_pipeline(comm, x, op, root=0, segments: int = 8):
    """Pipelined reduce (reference: coll_base_reduce.c:409): the chain
    algorithm at higher segment count."""
    return reduce_chain(comm, x, op, root=root, segments=segments)


def reduce_binary(comm, x, op, root=0):
    """Binary-tree reduce (reference: coll_base_reduce.c:440): leaves send
    up a complete binary tree, interior nodes absorb both children per
    level (one permute per child side)."""
    n = comm.size
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    max_depth = 0
    while (1 << (max_depth + 1)) - 1 < n:
        max_depth += 1
    for d in range(max_depth, 0, -1):
        lo, hi = (1 << d) - 1, min((1 << (d + 1)) - 1, n)
        for side in (1, 2):  # vrank 2p+1 is p's left child, 2p+2 its right
            pairs = [((v + root) % n, ((v - side) // 2 + root) % n)
                     for v in range(lo, hi) if (v - side) % 2 == 0]
            if not pairs:
                continue
            recv = spmd.ppermute(comm, x, pairs)
            if lo <= 2 * vrank + side < hi:
                x = op(x, recv)
    return x


def reduce_in_order_binary(comm, x, op, root=0):
    """In-order binary reduce (reference: coll_base_reduce.c:509): the
    rank-ordered guarantee it exists for is the linear algorithm's."""
    return reduce_linear(comm, x, op, root)


def reduce_rabenseifner(comm, x, op, root=0):
    """Rabenseifner reduce (reference: coll_base_reduce.c:797): recursive
    -halving reduce-scatter, then the gather as an allgather (result
    significant at root)."""
    n = comm.size
    if n & (n - 1) or n == 1:
        return reduce_binomial(comm, x, op, root)
    buf, length = _chunked(x, n)
    own = reduce_scatter_recursive_halving(comm, buf.reshape(-1), op)
    gathered = allgather_ring(comm, own)
    return gathered.reshape(-1)[:length].reshape(x.shape)


# ---------------------------------------------------------------------------
# Allgather (cf. coll_base_allgather.c)
# ---------------------------------------------------------------------------


def _stack_shape(x):
    return x[None] if x.dim() == 0 else x


def _own_block_buffer(x, n, rank, rows=None):
    """A zero (rows or n, *x.shape) buffer holding ``x`` at ``rank``."""
    buf = x.new_zeros(((rows or n),) + tuple(x.shape))
    buf[rank] = x
    return buf


def _flat_blocks(buf, x):
    n = buf.shape[0]
    return buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def allgather_ring(comm, x):
    """Ring allgather (reference: coll_base_allgather.c:358)."""
    n = comm.size
    x = _stack_shape(x)
    if n == 1:
        return x
    rank = comm.rank
    buf = _own_block_buffer(x, n, rank)
    for k in range(n - 1):
        send_idx = (rank - k) % n
        recv_idx = (rank - k - 1) % n
        buf[recv_idx] = spmd.ppermute(comm, buf[send_idx], _ring)
    return _flat_blocks(buf, x)


def allgather_bruck(comm, x):
    """Bruck allgather (reference: coll_base_allgather.c:85): ceil(log2 p)
    rounds of doubling block counts, then a rotation."""
    n = comm.size
    x = _stack_shape(x)
    if n == 1:
        return x
    buf = _own_block_buffer(x, n, 0)
    k = 1
    while k < n:
        cnt = min(k, n - k)
        buf[k:k + cnt] = spmd.ppermute(
            comm, buf[:cnt], lambda m, k=k: [(i, (i - k) % m) for i in range(m)])
        k <<= 1
    # buf[j] holds the block of comm rank (rank + j) % n; rotate to rank order
    return _flat_blocks(torch.roll(buf, shifts=comm.rank, dims=0), x)


def allgather_recursive_doubling(comm, x):
    """Recursive-doubling allgather (pow2; reference pattern of
    coll_base_allgather.c).  Falls back to Bruck otherwise."""
    n = comm.size
    if n & (n - 1):
        return allgather_bruck(comm, x)
    x = _stack_shape(x)
    if n == 1:
        return x
    rank = comm.rank
    buf = _own_block_buffer(x, n, rank)
    w = 1
    while w < n:
        pairs = [(i, i ^ w) for i in range(n)]
        my_lo = rank & ~(w - 1)
        partner_lo = (rank ^ w) & ~(w - 1)
        buf[partner_lo:partner_lo + w] = spmd.ppermute(
            comm, buf[my_lo:my_lo + w], pairs)
        w <<= 1
    return _flat_blocks(buf, x)


def _neighbor_exchange_plan(n: int):
    """Static per-step (pairs, sent_lo[rank], recv_lo[rank]) tables for the
    neighbor-exchange allgather."""
    sent = [r - (r % 2) for r in range(n)]  # pair window owned after step 0
    steps = []
    for s in range(1, n // 2):
        partner = []
        for r in range(n):
            if r % 2 == 0:
                p = (r - 1) % n if s % 2 == 1 else (r + 1) % n
            else:
                p = (r + 1) % n if s % 2 == 1 else (r - 1) % n
            partner.append(p)
        pairs = [(r, partner[r]) for r in range(n)]
        recv = [sent[partner[r]] for r in range(n)]
        steps.append((pairs, list(sent), list(recv)))
        sent = recv
    return steps


def allgather_neighbor_exchange(comm, x):
    """Neighbor-exchange allgather (reference: coll_base_allgather.c:484,
    the Chen et al. algorithm): even n only — n/2 rounds alternating
    exchanges with left/right neighbors, each carrying the pair-window
    received in the previous round.  Falls back to ring for odd n."""
    n = comm.size
    x = _stack_shape(x)
    if n == 1:
        return x
    if n % 2:
        return allgather_ring(comm, x)
    rank = comm.rank
    buf = _own_block_buffer(x, n, rank)
    # step 0: exchange own block within (even, odd) pairs
    buf[rank ^ 1] = spmd.ppermute(comm, x, [(i, i ^ 1) for i in range(n)])
    for pairs, sent_lo, recv_lo in _neighbor_exchange_plan(n):
        s_lo, r_lo = sent_lo[rank], recv_lo[rank]
        buf[r_lo:r_lo + 2] = spmd.ppermute(comm, buf[s_lo:s_lo + 2], pairs)
    return _flat_blocks(buf, x)


def allgather_two_proc(comm, x):
    """Two-process allgather (reference: coll_base_allgather.c:598): one
    exchange.  Requires comm size 2; falls back to ring otherwise."""
    if comm.size != 2:
        return allgather_ring(comm, x)
    x = _stack_shape(x)
    other = spmd.ppermute(comm, x, [(0, 1), (1, 0)])
    lo, hi = (x, other) if comm.rank == 0 else (other, x)
    return torch.cat([lo, hi], dim=0)


def allgather_linear(comm, x):
    """Basic linear allgather (reference: coll_base_allgather.c:681): every
    rank sends to every other, as p-1 shifts."""
    n = comm.size
    x = _stack_shape(x)
    if n == 1:
        return x
    rank = comm.rank
    buf = _own_block_buffer(x, n, rank)
    for r in range(1, n):
        buf[(rank - r) % n] = spmd.shift(comm, x, r, wrap=True)
    return _flat_blocks(buf, x)


# ---------------------------------------------------------------------------
# Alltoall (cf. coll_base_alltoall.c)
# ---------------------------------------------------------------------------


def _atoall_blocks(comm, x):
    n = comm.size
    if x.shape[0] % n:
        raise errors.CountError(
            f"alltoall needs dim0 divisible by comm size {n}, got {x.shape[0]}")
    m = x.shape[0] // n
    return n, x.reshape((n, m) + tuple(x.shape[1:]))


def alltoall_pairwise(comm, x):
    """Pairwise exchange (reference: coll_base_alltoall.c:132): p-1 rounds,
    round r exchanges with rank±r."""
    n, blocks = _atoall_blocks(comm, x)
    if n == 1:
        return x
    rank = comm.rank
    out = torch.zeros_like(blocks)
    out[rank] = blocks[rank]
    for r in range(1, n):
        out[(rank - r) % n] = spmd.ppermute(
            comm, blocks[(rank + r) % n],
            lambda m, r=r: [(i, (i + r) % m) for i in range(m)])
    return out.reshape(x.shape)


def alltoall_bruck(comm, x):
    """Bruck alltoall (reference: coll_base_alltoall.c:191): log2(p) rounds
    moving blocks whose index has bit k set."""
    n, blocks = _atoall_blocks(comm, x)
    if n == 1:
        return x
    rank = comm.rank
    # phase 1: local rotation so block j targets rank (rank + j) % n
    blocks = torch.roll(blocks, shifts=-rank, dims=0)
    # phase 2: for each bit k, send blocks with bit k set to rank + 2^k
    k = 1
    while k < n:
        sent = spmd.ppermute(
            comm, blocks, lambda m, k=k: [(i, (i + k) % m) for i in range(m)])
        take = [j for j in range(n) if j & k]
        blocks[take] = sent[take]
        k <<= 1
    # phase 3: slot j at rank d holds data from source (d - j) mod n;
    # restoring source order is a flip then a rotation by rank+1
    blocks = torch.roll(torch.flip(blocks, dims=(0,)), shifts=rank + 1, dims=0)
    return blocks.reshape(x.shape)


def alltoall_linear(comm, x):
    """Basic linear alltoall (reference: coll_base_alltoall.c:569): the same
    p-1 shift rounds as pairwise."""
    return alltoall_pairwise(comm, x)


def alltoall_linear_sync(comm, x, window: int = 4):
    """Linear-sync alltoall (reference: coll_base_alltoall.c:333): linear
    with at most ``window`` transfers in flight.  Each round here completes
    before the next starts, which is within any window, so the schedule is
    pairwise's."""
    return alltoall_pairwise(comm, x)


def alltoall_two_proc(comm, x):
    """Two-process alltoall (reference: coll_base_alltoall.c:490): one
    exchange of the off-diagonal blocks."""
    n, blocks = _atoall_blocks(comm, x)
    if n != 2:
        return alltoall_pairwise(comm, x)
    rank = comm.rank
    mine = blocks[rank]
    theirs = spmd.ppermute(comm, blocks[1 - rank], [(0, 1), (1, 0)])
    lo, hi = (mine, theirs) if rank == 0 else (theirs, mine)
    return torch.stack([lo, hi]).reshape(x.shape)


# ---------------------------------------------------------------------------
# Alltoallv (cf. coll_base_alltoallv.c)
# ---------------------------------------------------------------------------


def alltoallv_prepare(comm, x, counts):
    """Shared front half of every alltoallv transport: validate the static
    ``counts[i][j]`` matrix, pad the send blocks to the global max count,
    and zero rows beyond this rank's per-destination counts so padding can
    never leak into receive buffers.  Returns ``(blocks, max_recv)`` with
    blocks shaped ``(n, max_recv, ...)``."""
    n = comm.size
    if len(counts) != n or any(
            not hasattr(row, "__len__") or len(row) != n for row in counts):
        raise errors.ArgError(f"counts must be {n}x{n}")
    if x.shape[0] != n:
        raise errors.CountError(
            f"alltoallv send buffer needs {n} blocks, got {x.shape[0]}")
    max_recv = max(max(row) for row in counts)
    blocks = _pad_rows(x.transpose(0, 1), max_recv - x.shape[1])
    blocks = blocks[:max_recv].transpose(0, 1).clone()
    for j, cnt in enumerate(counts[comm.rank]):
        blocks[j, cnt:] = 0
    return blocks, max_recv


def alltoallv_padded(comm, x, counts):
    """Pairwise alltoallv (reference: coll_base_alltoallv.c:125) with a
    static count matrix.  ``counts[i][j]`` is how many dim0 rows rank i
    sends to rank j.  ``x`` is this rank's send buffer laid out as
    ``(n, max_send, ...)`` padded blocks.  Returns ``(n, max_recv, ...)``
    padded receive blocks — entries beyond ``counts[src][rank]`` are zero."""
    blocks, _ = alltoallv_prepare(comm, x, counts)
    n, rank = comm.size, comm.rank
    out = torch.zeros_like(blocks)
    out[rank] = blocks[rank]
    for r in range(1, n):
        out[(rank - r) % n] = spmd.ppermute(
            comm, blocks[(rank + r) % n],
            lambda m, r=r: [(i, (i + r) % m) for i in range(m)])
    return out


# ---------------------------------------------------------------------------
# Reduce_scatter (cf. coll_base_reduce_scatter.c)
# ---------------------------------------------------------------------------


def reduce_scatter_ring(comm, x, op):
    """Ring reduce-scatter (reference: coll_base_reduce_scatter.c:456)."""
    n = comm.size
    if n == 1:
        return x
    rank = comm.rank
    _, blocks = _atoall_blocks(comm, x)
    blocks = blocks.clone()
    for k in range(n - 1):
        send_idx = (rank - k) % n
        recv_idx = (rank - k - 1) % n
        sent = spmd.ppermute(comm, blocks[send_idx], _ring)
        blocks[recv_idx] = op(sent, blocks[recv_idx])
    # rank owns chunk (rank+1)%n; shift it home so rank r holds chunk r
    return spmd.shift(comm, blocks[(rank + 1) % n], 1, wrap=True)


def reduce_scatter_recursive_halving(comm, x, op):
    """Recursive halving (reference: coll_base_reduce_scatter.c:132); pow2
    ranks, falls back to ring otherwise."""
    n = comm.size
    if n & (n - 1):
        return reduce_scatter_ring(comm, x, op)
    if n == 1:
        return x
    rank = comm.rank
    _, blocks = _atoall_blocks(comm, x)
    blocks = blocks.clone()
    lo = 0
    bit = n >> 1
    while bit:
        pairs = [(i, i ^ bit) for i in range(n)]
        on_upper = (rank & bit) != 0
        send_lo = lo if on_upper else lo + bit
        keep_lo = lo + bit if on_upper else lo
        sent = spmd.ppermute(comm, blocks[send_lo:send_lo + bit], pairs)
        blocks[keep_lo:keep_lo + bit] = op(sent, blocks[keep_lo:keep_lo + bit])
        lo = keep_lo
        bit >>= 1
    return blocks[rank]


def reduce_scatter_nonoverlapping(comm, x, op):
    """Reduce + scatter composition (reference:
    coll_base_reduce_scatter.c:47): binomial reduce to rank 0, then linear
    scatter of the chunks."""
    n = comm.size
    if n == 1:
        return x
    _atoall_blocks(comm, x)  # validate divisibility
    reduced = reduce_binomial(comm, x, op, root=0)
    chunk = x.shape[0] // n
    scattered = scatter_linear(comm, reduced.reshape(-1), 0)
    rest = tuple(x.shape[1:])
    return scattered[:chunk * math.prod(rest)].reshape((chunk,) + rest)


def reduce_scatter_butterfly(comm, x, op):
    """Butterfly reduce-scatter (reference: coll_base_reduce_scatter.c:691):
    for power-of-two comms the butterfly coincides with recursive halving;
    other sizes take the ring."""
    n = comm.size
    if n & (n - 1):
        return reduce_scatter_ring(comm, x, op)
    return reduce_scatter_recursive_halving(comm, x, op)


# ---------------------------------------------------------------------------
# Reduce_scatter_block (cf. coll_base_reduce_scatter_block.c)
# ---------------------------------------------------------------------------


def reduce_scatter_block_linear(comm, x, op):
    """Reduce-to-all then take own block (reference:
    coll_base_reduce_scatter_block.c:55, rank order)."""
    _, blocks = _atoall_blocks(comm, x)
    full = allreduce_linear(comm, x, op)
    return full.reshape(blocks.shape)[comm.rank]


def reduce_scatter_block_recursive_doubling(comm, x, op):
    """Recursive-doubling variant (reference:
    coll_base_reduce_scatter_block.c:128): allreduce by recursive doubling,
    keep own block."""
    _, blocks = _atoall_blocks(comm, x)
    full = allreduce_recursive_doubling(comm, x, op)
    return full.reshape(blocks.shape)[comm.rank]


def reduce_scatter_block_recursive_halving(comm, x, op):
    """Recursive-halving variant (reference:
    coll_base_reduce_scatter_block.c:326)."""
    return reduce_scatter_recursive_halving(comm, x, op)


def reduce_scatter_block_butterfly(comm, x, op):
    """Butterfly variant (reference: coll_base_reduce_scatter_block.c:567
    and the pow2 specialization at :810)."""
    return reduce_scatter_butterfly(comm, x, op)


# ---------------------------------------------------------------------------
# Scan / Exscan (cf. coll_base_scan.c, coll_base_exscan.c)
# ---------------------------------------------------------------------------


def scan_recursive_doubling(comm, x, op):
    """Inclusive prefix reduction, Hillis-Steele over ranks (reference:
    coll_base_scan.c:157).  Order-preserving: safe for non-commutative
    (associative) ops."""
    n = comm.size
    k = 1
    while k < n:
        recv = spmd.ppermute(comm, x, [(i, i + k) for i in range(n - k)])
        if comm.rank >= k:
            x = op(recv, x)
        k <<= 1
    return x


def scan_linear(comm, x, op):
    """Linear scan (reference: coll_base_scan.c:35): the running prefix
    crawls up the rank chain one hop per round."""
    acc = x
    for r in range(1, comm.size):
        recv = spmd.ppermute(comm, acc, [(r - 1, r)])
        if comm.rank == r:
            acc = op(recv, acc)
    return acc


def exscan_linear(comm, x, op):
    """Linear exscan (reference: coll_base_exscan.c:35): the inclusive
    prefix of rank r-1 arrives as rank r's exclusive result.  Rank 0's
    result is undefined per MPI; here it holds zeros."""
    acc = x  # inclusive prefix being built
    out = _tmap(torch.zeros_like, x)
    for r in range(1, comm.size):
        recv = spmd.ppermute(comm, acc, [(r - 1, r)])
        if comm.rank == r:
            out = recv
            acc = op(recv, acc)
    return out


def exscan_recursive_doubling(comm, x, op):
    """Exclusive scan (reference: coll_base_exscan.c:142): inclusive scan,
    then shift the RESULTS up one rank — correct for every associative op.
    Rank 0's result is undefined per MPI; here it holds zeros."""
    inclusive = scan_recursive_doubling(comm, x, op)
    return spmd.shift(comm, inclusive, 1, wrap=False)


# ---------------------------------------------------------------------------
# Barrier (cf. coll_base_barrier.c)
# ---------------------------------------------------------------------------


def _barrier_token(comm, token):
    """The float32 scalar each barrier round permutes: this rank's index
    plus the caller's token data, so the rounds carry data that depends on
    every rank."""
    device = token.device if token is not None else comm.device
    t = torch.tensor(float(comm.rank), dtype=torch.float32, device=device)
    if token is not None:
        t = t + token.sum().to(torch.float32)
    return t


def _seal_token(t):
    """An int32 zero computed from the barrier rounds' result."""
    return (t.to(torch.float32) * 0.0).to(torch.int32)


def barrier_dissemination(comm, token=None):
    """Bruck/dissemination barrier (reference: coll_base_barrier.c:253):
    ceil(log2 p) rounds of shifted notifications.  Returns a zero scalar
    usable as a sequencing token."""
    n = comm.size
    t = _barrier_token(comm, token)
    k = 1
    while k < n:
        t = t + spmd.ppermute(
            comm, t, lambda m, k=k: [(i, (i + k) % m) for i in range(m)])
        k <<= 1
    return _seal_token(t)


def barrier_double_ring(comm, token=None):
    """Double-ring barrier (reference: coll_base_barrier.c:100): two full
    laps of a token around the ring — 2(p-1) hops.  The token is passed
    along, not accumulated (a sum doubles per hop)."""
    t = _barrier_token(comm, token)
    for _ in range(2 * (comm.size - 1)):
        t = spmd.shift(comm, t, 1, wrap=True)
    return _seal_token(t)


def barrier_recursive_doubling(comm, token=None):
    """Recursive-doubling barrier (reference: coll_base_barrier.c:172):
    log2(p) pairwise xor-distance exchanges (pow2 comms; others take the
    dissemination barrier)."""
    n = comm.size
    if n & (n - 1):
        return barrier_dissemination(comm, token)
    t = _barrier_token(comm, token)
    k = 1
    while k < n:
        t = t + spmd.ppermute(comm, t, [(i, i ^ k) for i in range(n)])
        k <<= 1
    return _seal_token(t)


def barrier_two_proc(comm, token=None):
    """Two-process barrier (reference: coll_base_barrier.c:291): one
    exchange."""
    if comm.size != 2:
        return barrier_dissemination(comm, token)
    t = _barrier_token(comm, token)
    return _seal_token(t + spmd.ppermute(comm, t, [(0, 1), (1, 0)]))


def barrier_tree(comm, token=None):
    """Tree barrier (reference: coll_base_barrier.c:404): binomial fan-in to
    rank 0 then binomial fan-out."""
    t = _barrier_token(comm, token)
    t = reduce_binomial(comm, t, lambda a, b: a + b, root=0)
    return _seal_token(bcast_binomial(comm, t, root=0))


def barrier_linear(comm, token=None):
    """Linear barrier (reference: coll_base_barrier.c:330): everyone
    reports to everyone, as p-1 shifts."""
    t = _barrier_token(comm, token)
    acc = t
    for r in range(1, comm.size):
        acc = acc + spmd.shift(comm, t, r, wrap=True)
    return _seal_token(acc)


# ---------------------------------------------------------------------------
# Gather / Scatter (cf. coll_base_gather.c / coll_base_scatter.c)
# ---------------------------------------------------------------------------


def gather_ring(comm, x, root=0):
    """Gather via allgather: every rank runs the same collective, so the
    result is simply significant at root."""
    return allgather_ring(comm, x)


def scatter_linear(comm, x, root=0):
    """Linear scatter (reference: coll_base_scatter.c:63): root sends chunk i
    to rank i, one permute per destination.  Returns this rank's flat
    chunk (zero-padded where x does not split evenly)."""
    n = comm.size
    buf, _ = _chunked(x, n)
    out = buf[comm.rank]  # root's own chunk
    for i in range(n):
        if i == root:
            continue
        sent = spmd.ppermute(comm, buf[i], [(root, i)])
        if comm.rank == i:
            out = sent
    return out


def gather_binomial(comm, x, root=0):
    """Binomial-tree gather (reference: coll_base_gather.c:41): round k,
    vranks with bit k set ship their accumulated window of k blocks to
    vrank−k; root ends holding all p blocks (significant at root)."""
    n = comm.size
    x = _stack_shape(x)
    if n == 1:
        return x
    vrank = (comm.rank - root) % n
    # 2n rows: windows past n land in zero padding
    buf = _own_block_buffer(x, n, vrank, rows=2 * n)
    k = 1
    while k < n:
        pairs = [((v + k + root) % n, (v + root) % n)
                 for v in range(0, n - k, 2 * k)]
        sent = spmd.ppermute(comm, buf[vrank:vrank + k], pairs)
        if vrank % (2 * k) == 0 and vrank + k < n:
            buf[vrank + k:vrank + 2 * k] = sent
        k <<= 1
    # root's window is [0, n) in vrank order; rotate to rank order
    return _flat_blocks(torch.roll(buf[:n], shifts=root, dims=0), x)


def gather_linear_sync(comm, x, root=0):
    """Linear-sync gather (reference: coll_base_gather.c:208): each round
    completes before the next, which is the ack handshake's order, so this
    shares the ring-gather schedule."""
    return gather_ring(comm, x, root)


def scatter_binomial(comm, x, root=0):
    """Binomial-tree scatter (reference: coll_base_scatter.c:63, the
    binomial entry): root starts with all p chunks, round k (descending)
    hands the upper half of each holder's window to vrank+k."""
    n = comm.size
    buf, length = _chunked(x, n)
    if n == 1:
        return buf.reshape(-1)[:length]
    vrank = (comm.rank - root) % n
    # root's chunks in vrank order, padded to 3n rows so that every window
    # below is whole (a receiver's output takes its own window's shape)
    buf = _pad_rows(torch.roll(buf, shifts=-root, dims=0), 2 * n)
    k = _pow2_floor(n - 1)
    while k >= 1:
        pairs = [((v + root) % n, (v + k + root) % n)
                 for v in range(0, n - k, 2 * k)]
        sent = spmd.ppermute(comm, buf[vrank + k:vrank + 2 * k], pairs)
        if vrank % (2 * k) == k:
            buf[vrank:vrank + k] = sent
        k >>= 1
    return buf[vrank]


def bcast_via_scatter(comm, x, root=0):
    return bcast_scatter_allgather(comm, x, root)


# ---------------------------------------------------------------------------
# Vector (v) variants
# ---------------------------------------------------------------------------


def allgatherv_concat(comm, x, counts: list[int]):
    """Allgatherv with static per-rank counts (cf. coll_base_allgatherv.c):
    pad to the max count, exchange, then re-concatenate.  ``x`` is this
    rank's contribution, whose dim0 may be any value up to max(counts);
    entries beyond the rank's count are ignored."""
    n = comm.size
    if len(counts) != n:
        raise errors.ArgError(f"need {n} counts, got {len(counts)}")
    mx = max(counts)
    x = _pad_rows(x, mx - x.shape[0])
    gathered = allgather_ring(comm, x).reshape((n, mx) + tuple(x.shape[1:]))
    return torch.cat([gathered[i, :counts[i]] for i in range(n)], dim=0)
