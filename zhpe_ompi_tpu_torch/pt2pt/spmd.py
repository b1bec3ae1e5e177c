"""SPMD-plane point-to-point primitives (namesake:
``zhpe_ompi_tpu/pt2pt/spmd.py``).

A static communication pattern — a list of comm-relative ``(src, dst)``
pairs, or a callable ``group_size -> pairs`` — is one batch of
``torch.distributed`` point-to-point operations
(``dist.batch_isend_irecv``) in place of the JAX package's XLA
``collective_permute``.  The semantics are the JAX ones:

- every rank of the communicator calls every permute, whether or not it
  sends or receives in it (SPMD collective order);
- a rank that nobody sends to receives zeros; ``shift`` with
  ``wrap=False`` gives MPI_PROC_NULL ends;
- a duplicate destination (or source) raises ``ArgError``;
- a pair ``(i, i)`` is a local copy, so at size 1 ``shift`` and
  ``ppermute`` issue no backend call.

Buffers go to the backend contiguous (gloo refuses a strided view) and
bool tensors travel as bytes.  :func:`ppermute` and :func:`shift` are
differentiable: the backward sends the cotangent along the inverse
permutation, the transpose ``lax.ppermute`` has.  A tuple of tensors
(MINLOC/MAXLOC's ``(values, indices)``) is permuted leaf by leaf.

On NCCL, the caller sets ``torch.cuda.set_device`` before the first
permute, and the first batched P2P call on a group must involve every
rank of it: the first permute on a communicator of two or more ranks
therefore runs one full ring exchange of a one-element tensor first.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..core import errors

PatternFn = Callable[[int], Sequence[tuple[int, int]]]


def global_pairs(comm, pattern: Sequence[tuple[int, int]] | PatternFn
                 ) -> list[tuple[int, int]]:
    """Translate a comm-relative pattern to pairs of global ranks (ranks of
    the ``torch.distributed`` world).  ``pattern`` is a pair list (pairs
    outside the group's size are dropped) or a callable ``group_size ->
    pairs``."""
    n = comm.size
    pairs = pattern(n) if callable(pattern) else pattern
    ranks = comm.group.ranks
    out: list[tuple[int, int]] = []
    seen_src: set[int] = set()
    seen_dst: set[int] = set()
    for s, d in pairs:
        if not (0 <= s < n and 0 <= d < n):
            continue
        gs, gd = ranks[s], ranks[d]
        if gd in seen_dst:
            raise errors.ArgError(
                f"duplicate destination {gd} in permute pattern")
        if gs in seen_src:
            raise errors.ArgError(f"duplicate source {gs} in permute pattern")
        seen_src.add(gs)
        seen_dst.add(gd)
        out.append((gs, gd))
    return out


def wire(t):
    """The buffer a backend moves for ``t``: contiguous, bools as bytes
    (NCCL has no bool)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _nccl_p2p_warmup(comm):
    n = comm.size
    nxt = comm.group.ranks[(comm.rank + 1) % n]
    prv = comm.group.ranks[(comm.rank - 1) % n]
    buf = torch.zeros(1, device=comm.device)
    got = torch.empty_like(buf)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, nxt, comm.pg),
            dist.P2POp(dist.irecv, got, prv, comm.pg)]):
        req.wait()
    comm._p2p_ready = True


def _exchange(comm, x, pairs):
    """This rank's part of one permute: send ``x`` to its destination and
    return what its source sent (zeros when none does)."""
    if comm.backend == "nccl" and comm.size > 1 and not comm._p2p_ready:
        _nccl_p2p_warmup(comm)
    me = comm.group.ranks[comm.rank]
    dst = next((d for s, d in pairs if s == me), None)
    src = next((s for s, d in pairs if d == me), None)
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, wire(x), dst, comm.pg))
    if src is None:
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    elif src == me:
        out = x.clone(memory_format=torch.contiguous_format)
    else:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.irecv, wire(out), src, comm.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, pairs):
        ctx.comm, ctx.pairs = comm, pairs
        return _exchange(comm, x, pairs)

    @staticmethod
    def backward(ctx, ct):
        inverse = [(d, s) for s, d in ctx.pairs]
        return _exchange(ctx.comm, ct, inverse), None, None


def ppermute(comm, x, pattern: Sequence[tuple[int, int]] | PatternFn):
    """Collective permute with a comm-relative static pattern.  Ranks that
    are not a destination receive zeros (XLA collective_permute
    semantics)."""
    pairs = global_pairs(comm, pattern)
    if isinstance(x, (tuple, list)):
        return type(x)(_Permute.apply(leaf, comm, pairs) for leaf in x)
    return _Permute.apply(x, comm, pairs)


def shift(comm, x, offset: int, wrap: bool = True):
    """Send to (rank+offset) mod group_size — the ring primitive.

    With ``wrap=False`` the ends don't exchange (MPI_PROC_NULL semantics of
    MPI_Cart_shift with a non-periodic topology): falling-off ranks receive
    zeros.
    """

    def pattern(n: int):
        ps = []
        for i in range(n):
            j = i + offset
            if wrap:
                ps.append((i, j % n))
            elif 0 <= j < n:
                ps.append((i, j))
        return ps

    return ppermute(comm, x, pattern)


def sendrecv_shift(comm, x, offset: int):
    """ompi_coll_base_sendrecv analog for the uniform-shift pattern."""
    return shift(comm, x, offset, wrap=True)


def sendrecv(comm, x, dest_of: list[int]):
    """Fully general static sendrecv: `dest_of[i]` is where comm rank i's
    buffer goes (use -1 for "sends nowhere")."""
    pairs = [(i, d) for i, d in enumerate(dest_of) if d >= 0]
    return ppermute(comm, x, pairs)
