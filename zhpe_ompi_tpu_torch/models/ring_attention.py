"""Ring attention — sequence/context parallelism over the framework's ring
(namesake: ``zhpe_ompi_tpu/models/ring_attention.py``).

Q/K/V are sharded over the sequence on the ranks of ``comm``; each ring
step computes one block of the attention matrix while the K/V blocks
rotate one hop around the ring through ``pt2pt/spmd.shift``.  Numerics are
the JAX package's: the flash-attention online-softmax recurrence (running
max, running denominator, rescaled accumulator) in float32, with the
``safe_m``/``isfinite`` guards that keep fully masked blocks (and their
gradients) free of NaN, and the result cast to ``q.dtype``.

Port notes:

- the JAX package's ``lax.scan`` over ring steps is a Python loop, and its
  ``lax.switch`` on the traced rank an ``if`` on the plain-int rank;
- K and V travel together, stacked in ``q``'s dtype, as one permute per
  step: one message per hop, and one chain of permutes whose backward
  runs in the same order on every rank (two separate chains could be
  interleaved differently by autograd on different ranks, and a
  point-to-point backend would then pair a K message with a V one);
- the last step's rotation, which only brings the blocks home, is not
  sent.
"""

from __future__ import annotations

import torch

from ..core import errors
from ..pt2pt import spmd

_NEG_INF = float("-inf")


def _chunk_attn(qf, kb, vb, m, l, acc, mask=None):
    """One (Sc x Sc) online-softmax block update; qf pre-scaled f32."""
    scores = torch.einsum("bshd,bthd->bhst", qf, kb.float())
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    blk_max = scores.amax(-1)
    new_m = torch.maximum(m, blk_max)
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bhst,bthd->bshd", p, vb.float())
    acc = acc * corr.transpose(1, 2)[..., None] + pv
    return new_m, l, acc


def _init(q, sq):
    B, _, H, D = q.shape
    return (torch.full((B, H, sq), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, H, sq), dtype=torch.float32, device=q.device),
            torch.zeros((B, sq, H, D), dtype=torch.float32, device=q.device))


def _finish(l, acc):
    return acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]


def _ring_sources(rank: int, n: int) -> list[int]:
    """Whose K/V block ``rank`` holds at each ring step: its own first,
    then each left neighbour's as the blocks rotate one hop a step."""
    return [(rank - i) % n for i in range(n)]


def _contiguous_step(qf, kb, vb, state, rank: int, src: int, causal: bool):
    """One ring step of the contiguous layout: ``rank``'s query block
    (pre-scaled f32) against ``src``'s K/V block, both S_local long."""
    mask = None
    if causal:
        S = qf.shape[1]
        pos = torch.arange(S, device=qf.device)
        mask = (rank * S + pos)[:, None] >= (src * S + pos)[None, :]
    return _chunk_attn(qf, kb, vb, *state, mask=mask)


def ring_attention(comm, q, k, v, causal: bool = True):
    """Exact attention over a sequence sharded on ``comm``'s ranks.

    q, k, v: (B, S_local, H, D) — this rank's sequence block (rank r holds
    positions [r S_local, (r+1) S_local)).  Returns (B, S_local, H, D).
    Every rank of ``comm`` calls it together."""
    n = comm.size
    if n == 1:
        return _block_attention_single(q, k, v, causal)
    rank = comm.rank
    S, D = q.shape[1], q.shape[3]
    qf = q.float() * D ** -0.5
    state = _init(q, S)
    kv = torch.stack([k, v])
    for i, src in enumerate(_ring_sources(rank, n)):
        state = _contiguous_step(qf, kv[0], kv[1], state, rank, src, causal)
        if i < n - 1:
            kv = spmd.shift(comm, kv, 1)
    return _finish(*state[1:]).to(q.dtype)


def _block_attention_single(q, k, v, causal):
    S, D = q.shape[1], q.shape[3]
    scores = torch.einsum("bshd,bthd->bhst", q.float() * D ** -0.5, k.float())
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------- zigzag
# Load-balanced causal ring attention.  With the contiguous layout above,
# causality leaves rank i live work only at steps with src <= i, while
# every rank computes a full block each step.  The zigzag layout gives
# rank i the chunk PAIR (i, 2n-1-i) of 2n global chunks; then every
# (rank, step) pair has exactly two unmasked half-chunk equivalents, and
# computing only the live sub-blocks halves the attention work on every
# rank.


def zigzag_shard(x, n: int):
    """Global (B, S, ...) -> (n, B, S/n, ...) zigzag blocks: rank i gets
    chunks (i, 2n-1-i) of the 2n-chunk split, concatenated."""
    S = x.shape[1]
    if S % (2 * n):
        raise errors.ArgError(
            f"sequence {S} must split into 2n = {2 * n} chunks")
    c = S // (2 * n)
    chunks = [x[:, i * c:(i + 1) * c] for i in range(2 * n)]
    return torch.stack([torch.cat([chunks[i], chunks[2 * n - 1 - i]], dim=1)
                        for i in range(n)])


def zigzag_unshard(blocks, n: int):
    """(n, B, S/n, ...) zigzag blocks -> global (B, S, ...)."""
    parts = [None] * (2 * n)
    for i in range(n):
        b = blocks[i]
        c = b.shape[1] // 2
        parts[i] = b[:, :c]
        parts[2 * n - 1 - i] = b[:, c:]
    return torch.cat(parts, dim=1)


def _zigzag_step(qa, qb, kb, vb, sa, sb, rank: int, src: int, diag):
    """One ring step of the zigzag layout: ``rank``'s early and late query
    chunks (``qa``, ``qb``, pre-scaled f32; online-softmax states ``sa``,
    ``sb``) against the causally live sub-blocks of ``src``'s K/V pair.
    ``diag`` is the (c, c) lower-triangular mask."""
    c = qa.shape[1]
    kc, kd = kb[:, :c], kb[:, c:]  # src's early / late chunks
    vc, vd = vb[:, :c], vb[:, c:]
    # live sub-blocks (chunk ids: a=rank, b=2n-1-rank, c=src, d=2n-1-src):
    #   rank > src: (a,c) full, (b,c) full
    #   rank < src: (b,c) full, (b,d) full
    #   rank == src: (a,c) diag, (b,c) full, (b,d) diag
    if rank > src:
        sa = _chunk_attn(qa, kc, vc, *sa)
        sb = _chunk_attn(qb, kc, vc, *sb)
    elif rank < src:
        sb = _chunk_attn(qb, kc, vc, *sb)
        sb = _chunk_attn(qb, kd, vd, *sb)
    else:
        sa = _chunk_attn(qa, kc, vc, *sa, mask=diag)
        sb = _chunk_attn(qb, kc, vc, *sb)
        sb = _chunk_attn(qb, kd, vd, *sb, mask=diag)
    return sa, sb


def ring_attention_zigzag(comm, q, k, v):
    """Exact CAUSAL attention over a zigzag-sharded sequence.

    q, k, v: (B, S_local, H, D) where the first half is this rank's EARLY
    chunk (global chunk ``rank``) and the second half its LATE chunk
    (global chunk ``2n-1-rank``) — the :func:`zigzag_shard` layout.  Each
    ring step computes only the causally live sub-blocks."""
    n = comm.size
    if n == 1:
        return _block_attention_single(q, k, v, True)
    rank = comm.rank
    S, D = q.shape[1], q.shape[3]
    c = S // 2
    qf = q.float() * D ** -0.5
    diag = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    sa, sb = _init(q, c), _init(q, c)
    kv = torch.stack([k, v])
    for i, src in enumerate(_ring_sources(rank, n)):
        sa, sb = _zigzag_step(qf[:, :c], qf[:, c:], kv[0], kv[1], sa, sb,
                              rank, src, diag)
        if i < n - 1:
            kv = spmd.shift(comm, kv, 1)
    out = torch.cat([_finish(*sa[1:]), _finish(*sb[1:])], dim=1)
    return out.to(q.dtype)
