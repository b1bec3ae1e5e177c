"""Deterministic log-degree control-plane overlay (the scale-out flood
fabric) (namesake: ``zhpe_ompi_tpu/pt2pt/overlay.py``; the port's own
copy; its users are the ULFM control floods of ``pt2pt/tcp.py``).

Every ULFM control flood — failure notices, cid revokes, agreement
announces, BYE departures — used to dial EVERY live peer (all-pairs:
O(n) sockets per flooding rank, O(n²) frames per event across the
universe).  That is exactly the wire-up pattern the reference's runtime
exists to avoid (PRRTE's routed modex; SURVEY.md layer map), and it is
the reason nothing here scaled past single-digit universes.

This module derives a **skip-ring** overlay from nothing but the sorted
live-member list: rank at index ``i`` links to the members at indices
``(i ± 2^k) mod n`` for every ``k`` with ``2^k < n``.  Properties the
flood rewiring depends on:

- **degree ≤ 2·ceil(log2 n)** — per-rank flood fan-out, and therefore
  per-rank control sockets, are O(log n);
- **strongly connected** — the ``±1`` offsets alone form the full ring,
  so gossip-once relaying (forward only FRESH facts to your own
  neighbors) reaches every member, in O(log n) hops via the power-of-two
  chords;
- **deterministic and shared-state-free** — every rank computes the same
  overlay from the same live view, with no membership protocol: at
  shrink the caller simply recomputes from the survivor list and the
  overlay is "rebuilt" by construction;
- **degenerates to all-pairs for n ≤ 5** — the offset set covers every
  other member, so small universes (the whole existing acceptance
  matrix) see byte-identical flood behavior.

The HEARTBEAT ring is untouched: it was already O(1) per rank
(``ulfm.RingDetector`` beats at its live successor only).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def degree_bound(n: int) -> int:
    """Upper bound on a member's overlay degree in an ``n``-member
    universe: ``2·ceil(log2 n)`` (the scaling-curve tests assert the
    measured socket/thread/flood curves under ``a·log2(n)+b`` with this
    as the derivation)."""
    if n <= 1:
        return 0
    return 2 * math.ceil(math.log2(n))


def neighbors(rank: int, members: Iterable[int]) -> list[int]:
    """The skip-ring neighbors of ``rank`` over ``members`` (the live
    set, INCLUDING ``rank`` itself).  Sorted, self-free, and at most
    :func:`degree_bound` long.  A ``rank`` not in ``members`` (a rank
    flooding while peers already suspect it) is inserted virtually so
    it still reaches a covering neighbor set."""
    ms = sorted({int(m) for m in members} | {int(rank)})
    n = len(ms)
    if n <= 1:
        return []
    i = ms.index(int(rank))
    out: set[int] = set()
    k = 1
    while k < n:
        out.add(ms[(i + k) % n])
        out.add(ms[(i - k) % n])
        k <<= 1
    out.discard(int(rank))
    return sorted(out)


def reach_all(origin: int, members: Sequence[int]) -> bool:
    """True iff a gossip-once flood from ``origin`` (relay fresh facts
    to your own neighbors) covers every member — a structural check the
    overlay tests run across universe sizes and survivor subsets; the
    ±1 ring makes it provably always True."""
    ms = sorted({int(m) for m in members})
    if int(origin) not in ms:
        ms = sorted(set(ms) | {int(origin)})
    seen = {int(origin)}
    frontier = [int(origin)]
    while frontier:
        nxt = []
        for r in frontier:
            for nb in neighbors(r, ms):
                if nb not in seen:
                    seen.add(nb)
                    nxt.append(nb)
        frontier = nxt
    return len(seen) == len(ms)
