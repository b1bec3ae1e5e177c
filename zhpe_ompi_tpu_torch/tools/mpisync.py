"""mpisync — cross-rank clock offset estimation for trace alignment
(namesake: ``zhpe_ompi_tpu/tools/mpisync.py``).

Re-design of ``ompi/tools/mpisync`` (SURVEY.md §2.6): the reference
measures per-node clock offsets against rank 0 so that tool timestamps
(PERUSE events, ztrace spans, monitoring dumps) from different nodes can
be merged on one timeline.  Same algorithm here: for each rank, rank 0
runs a burst of ping-pong exchanges, the offset estimate is ``theta =
t_peer − (t0_send + rtt/2)`` from the minimum-RTT sample (the classic
Cristian/NTP estimator the reference uses — its README cites the same
approach).

Protocol: both sides know ``rounds``, so the exchange is fully
deterministic BLOCKING recvs — rank 0 sends, the peer's blocking recv
wakes, the peer answers with its clock, exactly ``rounds`` times per
peer.  (The original shape was a ``probe`` + ``sleep(0)`` polling
server; besides burning a core, every scheduler quantum the spinner
stole inflated the very RTT the estimator minimizes.)

Runs on BOTH planes: pass a :class:`~zhpe_ompi_tpu_torch.pt2pt.universe.
LocalUniverse` and it launches the thread ranks itself (the original
surface), or call it COLLECTIVELY on real-process endpoints
(``TcpProc`` — every rank of the job calls ``sync_clocks(ep)``; rank 0
returns the offsets, the others return None).  Thread-ranks share one
clock, so the *measured* offset is ~0; tests inject synthetic skew
through the ``clock`` hook — which is also how ``tools/ztrace`` plugs
each process's wall-anchored trace clock in
(:func:`zhpe_ompi_tpu_torch.runtime.ztrace.trace_clock`).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..pt2pt.universe import LocalUniverse

_SYNC_TAG = 0x51C
_SYNC_CID = 0x51C


def _sync_body(ctx, rounds: int,
               clock: Callable[[int], float]) -> list[float] | None:
    """The collective body: rank 0 measures every peer with
    ``rounds`` ping-pongs; peers serve exactly ``rounds`` blocking
    recv→answer exchanges.  No probe, no polling, no release frame —
    both sides know the round count."""
    if ctx.rank == 0:
        offsets = [0.0]
        for peer in range(1, ctx.size):
            best_rtt = np.inf
            best_theta = 0.0
            for _ in range(rounds):
                t0 = clock(0)
                ctx.send(t0, dest=peer, tag=_SYNC_TAG, cid=_SYNC_CID)
                t_peer = ctx.recv(
                    source=peer, tag=_SYNC_TAG, cid=_SYNC_CID
                )
                t1 = clock(0)
                rtt = t1 - t0
                if rtt < best_rtt:
                    best_rtt = rtt
                    best_theta = t_peer - (t0 + rtt / 2.0)
            offsets.append(best_theta)
        return offsets
    for _ in range(rounds):
        ctx.recv(source=0, tag=_SYNC_TAG, cid=_SYNC_CID)
        ctx.send(clock(ctx.rank), dest=0, tag=_SYNC_TAG, cid=_SYNC_CID)
    return None


def sync_clocks(uni_or_ep, rounds: int = 16,
                clock: Callable[[int], float] | None = None
                ) -> list[float] | None:
    """Estimated clock offset of every rank relative to rank 0
    (seconds).

    Accepts a ``LocalUniverse`` (runs the thread ranks itself and
    returns rank 0's offsets — the original surface) OR any endpoint
    with ``rank``/``size``/``send``/``recv`` (``TcpProc``,
    ``RankContext``): then it is a COLLECTIVE — every rank calls it,
    rank 0 returns the offsets list, the rest return None.

    ``clock(rank)`` returns that rank's notion of "now" (defaults to
    the shared monotonic clock; a real-process caller passes its OWN
    clock — e.g. ``lambda r: ztrace.trace_clock()`` — the per-process
    domain the offsets are measured between)."""
    if clock is None:
        clock = lambda rank: time.monotonic()  # noqa: E731
    if isinstance(uni_or_ep, LocalUniverse):
        results = uni_or_ep.run(
            lambda ctx: _sync_body(ctx, rounds, clock))
        return results[0]
    return _sync_body(uni_or_ep, rounds, clock)


def _run_tcp_plane(n: int, skew: list[float], rounds: int
                   ) -> list[float]:  # pragma: no cover - CLI harness
    """CLI ``--plane tcp``: N real-socket ranks over loopback (threads
    hosting TcpProc endpoints), the collective sync over the wire."""
    import socket
    import threading

    from ..pt2pt.tcp import TcpProc

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs: list = [None] * n
    out: list = [None] * n
    errs: list = []

    def body(r):
        try:
            procs[r] = TcpProc(r, n, coordinator=("127.0.0.1", port))
            out[r] = sync_clocks(
                procs[r], rounds=rounds,
                clock=lambda rank, r=r: time.monotonic() + skew[r],
            )
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append((r, e))
        finally:
            if procs[r] is not None:
                procs[r].close()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"tcp sync failed: {errs}")
    return out[0]


def main(argv: list[str] | None = None) -> int:  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser(description="clock-sync demo (mpisync analog)")
    p.add_argument("-n", "--ranks", type=int, default=4)
    p.add_argument("--rounds", type=int, default=16)
    p.add_argument("--plane", choices=("threads", "tcp"),
                   default="threads",
                   help="threads = LocalUniverse thread ranks (shared "
                        "clock); tcp = real-socket TcpProc endpoints "
                        "over loopback")
    p.add_argument("--skew", type=float, nargs="*", default=None,
                   help="per-rank synthetic skew seconds")
    args = p.parse_args(argv)
    skew = args.skew or [0.0] * args.ranks
    if args.plane == "tcp":
        offsets = _run_tcp_plane(args.ranks, skew, args.rounds)
    else:
        uni = LocalUniverse(args.ranks)
        offsets = sync_clocks(
            uni, rounds=args.rounds,
            clock=lambda r: time.monotonic() + skew[r],
        )
    for r, off in enumerate(offsets):
        print(f"rank {r}: offset {off * 1e6:+.1f} us")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
