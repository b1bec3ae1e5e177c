"""The pieces of the OSU-style host-plane harness that ``tools/ztune.py``
runs its collective cells on (namesake: the repository's
``benchmarks/osu_zmpi.py``, whose ``_bench_env``, ``_sizes`` and
``_run_tcp_ranks`` these are): the worker environment, the message-size
ladder and N ``TcpProc`` ranks in threads over loopback.  The namesake's
pt2pt, sm, han, NUMA, launch and scale ladders are not ported yet.
"""

from __future__ import annotations

import os
import threading

def _bench_env(repo: str) -> dict:
    """Worker-process environment: lockdep-OFF is the bench default —
    the lock-order witness belongs to the test suite; measured paths run
    the raw primitives so the numbers are honest."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # an inherited ZMPI_LOCKDEP=1 must not instrument the workers
    env["ZMPI_LOCKDEP"] = "0"
    # an inherited fleet-global ZMPI_METRICS must not arm publishers on
    # rows that have no store; an inherited ZMPI_TRACE=1 would grow every
    # frame by the wire context and contaminate the wire-byte gates
    env.pop("ZMPI_METRICS", None)
    env.pop("ZMPI_TRACE", None)
    return env


def _sizes(max_bytes: int, min_bytes: int = 4) -> list[int]:
    out = []
    s = min_bytes
    while s <= max_bytes:
        out.append(s)
        s *= 4
    return out


def _run_tcp_ranks(n: int, fn, timeout: float = 180.0,
                   sm: bool | None = None,
                   kwargs_by_rank: dict | None = None) -> list:
    """Launch fn(proc) on n TcpProc ranks over localhost sockets; rank 0
    binds an ephemeral coordinator the others learn through the
    on_coordinator_bound hook (prte forwarding the PMIx URI).  ``sm``
    pins the shared-memory transport on/off per proc (None = MCA
    default); ``kwargs_by_rank`` adds per-rank constructor overrides
    (the han ladder's emulated-host ``sm_boot_id`` pins)."""
    from ..pt2pt.tcp import TcpProc

    coord: list = []
    coord_ready = threading.Event()
    results: list = [None] * n
    excs: list = [None] * n

    def main(rank):
        kw = dict((kwargs_by_rank or {}).get(rank, {}))
        try:
            if rank == 0:
                proc = TcpProc(
                    0, n, coordinator=("127.0.0.1", 0), sm=sm,
                    on_coordinator_bound=lambda addr: (
                        coord.append(addr), coord_ready.set()), **kw,
                )
            else:
                if not coord_ready.wait(30.0) or not coord:
                    return  # rank 0 failed; its error is in excs[0]
                proc = TcpProc(rank, n, coordinator=tuple(coord[0]),
                               sm=sm, **kw)
            try:
                results[rank] = fn(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[rank] = e
            coord_ready.set()

    threads = [threading.Thread(target=main, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for e in excs:
        if e is not None:
            raise RuntimeError(f"tcp bench rank failed: {e!r}") from e
    return results
