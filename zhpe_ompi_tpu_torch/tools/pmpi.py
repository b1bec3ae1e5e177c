"""PMPI — profiling interposition layer
(namesake: ``zhpe_ompi_tpu/tools/pmpi.py``).

The reference exposes every binding as a weak symbol aliasing ``PMPI_*``
(``ompi/mpi/c/send.c:37-39``) so a tool library can interpose any MPI call
and then invoke the real implementation.  Python has no weak symbols; the
re-design is an explicit interceptor chain at the collective dispatch
point (:meth:`zhpe_ompi_tpu_torch.comm.communicator.Communicator._coll_call`):

    def timer(opname, comm, args, kwargs, call_next):
        t0 = time.perf_counter()
        out = call_next()              # the "PMPI_" call
        record(opname, time.perf_counter() - t0)
        return out

    pmpi.attach(timer)

Interceptors stack — the last attached runs outermost, matching the
link-order semantics of PMPI tool libraries.  The monitoring component
(:mod:`zhpe_ompi_tpu_torch.coll.monitoring`) stays a *component* exactly as the
reference's monitoring is — PMPI is the tool-facing hook, not the MCA
path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

Interceptor = Callable[..., Any]  # (opname, comm, args, kwargs, call_next)

_lock = threading.Lock()
_chain: list[Interceptor] = []


def attach(interceptor: Interceptor) -> None:
    """Install an interceptor (outermost; PMPI tool link order)."""
    with _lock:
        _chain.append(interceptor)


def detach(interceptor: Interceptor) -> None:
    with _lock:
        _chain.remove(interceptor)


def active() -> bool:
    return bool(_chain)


def dispatch(opname: str, comm, fn: Callable, args: tuple, kwargs: dict):
    """Run `fn(comm, *args, **kwargs)` through the interceptor chain."""
    with _lock:
        chain = list(_chain)

    def make_call(i: int) -> Callable[[], Any]:
        if i < 0:
            return lambda: fn(comm, *args, **kwargs)
        inner = make_call(i - 1)
        layer = chain[i]
        return lambda: layer(opname, comm, args, kwargs, inner)

    return make_call(len(chain) - 1)()
