"""Spans and counts around the calls the step makes into the collectives
layer (``comm/communicator`` -> ``coll/tuned`` -> ``coll/nccl``), taken
from outside the program: the benchmark hands the step a thin wrapper of
each ``Communicator`` it made, in the traced run only."""

from __future__ import annotations

import time

from torch.profiler import record_function

SPAN = "gpubench.coll.allreduce"


class CountingComm:
    """``comm`` with its ``allreduce`` counted and timed on the host into
    ``tally`` (``calls``, ``host_s``) and marked as a profiler span; every
    other attribute is ``comm``'s own."""

    def __init__(self, comm, tally: dict):
        self._comm = comm
        self._tally = tally

    def __getattr__(self, name):
        return getattr(self._comm, name)

    def allreduce(self, x, op=None, **kw):
        t0 = time.perf_counter()
        with record_function(SPAN):
            out = self._comm.allreduce(x, op, **kw)
        self._tally["calls"] += 1
        self._tally["host_s"] += time.perf_counter() - t0
        return out
