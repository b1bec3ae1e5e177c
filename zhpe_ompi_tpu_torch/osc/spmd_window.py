"""One-sided communication on the device plane (namesake:
``zhpe_ompi_tpu/osc/spmd_window.py``).

A window is each rank's device-resident shard; an epoch of puts, gets and
accumulates is a static schedule (target and offset lists indexed by comm
rank, the same on every rank) carried out by the SPMD plane's
point-to-point permute (``pt2pt/spmd.py``), every rank taking part in
every operation.  Functional-update semantics, as in the JAX package:
operations RETURN the updated window and leave the old shard as it was;
``fence`` closes the epoch with a dissemination barrier.

Passive target (lock/unlock/flush) needs a progress agent the device plane
does not have: those methods raise ``WinError`` pointing at the AM
component (``osc/am.py``'s ``AmWindow``).
"""

from __future__ import annotations

from .. import ops as zops
from ..core import errors
from ..pt2pt import spmd


def _sources(target_of: list[int], what: str, advice: str = "") -> list[int]:
    """Invert a static schedule: src_of[t] is the rank that targets t
    (-1 for none); two ranks aiming at one target raise."""
    src_of = [-1] * len(target_of)
    for s, t in enumerate(target_of):
        if t >= 0:
            if src_of[t] >= 0:
                raise errors.ArgError(
                    f"two ranks {what} target {t} in one schedule{advice}")
            src_of[t] = s
    return src_of


class DeviceWindow:
    """Window over this rank's shard (a tensor)."""

    def __init__(self, comm, shard):
        self.comm = comm
        self.shard = shard

    def _check(self, what: str, peers, offset_of, count: int) -> None:
        n = self.comm.size
        if len(peers) != n or len(offset_of) != n:
            raise errors.ArgError(f"need {n} targets/offsets")
        win_elems = self.shard.numel()
        for r, (t, off) in enumerate(zip(peers, offset_of)):
            if t >= 0 and off + count > win_elems:
                raise errors.WinError(
                    f"{what} rank {r}: {count} elems at offset {off} "
                    f"overruns window of {win_elems}"
                )

    def _updated(self, off: int, values):
        flat = self.shard.reshape(-1).clone()
        flat[off:off + values.numel()] = values.reshape(-1)
        return DeviceWindow(self.comm, flat.reshape(self.shard.shape))

    def put(self, values, target_of: list[int], offset_of: list[int]
            ) -> "DeviceWindow":
        """Every rank r puts ``values`` (its local tensor) into the window
        of ``target_of[r]`` at element offset ``offset_of[r]`` (-1 in
        target_of: no put from that rank).  Returns the updated window."""
        self._check("put from", target_of, offset_of, values.numel())
        src = _sources(target_of, "put to")[self.comm.rank]
        moved = spmd.sendrecv(self.comm, values, target_of)
        if src < 0:
            return DeviceWindow(self.comm, self.shard)
        return self._updated(offset_of[src], moved)

    def get(self, source_of: list[int], offset_of: list[int], count: int):
        """Every rank r reads ``count`` elements at ``offset_of[r]`` from
        the window of ``source_of[r]``: the schedule is static, so the
        source slices and sends."""
        self._check("get by", source_of, offset_of, count)
        dest_of = _sources(source_of, "get from")
        serve = [0] * self.comm.size
        for r, s in enumerate(source_of):
            if s >= 0:
                serve[s] = offset_of[r]
        off = serve[self.comm.rank]
        sliced = self.shard.reshape(-1)[off:off + count]
        return spmd.sendrecv(self.comm, sliced, dest_of)

    def accumulate(self, values, target_of: list[int],
                   offset_of: list[int], op: zops.Op = zops.SUM
                   ) -> "DeviceWindow":
        """MPI_Accumulate with a static schedule: the target combines what
        arrives with its window as ``op(arrived, current)``."""
        self._check("accumulate from", target_of, offset_of, values.numel())
        src = _sources(target_of, "accumulate to",
                       "; split into multiple epochs")[self.comm.rank]
        moved = spmd.sendrecv(self.comm, values, target_of)
        if src < 0:
            return DeviceWindow(self.comm, self.shard)
        off = offset_of[src]
        moved = moved.reshape(-1)
        cur = self.shard.reshape(-1)[off:off + moved.numel()]
        return self._updated(off, op(moved, cur))

    # -- passive target: not expressible on the device plane -------------
    _PASSIVE_MSG = (
        "DeviceWindow runs whole RMA epochs (active target: "
        "put/get/accumulate/fence); passive-target {0} is a host-plane "
        "concept — create the window through the AM component "
        "(zhpe_ompi_tpu_torch.osc.am.AmWindow, or osc.direct's "
        "DirectWindow for same-host ranks) for lock/unlock/flush "
        "semantics."
    )

    def lock(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("lock"))

    def lock_all(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("lock_all"))

    def unlock(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("unlock"))

    def unlock_all(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("unlock_all"))

    def flush(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("flush"))

    def flush_all(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("flush_all"))

    def flush_local(self, *a, **k):
        raise errors.WinError(self._PASSIVE_MSG.format("flush_local"))

    def fence(self) -> "DeviceWindow":
        """Epoch boundary: a dissemination barrier over the communicator
        (every rank has arrived when it returns); the shard is unchanged,
        with no pass over the window."""
        from ..coll import algorithms as alg

        alg.barrier_dissemination(self.comm)
        return DeviceWindow(self.comm, self.shard)
