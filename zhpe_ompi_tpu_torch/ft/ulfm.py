"""ULFM: the revoked-communicator registry (namesake:
``zhpe_ompi_tpu/ft/ulfm.py``, of which only ``revoke_cid``, ``is_revoked``
and ``reset_revocations`` (``:114-130``) are ported; the failure detector,
``FailureState`` and the host-plane agreement wait for the host plane).

In the JAX package one controller dispatches every device's operation, so
its process-global set of revoked cids is the complete revocation view.
Here each GPU has its own process and its own set, and a revoke must also
reach the other ranks.  It travels through the store of the default
process group, which every rank shares:

- the revoking rank sets ``zmpi_revoked/<gid>`` (``gid`` is the id of
  the communicator's process group, agreed by its members,
  ``Communicator.gid``) and then adds one to ``zmpi_revoke_seq``;
- a watcher thread in every other rank reads ``zmpi_revoke_seq`` every
  ``POLL_S`` (50 ms); when it moves, it checks the key of each live
  group it knows and revokes the cids of its communicators there.

A revoked group stays revoked: a communicator built over it later is
revoked at once, until the group is destroyed
(``comm/communicator.forget_destroyed``).

The check in the collective path stays a lookup in the local set: no
store round trip per collective.  A revoke reaches another rank within one
poll interval plus a store round trip, and only ranks whose watcher runs
(``runtime.init()`` starts it when the world has more than one rank, and
``finalize()`` stops it).
"""

from __future__ import annotations

import threading
import weakref

from ..mca import output as mca_output
from ..runtime import flightrec, spc

_stream = mca_output.open_stream("ft")

#: seconds between the watcher's reads of the revoke sequence number
POLL_S = 0.05
SEQ_KEY = "zmpi_revoke_seq"
KEY_PREFIX = "zmpi_revoked/"

_global_lock = threading.Lock()
_REVOKED_CIDS: set[int] = set()
_REVOKED_GIDS: set[str] = set()


def revoke_cid(cid: int) -> None:
    """Process-local cid poisoning (MPIX_Comm_revoke's effect on this
    rank)."""
    with _global_lock:
        _REVOKED_CIDS.add(int(cid))
    flightrec.record(flightrec.REVOKE, cid=int(cid), plane="device")


def is_revoked(cid: int) -> bool:
    """Device-plane (Communicator) revocation check."""
    # unlocked fast path: CPython set membership is atomic enough for a
    # monotonic poison set (entries are only ever added)
    return cid in _REVOKED_CIDS


def reset_revocations() -> None:
    """Test isolation: forget every revocation of this process."""
    with _global_lock:
        _REVOKED_CIDS.clear()
        _REVOKED_GIDS.clear()


# -- across processes ---------------------------------------------------------

# gid -> communicators of this process with that gid (weakly held)
_by_gid: dict[str, weakref.WeakSet] = {}


def track(comm) -> None:
    """Remember a communicator so that a revoke of its gid on another rank
    can find it here; one built over a revoked group is revoked at once."""
    with _global_lock:
        _by_gid.setdefault(comm.gid, weakref.WeakSet()).add(comm)
        revoked = comm.gid in _REVOKED_GIDS
    if revoked:
        revoke_cid(comm.cid)


def publish_revocation(store, gid: str) -> None:
    """Tell the other ranks that the communicator ``gid`` was revoked."""
    store.set(KEY_PREFIX + gid, b"1")
    store.add(SEQ_KEY, 1)


def revoke_group(gid: str) -> int:
    """Revoke the group ``gid`` in this process: the cid of each of its
    communicators, and of any built over it later.  Returns the number
    newly revoked."""
    with _global_lock:
        _REVOKED_GIDS.add(gid)
        comms = list(_by_gid.get(gid, ()))
    n = 0
    for comm in comms:
        if not is_revoked(comm.cid):
            revoke_cid(comm.cid)
            n += 1
    return n


def forget_group(gid: str) -> None:
    """The group ``gid`` was destroyed: forget its communicators and its
    revocation, so a new group under the same name starts unrevoked."""
    with _global_lock:
        _REVOKED_GIDS.discard(gid)
        _by_gid.pop(gid, None)


class RevocationWatcher:
    """The thread that applies other ranks' revokes to this process's
    communicators (see the module docstring)."""

    def __init__(self, store):
        self.store = store
        self._halt = threading.Event()
        self._seen = int(store.add(SEQ_KEY, 0))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zmpi-revoke-watcher")
        self._thread.start()

    def poll(self) -> int:
        """One read of the sequence number; returns the number of local
        communicators newly revoked."""
        seq = int(self.store.add(SEQ_KEY, 0))
        if seq == self._seen:
            return 0
        self._seen = seq
        with _global_lock:
            gids = [g for g, comms in _by_gid.items() if len(comms)]
        n = 0
        for gid in gids:
            if self.store.check([KEY_PREFIX + gid]):
                n += revoke_group(gid)
        if n:
            spc.record("comm_revokes_received", n)
            mca_output.verbose(5, _stream, "revocation watcher: %d "
                               "communicator(s) revoked by a peer", n)
        return n

    def _run(self) -> None:
        while not self._halt.wait(POLL_S):
            try:
                self.poll()
            except RuntimeError as e:  # the store went away at teardown
                mca_output.verbose(2, _stream, "revocation watcher "
                                   "stopped: %s", e)
                return

    def stop(self, timeout: float = 5.0) -> None:
        self._halt.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
