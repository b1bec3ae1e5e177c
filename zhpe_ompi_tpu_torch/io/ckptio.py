"""Collective checkpoint I/O — the OMPIO-analog two-phase plane (namesake:
``zhpe_ompi_tpu/io/ckptio.py``).

``runtime/checkpoint.py`` is the serial half of the story: one writer
saves one process's pytree.  This module is the COLLECTIVE half the
reference's io/fcoll/fbtl stack exists for, re-shaped for recovery time
as a first-class metric: every rank contributes its own shard of the
job state, the shards ride an fcoll-style two-phase exchange over the
han locality hierarchy, and a manifest of digests makes torn shards a
LOUD degradation instead of a silent load.

The write path (``CollectiveCheckpointer.save``):

1. **snapshot** — the state pytree is flattened and each rank copies its
   byte-range shard of every leaf to the host NOW (the caller may
   overwrite its tensors immediately; near-equal chunks, so restore
   re-assembles exact full leaves in ``ZeroOptimizer.reshard``-
   compatible full-state form regardless of the restoring mesh's size).
2. **phase one (metadata exchange)** — one allgather carries every
   rank's per-leaf ``(nbytes, digest, skip)`` vector; offsets into the
   step's data file fall out as prefix sums every rank computes
   identically.  A shard whose digest matches the previous complete
   manifest's entry is SKIPPED (``ckpt_delta_skips``) — the manifest
   re-links the previous step's bytes instead of re-writing them (the
   incremental/delta checkpoint).
3. **phase two (shuffle + stream)** — non-aggregator ranks isend their
   shard bytes to their HOST's aggregator (the locality-group leader,
   ``pt2pt/groups.locality_groups``) on a dedicated ckpt cid: one send
   per shard to ONE destination, riding the sm rings — never the flat
   all-pairs O(n²) (``ckpt_gather_bytes`` is the wire-delta gate).
   The sends ride the deferred-contract isend engine, so ``save``
   returns while the exchange drains: training steps keep committing
   (``ckpt_async_overlapped``) between the ``ckpt_begin`` and
   ``ckpt_commit`` flightrec events.
4. **stream** — each aggregator's background writer coalesces its
   group's shards into maximal runs (the fcoll two-phase sort) and
   streams them through the fbtl backend under a
   ``utils/deadline.Watchdog``-bounded retry ladder
   (``ckpt_write_retries`` attempts, backoff, then a typed
   :class:`CheckpointWriteError` — a wedged write becomes a FAULT,
   never a hang), then sends a done token to global rank 0.
5. **commit** — rank 0 collects the done tokens, writes the treedef
   and the manifest (shard → rank/offset/digest), and publishes the
   manifest atomically (tmp + rename).  A crash ANYWHERE before the
   rename leaves a step directory with no complete manifest, which
   restore heals away — the newest COMPLETE step is always the
   rollback point.  Rank 0 then releases every other rank with a
   commit token, so no rank's drain (and hence no blocking ``save``
   or ``wait``) finishes before the manifest outcome is settled — a
   fast member must never ``heal()`` the step directory out from
   under a still-streaming aggregator.

The read path (``restore``): walk complete manifests newest-first;
verify EVERY shard digest (and the treedef's) before unpickling
anything; a torn/corrupt shard counts in ``ckpt_integrity_rejects``
and degrades LOUDLY to the previous complete step
(``ckpt_degraded_restores``) — never a raise mid-recovery, never a
silent acceptance.  Restore is local (shared-filesystem contract, the
same one MPI-IO assumes), so a 3-rank survivor mesh restores a 4-rank
job's state without the dead rank.

Fault-seam hooks: ``ft/inject.py`` arms per-rank checkpoint-seam
faults (kill an aggregator mid-exchange, kill a writer mid-stream,
wedge an fbtl write past its deadline) through
:func:`install_fault_hook`; the plane consults :func:`fault_point` at
each seam.  :func:`corrupt_shard` flips bytes on disk for the torn-
shard drills.

Hygiene is observable like every other plane's: writer threads
register (:func:`live_writer_threads` must be [] once owners joined),
checkpoint roots register so a test gate can assert zero orphaned shard
temps (:func:`orphaned_shard_temps`) and zero incomplete manifests
(:func:`incomplete_manifests`) after every test.

What differs from the namesake, in form only:

- The tree is flattened with ``torch.utils._pytree`` in the namesake's leaf
  order (``utils.payload.tree_flatten``: a dict's keys sorted), so
  leaf ``i``, its shards, their offsets in the data file and their digests
  are the namesake's for the same state.
- A tensor's shard is taken from its bytes: only this rank's byte range is
  copied to the host (a synchronous copy), and a bfloat16 tensor is read
  as ``int16``, so its bytes and digests are those of the namesake's
  ``ml_dtypes.bfloat16`` array; the manifest names its dtype
  ``"bfloat16"``.  A leaf must be a tensor, a numpy array or a number.
- The tree's structure is the torch treespec string
  (``pytree.treespec_dumps``) in ``treespec.<gen>.json``, where the
  namesake pickles its treedef (``treedef.<gen>.pkl``), so neither package
  restores the other's directory; the manifest's shard entries are the
  same.
- ``restore`` returns tensors on the device the caller names (``shardings``:
  a device for every leaf, or a pytree of devices, a prefix of the
  state's structure), the card by default; the namesake returns numpy
  arrays or arrays of its shardings.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import flightrec, spc, ztrace
from ..utils.payload import tree_flatten
from . import fbtl as fbtl_mod

_stream = mca_output.open_stream("ckptio")

mca_var.register(
    "ckpt_write_deadline_s", 30.0,
    "Seconds one fbtl checkpoint write may take before its deadline "
    "watchdog declares the attempt wedged and the retry ladder takes "
    "over (utils/deadline.Watchdog bounds every stream write)",
    type=float,
)
mca_var.register(
    "ckpt_write_retries", 3,
    "Wedged/failed checkpoint-write attempts retried (with backoff) "
    "before the writer surfaces a typed CheckpointWriteError — the "
    "wedge becomes a fault, never a hang",
    type=int,
)
mca_var.register(
    "ckpt_delta", 1,
    "Incremental checkpoints: skip shards whose digest matches the "
    "previous complete manifest's entry (the manifest re-links the "
    "prior step's bytes); 0 re-writes every shard every step",
    type=int,
)

#: dedicated ckpt cid window: above the han span (0x7900..0x79FF),
#: below the control/collective cids (COLL_CID at 0x7FF0+), within 16
#: bits so ShrunkEndpoint generation translation preserves it
CKPT_CID_BASE = 0x7A00
CKPT_CID_WINDOWS = 0xF0
#: the aggregator → rank-0 done-token channel
CKPT_LEADER_CID = CKPT_CID_BASE + 0xFF

_MAGIC = "ZMPICKPT1"
_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"


class CheckpointWriteError(errors.InternalError):
    """A checkpoint stream write exhausted its deadline/retry budget —
    the typed surface of a wedged fbtl backend (counted in
    ``ckpt_write_deadline_failures``)."""


# -- hygiene registries (consumed by the conftest session gate) -------------

_lock = threading.Lock()
_WRITER_THREADS: list[threading.Thread] = []
_CKPT_ROOTS: set[str] = set()


def _register_writer(t: threading.Thread) -> None:
    with _lock:
        _WRITER_THREADS[:] = [x for x in _WRITER_THREADS if x.is_alive()]
        _WRITER_THREADS.append(t)


def live_writer_threads() -> list[str]:
    """Async checkpoint writer/aggregator threads still running — must
    be [] once every checkpointer's owner waited/closed (a survivor
    here is a leaked stream)."""
    with _lock:
        _WRITER_THREADS[:] = [x for x in _WRITER_THREADS if x.is_alive()]
        return [t.name for t in _WRITER_THREADS]


def register_root(path: str) -> None:
    with _lock:
        _CKPT_ROOTS.add(os.path.abspath(path))


def _roots() -> list[str]:
    with _lock:
        return [d for d in _CKPT_ROOTS if os.path.isdir(d)]


def orphaned_shard_temps() -> list[str]:
    """``*.tmp`` shard/manifest partials left in any registered
    checkpoint root — a healthy plane leaves none (the atomic-publish
    rename consumes the manifest tmp; killed writers' partials are
    healed away by the next restore)."""
    out = []
    for root in _roots():
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in filenames:
                if name.endswith(".tmp"):
                    out.append(os.path.join(dirpath, name))
    return sorted(out)


def incomplete_manifests() -> list[str]:
    """Step directories without a COMPLETE manifest in any registered
    root — a crashed writer leaves one, the next restore's heal removes
    it; one surviving a test means nobody drove recovery."""
    out = []
    for root in _roots():
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if not (name.startswith(_STEP_PREFIX) and os.path.isdir(d)):
                continue
            if _read_manifest(d) is None:
                out.append(d)
    return out


# -- fault-seam hooks (armed by ft/inject.py) --------------------------------

_FAULT_HOOKS: list[Callable] = []


def install_fault_hook(hook: Callable) -> Callable[[], None]:
    """Register a checkpoint-seam fault hook (``hook(seam, rank,
    **info)``); returns the remover.  Hooks fire synchronously at the
    seams — a hook raises/kills/sleeps to inject its fault."""
    with _lock:
        _FAULT_HOOKS.append(hook)

    def remove() -> None:
        with _lock:
            if hook in _FAULT_HOOKS:
                _FAULT_HOOKS.remove(hook)

    return remove


def fault_point(seam: str, rank: int, **info: Any) -> None:
    """One checkpoint seam: consult every armed hook (deterministic
    order).  Hot-path cheap: the common case is an empty list."""
    if not _FAULT_HOOKS:
        return
    with _lock:
        hooks = list(_FAULT_HOOKS)
    for hook in hooks:
        hook(seam, rank, **info)


# -- manifest helpers --------------------------------------------------------


def _digest(data) -> str:
    """blake2b-128 of a bytes object or a contiguous array, with no copy."""
    return hashlib.blake2b(memoryview(data), digest_size=16).hexdigest()


def _leaf_dtype(leaf) -> str:
    """The manifest's dtype name of a leaf: numpy's, with ``bfloat16`` for
    a bfloat16 tensor (the namesake's ``ml_dtypes`` name)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(leaf.dtype)


def _leaf_bytes(leaf, lo: int, hi: int, staging=None) -> np.ndarray:
    """A host copy of bytes [lo, hi) of a leaf's C-order storage (of a
    tensor, only that range crosses to the host: a CUDA tensor's into the
    pinned ``staging`` tensor, when given, at the copy engine's rate)."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        part = flat.view(torch.uint8)[lo:hi]
        if staging is not None and part.is_cuda:
            return staging.copy_(part).numpy()
        return part.to("cpu", copy=True).numpy()
    return leaf.reshape(-1).view(np.uint8)[lo:hi].copy()


def _host_form(leaf):
    """A tensor as it is, anything else as a C-contiguous numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.kind in "OUSV":
        raise errors.ArgError(
            f"cannot checkpoint a leaf of dtype {arr.dtype}: leaves are "
            "tensors, numeric numpy arrays or numbers")
    return arr


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of a leaf's dtype and shape over a copy of ``raw``."""
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr)


def _read_manifest(step_dir: str) -> dict | None:
    """The step's manifest if it is COMPLETE, else None (missing,
    unparsable, foreign magic, or published without the completeness
    marker — all the same thing to restore: not a rollback point)."""
    path = os.path.join(step_dir, _MANIFEST)
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if m.get("magic") != _MAGIC or not m.get("complete"):
        return None
    return m


def corrupt_shard(directory: str, step: int | None = None,
                  leaf: int = 0, rank: int = 0) -> str:
    """TEST SEAM: flip the bytes of one shard on disk (the torn-shard
    drill).  Returns the file corrupted.  Restore must detect it by
    digest, count it in ``ckpt_integrity_rejects`` and degrade to the
    previous complete step."""
    steps = _complete_steps(directory)
    if step is None:
        if not steps:
            raise errors.ArgError(f"no complete checkpoint in {directory}")
        step = steps[-1]
    m = _read_manifest(os.path.join(directory, f"{_STEP_PREFIX}{step}"))
    if m is None:
        raise errors.ArgError(f"no complete manifest for step {step}")
    for entry in m["shards"]:
        if entry["leaf"] == leaf and entry["rank"] == rank:
            if entry["nbytes"] == 0:
                raise errors.ArgError("cannot corrupt an empty shard")
            path = os.path.join(directory, entry["file"])
            with open(path, "r+b") as f:
                f.seek(entry["offset"])
                raw = f.read(entry["nbytes"])
                f.seek(entry["offset"])
                f.write(bytes(b ^ 0xFF for b in raw))
            return path
    raise errors.ArgError(f"no shard (leaf={leaf}, rank={rank}) in "
                          f"step {step}")


def _complete_steps(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX):
            continue
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue
        if _read_manifest(os.path.join(directory, name)) is not None:
            out.append(step)
    return sorted(out)


# -- the deadline-bounded stream write ---------------------------------------


def _deadline_pwritev(base: fbtl_mod.FbtlComponent, fd: int, runs,
                      data: np.ndarray, rank: int) -> int:
    """One coalesced stream write, bounded: every attempt runs under a
    ``utils/deadline.Watchdog``; a wedged/raising attempt is retried
    with backoff (``ckpt_write_retries``) before surfacing the typed
    :class:`CheckpointWriteError`.  pwrite is idempotent at fixed
    offsets, so a late-but-landed attempt re-written by its retry is
    harmless."""
    from ..utils import deadline as deadline_mod

    deadline_s = float(mca_var.get("ckpt_write_deadline_s", 30.0))
    retries = int(mca_var.get("ckpt_write_retries", 3))
    last: BaseException | None = None
    for attempt in range(retries + 1):
        if attempt:
            spc.record("ckpt_write_retries")
            time.sleep(min(0.05 * (2 ** (attempt - 1)), 1.0))  # backoff
        done = threading.Event()
        outcome: dict[str, Any] = {}

        def attempt_write(done=done, outcome=outcome):
            try:
                fault_point("write", rank, attempt=attempt)
                outcome["n"] = base.pwritev(fd, list(runs), data)
            except BaseException as e:  # noqa: BLE001 - crosses threads
                outcome["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=attempt_write, daemon=True,
                             name=f"zmpi-ckpt-write-r{rank}")
        _register_writer(t)
        expired = threading.Event()
        wd = deadline_mod.Watchdog(deadline_s, expired.set,
                                   name=f"ckpt-write-wd-r{rank}")
        wd.arm()
        t.start()
        try:
            while not done.is_set() and not expired.is_set():
                done.wait(0.05)
        finally:
            wd.disarm()
        if not done.is_set():
            # wedged past the deadline: abandon the attempt (the hung
            # syscall's thread drains on its own; pwrite idempotence
            # makes its eventual landing harmless) and retry
            last = CheckpointWriteError(
                f"checkpoint write wedged past {deadline_s:.1f}s "
                f"deadline (attempt {attempt + 1})")
            mca_output.verbose(1, _stream,
                               "rank %d: %s", rank, last)
            continue
        err = outcome.get("err")
        if err is None:
            return int(outcome["n"])
        if not isinstance(err, Exception):
            raise err  # a BaseException (injected kill) is the rank's
            # own death, not a retryable I/O outcome
        last = err
        mca_output.verbose(1, _stream,
                           "rank %d: checkpoint write attempt %d "
                           "failed: %r", rank, attempt + 1, err)
    spc.record("ckpt_write_deadline_failures")
    raise CheckpointWriteError(
        f"checkpoint write failed after {retries + 1} attempts: {last!r}")


# -- the collective checkpointer ---------------------------------------------


class CollectiveCheckpointer:
    """Sharded collective checkpoint/restore over a directory.

    Duck-type compatible with :class:`~zhpe_ompi_tpu_torch.runtime.
    checkpoint.Checkpointer` (``save``/``wait``/``restore``/``all_steps``/
    ``latest_step``), so ``FtTrainLoop`` and ``ft/recovery.rollback``
    drive it unchanged — plus the collective surface: construct one per
    rank over a SHARED directory, :meth:`bind` the current live
    endpoint, and every rank's ``save(step, state)`` call is collective
    over it.  ``ep=None`` (or size 1) is the degenerate single-writer
    mode: same manifest/digest/delta/deadline machinery, no exchange —
    the thread-plane unit tests and single-rank jobs.
    """

    #: FtTrainLoop reads this to choose non-blocking saves (the
    #: snapshot-then-stream overlap)
    async_capable = True

    def __init__(self, directory: str, ep=None, keep: int = 3,
                 check_quiescent: bool = True,
                 drain_timeout: float = 60.0):
        self.directory = directory
        self.ep = ep
        self.keep = keep
        self.check_quiescent = check_quiescent
        self.drain_timeout = float(drain_timeout)
        os.makedirs(directory, exist_ok=True)
        register_root(directory)
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        # save/wait/restore serialize under one reentrant lock, the
        # runtime/checkpoint.py discipline: concurrent survivor
        # rollbacks must not double-join the worker or race the heal
        self._op_lock = threading.RLock()
        #: per-save statistics of the LAST completed local save (tests
        #: and benchmarks read them; cross-rank truth is the counters)
        self.last_stats: dict[str, Any] = {}
        self._pinned: torch.Tensor | None = None

    # -- topology ----------------------------------------------------------

    def bind(self, ep) -> None:
        """Adopt the current live endpoint (FtTrainLoop re-binds after
        every recovery: the survivor mesh is a fresh endpoint).  The
        ckpt cids alias to the logical collective cid, so a recovery's
        ``revoke(COLL_CID)`` unblocks gather recvs parked on a dead
        peer exactly like the flat collectives'."""
        self.ep = ep
        if ep is None:
            return
        state = getattr(ep, "ft_state", None)
        if state is not None and hasattr(state, "alias_cid"):
            from ..coll.host import COLL_CID

            for w in range(CKPT_CID_WINDOWS):
                state.alias_cid(CKPT_CID_BASE + w, COLL_CID)
            state.alias_cid(CKPT_LEADER_CID, COLL_CID)

    def _topology(self):
        """(rank, size) of the bound endpoint — (0, 1) when absent or
        singleton (everyone their own aggregator, no exchange)."""
        ep = self.ep
        if ep is None or getattr(ep, "size", 1) <= 1:
            return 0, 1
        return ep.rank, ep.size

    def _my_boot_token(self, rank: int):
        """This rank's OWN locality identity, contributed into the
        phase-one metadata exchange."""
        if self.ep is None:
            return None
        from ..pt2pt import groups as groups_mod

        return groups_mod.boot_token_of(self.ep, rank)

    @staticmethod
    def _consensus_groups(meta_all):
        """The han host-group map derived from the EXCHANGED locality
        tokens, identically on every rank.  Local ``locality_groups``
        views legitimately diverge after a recovery (a rejoiner is a
        singleton to peers whose modex card for it is stale, and sees
        stale cards itself) — a split-brain group map deadlocks the
        done-token/commit-release protocol, so the aggregator election
        must ride the same collective the shard metadata does.  A rank
        with no provable locality (token None) is its own singleton
        group, exactly as in ``pt2pt.groups.locality_groups``."""
        tok_by_rank = {int(e["rank"]): e.get("loc") for e in meta_all}
        by_token: dict[str, list[int]] = {}
        groups: list[list[int]] = []
        for r in sorted(tok_by_rank):
            tok = tok_by_rank[r]
            if tok is None:
                groups.append([r])
                continue
            members = by_token.get(tok)
            if members is None:
                members = by_token[tok] = [r]
                groups.append(members)
            else:
                members.append(r)
        groups.sort(key=lambda g: g[0])
        return groups or [[0]]

    # -- save --------------------------------------------------------------

    def save(self, step: int, state, blocking: bool = False) -> None:
        """Collective sharded snapshot of ``state`` at ``step``.
        Snapshot (host copy + metadata exchange + shard isends) happens
        NOW; the stream (aggregation, fbtl writes, manifest commit)
        drains in the background unless ``blocking`` — the
        snapshot-then-stream overlap."""
        from ..runtime import checkpoint as ckpt_mod

        if self.check_quiescent:
            ckpt_mod.quiesce_check()
        with self._op_lock:
            # zlint: disable=ZL002 -- save/wait/restore serialize under ONE RLock; the writer thread never takes it
            self.wait()  # one outstanding checkpoint at a time
            step = int(step)
            leaves, treedef = tree_flatten(state)
            host_leaves = [_host_form(leaf) for leaf in leaves]
            rank, size = self._topology()
            # crash-epoch watermark for the commit-release wait: any
            # crash learned AFTER this point means the release token
            # may never arrive (its sender, or the commit it reports
            # on, is gone) — the drain abandons with a typed peer
            # fault instead of riding out drain_timeout.  Cumulative
            # epoch, not the failed set: a respawned rank 0 clears
            # its failed status long before a parked release recv
            # would otherwise notice.
            st = getattr(self.ep, "ft_state", None)
            epoch0 = st.crash_epoch() if st is not None else 0
            flightrec.record(flightrec.CKPT_BEGIN, step=step, rank=rank)
            sp = ztrace.begin(ztrace.CKPT, rank, step=step) \
                if ztrace.active else None

            # my byte-range shard of every leaf + phase-one metadata
            delta_on = bool(int(mca_var.get("ckpt_delta", 1)))
            prev = self._prev_manifest() if delta_on else None
            shards, meta = self._my_shards(host_leaves, prev, rank, size)
            gen = self._next_gen(step) if rank == 0 else 0
            entry = {"rank": rank, "gen": gen, "shards": meta,
                     "loc": self._my_boot_token(rank) if size > 1
                     else None}
            if size > 1:
                from ..coll import host as host_coll

                meta_all = host_coll.allgather(self.ep, entry)
            else:
                meta_all = [entry]
            plan = self._offsets(meta_all, step)
            # aggregator election by CONSENSUS, from the same exchange
            # the plan rides — never from the local locality view,
            # which diverges across a recovery (see _consensus_groups)
            groups = self._consensus_groups(meta_all)
            gi = next(i for i, g in enumerate(groups) if rank in g)
            agg = groups[gi][0]
            mca_output.verbose(
                1, _stream,
                "save step %d: rank=%d size=%d agg=%d groups=%s",
                step, rank, size, agg, groups)

            # phase two: non-aggregators isend their live shards to
            # the host aggregator (one destination, deferred engine)
            reqs = []
            if rank != agg:
                cid = CKPT_CID_BASE + (gi % CKPT_CID_WINDOWS)
                for li, data in shards.items():
                    if plan[(li, rank)].get("skip"):
                        continue
                    fault_point("gather", rank, leaf=li, step=step)
                    spc.record("ckpt_gather_bytes", int(data.size))
                    reqs.append(self.ep.isend(
                        data, agg, tag=step * 1024 + li, cid=cid))
            self.last_stats = {
                "step": step, "rank": rank, "aggregator": agg,
                "gather_sends": len(reqs),
                "gather_dests": {agg} if reqs else set(),
                "delta_skips": sum(
                    1 for m in meta if m.get("skip")),
            }

            def drain():
                try:
                    self._drain(step, plan, meta_all, groups, gi, agg,
                                rank, size, shards, reqs, treedef, sp,
                                epoch0)
                except BaseException as e:  # noqa: BLE001 - see wait()
                    self._error = e

            if blocking:
                drain()
                self._raise_pending()
            else:
                self._worker = threading.Thread(
                    target=drain, daemon=True,
                    name=f"zmpi-ckpt-writer-r{rank}")
                _register_writer(self._worker)
                self._worker.start()

    def _staging(self, host_leaves, rank: int, size: int) -> dict:
        """Pinned host views for this rank's byte range of every CUDA leaf,
        carved from one buffer kept across saves (a save first waits out the
        previous stream, so nothing still reads the buffer): by leaf index."""
        spans = {}
        for li, leaf in enumerate(host_leaves):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                nbytes = leaf.numel() * leaf.element_size()
                spans[li] = nbytes * (rank + 1) // size - nbytes * rank // size
        total = sum(spans.values())
        if not total:
            return {}
        if self._pinned is None or self._pinned.numel() < total:
            self._pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        out, pos = {}, 0
        for li, n in spans.items():
            out[li] = self._pinned[pos:pos + n]
            pos += n
        return out

    def _my_shards(self, host_leaves, prev, rank: int, size: int):
        """This rank's byte-range chunk of every leaf, plus its
        phase-one metadata vector (nbytes/digest/skip — the skip
        decision compares against the previous complete manifest's
        matching entry: the delta checkpoint)."""
        prev_entries = {}
        if prev is not None and int(prev.get("world", -1)) == size:
            for e in prev["shards"]:
                prev_entries[(e["leaf"], e["rank"])] = e
        shards: dict[int, np.ndarray] = {}
        meta = []
        staging = self._staging(host_leaves, rank, size)
        for li, leaf in enumerate(host_leaves):
            nbytes = (leaf.numel() * leaf.element_size()
                      if isinstance(leaf, torch.Tensor) else leaf.nbytes)
            lo = nbytes * rank // size
            hi = nbytes * (rank + 1) // size
            chunk = _leaf_bytes(leaf, lo, hi, staging.pop(li, None))
            dig = _digest(chunk)
            old = prev_entries.get((li, rank))
            skip = bool(old is not None and old["digest"] == dig
                        and old["nbytes"] == chunk.size)
            if skip:
                spc.record("ckpt_delta_skips")
            else:
                shards[li] = chunk
            meta.append({
                "leaf": li, "nbytes": int(chunk.size), "digest": dig,
                "skip": skip,
                "ref": ({"file": old["file"], "offset": old["offset"]}
                        if skip else None),
                "dtype": _leaf_dtype(leaf), "shape": list(leaf.shape),
                "leaf_off": int(lo),
            })
        return shards, meta

    def _prev_manifest(self) -> dict | None:
        steps = _complete_steps(self.directory)
        if not steps:
            return None
        return _read_manifest(
            os.path.join(self.directory, f"{_STEP_PREFIX}{steps[-1]}"))

    def _next_gen(self, step: int) -> int:
        """Data-file generation for a re-checkpointed step: the old
        manifest keeps referencing ``data.<g>.bin`` while the new
        writer streams into ``data.<g+1>.bin``, so the atomic manifest
        rename is the ONLY commit point (a crash mid-rewrite degrades
        to the old complete version, never to torn bytes)."""
        m = _read_manifest(
            os.path.join(self.directory, f"{_STEP_PREFIX}{step}"))
        return int(m.get("gen", 0)) + 1 if m is not None else 0

    def _offsets(self, meta_all, step: int) -> dict:
        """The deterministic (leaf, rank) → placement plan every rank
        derives identically from the phase-one exchange: live shards
        pack densely into this step's data file (prefix sums in
        (leaf, rank) order), skipped shards carry their previous-step
        reference."""
        gen = int(meta_all[0].get("gen", 0))
        data_file = f"{_STEP_PREFIX}{step}/data.{gen}.bin"
        plan: dict = {"__gen__": gen, "__file__": data_file,
                      "__n_leaves__": len(meta_all[0]["shards"])}
        off = 0
        by_rank = {int(e["rank"]): e for e in meta_all}
        n_leaves = len(meta_all[0]["shards"])
        for li in range(n_leaves):
            for r in sorted(by_rank):
                m = by_rank[r]["shards"][li]
                if m["skip"]:
                    plan[(li, r)] = {"skip": True, "ref": m["ref"],
                                     "meta": m}
                else:
                    plan[(li, r)] = {"skip": False, "offset": off,
                                     "file": data_file, "meta": m}
                    off += int(m["nbytes"])
        return plan

    def _drain(self, step, plan, meta_all, groups, gi, agg, rank, size,
               shards, reqs, treedef, sp, epoch0=0) -> None:
        """The background half: complete the gather sends
        (non-aggregators), or receive + coalesce + stream the group's
        shards and token rank 0 (aggregators), or additionally collect
        the tokens and commit the manifest (rank 0)."""
        wrote = 0
        try:
            for r in reqs:
                r.wait(self.drain_timeout)
            if rank == agg:
                wrote = self._aggregate(step, plan, gi, groups[gi], rank,
                                        shards)
                if size > 1 and rank != 0:
                    cid = CKPT_LEADER_CID
                    self.ep.isend({"step": step, "agg": rank,
                                   "shards": wrote}, 0, tag=step,
                                  cid=cid).wait(self.drain_timeout)
            if rank == 0:
                others = [g[0] for g in groups if g[0] != 0]
                for a in others:
                    self.ep.recv(source=a, tag=step, cid=CKPT_LEADER_CID,
                                 timeout=self.drain_timeout)
                self._commit(step, plan, meta_all, size, treedef)
            elif size > 1:
                self._await_release(step, epoch0)
        finally:
            # commit release: no rank's drain may finish before the
            # manifest outcome is settled — a fast member returning
            # early would heal() the step directory out from under
            # aggregators still streaming into it.  Sent on EVERY exit
            # path of rank 0's drain (a dead member aborting the gather
            # or a dead aggregator aborting the commit included), so
            # survivors unblock promptly instead of riding out
            # drain_timeout and wedging the recovery agreement; a send
            # to a rank that itself died is not our fault to report
            # (recovery owns peer faults).
            if rank == 0:
                for r in range(1, size):
                    try:
                        self.ep.isend(
                            {"step": step, "released": True}, r, tag=step,
                            cid=CKPT_LEADER_CID).wait(self.drain_timeout)
                        mca_output.verbose(
                            1, _stream,
                            "step %d release sent to rank %d", step, r)
                    except errors.MpiError as e:
                        mca_output.verbose(
                            1, _stream,
                            "step %d commit release to rank %d dropped:"
                            " %r", step, r, e)
        if sp is not None:
            sp.end(step=step, shards=wrote)
        self.last_stats["shards_written"] = wrote

    def _await_release(self, step: int, epoch0: int) -> None:
        """Wait for rank 0's commit-release token, crash-aware:
        short-poll recvs so a releaser that died (or a crash that
        aborted the commit the token would report on) surfaces as a
        typed peer fault within one poll period instead of a
        drain_timeout stall.  The cumulative crash epoch is the
        abandon signal, NOT the failed set — a respawned rank 0
        clears its failed status long before a parked release recv
        would ever observe it."""
        st = getattr(self.ep, "ft_state", None)
        poll_s = min(0.25, self.drain_timeout)
        deadline = time.monotonic() + self.drain_timeout
        mca_output.verbose(1, _stream,
                           "awaiting step %d release (epoch0=%d)",
                           step, epoch0)
        while True:
            try:
                self.ep.recv(source=0, tag=step, cid=CKPT_LEADER_CID,
                             timeout=poll_s)
                mca_output.verbose(1, _stream, "step %d released", step)
                return
            except errors.ProcFailed:
                raise
            except errors.MpiError:
                if st is not None and st.crash_epoch() > epoch0:
                    raise errors.ProcFailed(
                        f"checkpoint step {step} commit release "
                        "abandoned: a peer crashed during the drain",
                        failed_ranks=st.failed(),
                    ) from None
                if time.monotonic() >= deadline:
                    raise

    def _aggregate(self, step, plan, gi, members, rank, shards) -> int:
        """One aggregator's stream: collect the group's live shards
        (own chunks directly, members' over the ckpt window), sort and
        coalesce into maximal contiguous runs (the fcoll two-phase
        pass over byte extents), and stream through the
        deadline-bounded fbtl write."""
        cid = CKPT_CID_BASE + (gi % CKPT_CID_WINDOWS)
        n_leaves = plan["__n_leaves__"]
        pieces: list[tuple[int, np.ndarray]] = []
        got = 0
        for li, data in shards.items():
            pieces.append((plan[(li, rank)]["offset"], data))
            got += 1
            fault_point("aggregate", rank, idx=got, leaf=li, src=rank,
                        step=step)
        for r in members:
            if r == rank:
                continue
            for li in range(n_leaves):
                ent = plan.get((li, r))
                if ent is None or ent.get("skip"):
                    continue
                data = self.ep.recv(source=r, tag=step * 1024 + li,
                                    cid=cid, timeout=self.drain_timeout)
                pieces.append(
                    (ent["offset"],
                     np.ascontiguousarray(np.asarray(data)).view(np.uint8)))
                got += 1
                fault_point("aggregate", rank, idx=got, leaf=li, src=r,
                            step=step)
        step_dir = os.path.join(self.directory, f"{_STEP_PREFIX}{step}")
        os.makedirs(step_dir, exist_ok=True)
        if not pieces:
            return 0
        # the fcoll two-phase coalesce: sort by file offset, merge
        # adjacent extents into maximal runs, one gathered stream write
        pieces.sort(key=lambda p: p[0])
        data = np.concatenate([p[1] for p in pieces]) \
            if len(pieces) > 1 else pieces[0][1]
        runs: list[tuple[int, int]] = []
        for off, buf in pieces:
            if runs and runs[-1][0] + runs[-1][1] == off:
                runs[-1] = (runs[-1][0], runs[-1][1] + int(buf.size))
            else:
                runs.append((off, int(buf.size)))
        base = fbtl_mod.select_fbtl()
        path = os.path.join(self.directory, plan["__file__"])
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            wrote = _deadline_pwritev(base, fd, runs, data, rank)
        finally:
            os.close(fd)
        spc.record("ckpt_shards_written", got)
        spc.record("ckpt_bytes_written", wrote)
        return got

    def _commit(self, step, plan, meta_all, size, treedef) -> None:
        """Rank 0's commit: the treespec alongside the data, then the
        manifest published by tmp + atomic rename — the ONLY point a
        step becomes a rollback candidate."""
        step_dir = os.path.join(self.directory, f"{_STEP_PREFIX}{step}")
        os.makedirs(step_dir, exist_ok=True)
        gen = plan["__gen__"]
        td_raw = json.dumps(pytree.treespec_dumps(treedef)).encode()
        td_rel = f"{_STEP_PREFIX}{step}/treespec.{gen}.json"
        with open(os.path.join(self.directory, td_rel), "wb") as f:
            f.write(td_raw)
        by_rank = {int(e["rank"]): e for e in meta_all}
        entries = []
        total = 0
        for li in range(plan["__n_leaves__"]):
            for r in sorted(by_rank):
                ent = plan[(li, r)]
                m = ent["meta"]
                if ent.get("skip"):
                    file, off = ent["ref"]["file"], ent["ref"]["offset"]
                else:
                    file, off = ent["file"], ent["offset"]
                    total += int(m["nbytes"])
                entries.append({
                    "leaf": li, "rank": r, "file": file,
                    "offset": int(off), "nbytes": int(m["nbytes"]),
                    "digest": m["digest"],
                })
        manifest = {
            "magic": _MAGIC, "step": step, "gen": gen, "world": size,
            "n_leaves": plan["__n_leaves__"],
            "leaves": [{"dtype": m["dtype"], "shape": m["shape"]}
                       for m in meta_all[0]["shards"]],
            "treedef": {"file": td_rel, "digest": _digest(td_raw),
                        "nbytes": len(td_raw)},
            "shards": entries,
            "complete": True,
        }
        fault_point("manifest", 0, step=step)
        tmp = os.path.join(step_dir, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(step_dir, _MANIFEST))
        flightrec.record(flightrec.CKPT_COMMIT, step=step, rank=0,
                         bytes=total, shards=len(entries))
        self._retain()

    # -- wait/err ----------------------------------------------------------

    @property
    def in_flight(self) -> bool:
        """A previous save's stream is still draining (the overlap
        FtTrainLoop counts steps against)."""
        w = self._worker
        return w is not None and w.is_alive()

    def wait(self) -> None:
        with self._op_lock:
            self._join_worker()
            self._raise_pending()

    def _join_worker(self) -> None:
        with self._op_lock:
            if self._worker is not None:
                # zlint: disable=ZL002 -- the writer thread never takes _op_lock; holding it here keeps concurrent restores from double-joining
                self._worker.join(self.drain_timeout)
                alive = self._worker.is_alive()
                self._worker = None
                if alive:
                    raise CheckpointWriteError(
                        f"checkpoint stream did not drain within "
                        f"{self.drain_timeout}s")

    def _raise_pending(self) -> None:
        if self._error is None:
            return
        e, self._error = self._error, None
        if not isinstance(e, Exception):
            raise e  # the rank's own injected death (BaseException)
        if isinstance(e, (errors.ProcFailed, errors.Revoked)):
            # a peer died mid-exchange: the recovery pipeline owns that
            # fault (the step simply never committed — restore degrades
            # to the newest complete one); re-raising it here would
            # poison the post-recovery save with a stale corpse
            mca_output.verbose(
                1, _stream,
                "dropping stale in-stream peer failure: %r", e)
            return
        if isinstance(e, errors.MpiError):
            raise e
        raise errors.InternalError(f"checkpoint stream failed: {e!r}")

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Steps with a COMPLETE manifest, ascending."""
        return _complete_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def heal(self) -> list[str]:
        """Remove step directories a crashed writer left without a
        complete manifest (they can never restore) and stray manifest
        temps.  Returns what was removed."""
        removed = []
        with self._op_lock:
            for name in sorted(os.listdir(self.directory)):
                d = os.path.join(self.directory, name)
                if not (name.startswith(_STEP_PREFIX)
                        and os.path.isdir(d)):
                    continue
                if _read_manifest(d) is None:
                    shutil.rmtree(d, ignore_errors=True)
                    removed.append(d)
                    mca_output.verbose(
                        1, _stream,
                        "healed incomplete checkpoint %s", d)
                else:
                    tmp = os.path.join(d, _MANIFEST + ".tmp")
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                        removed.append(tmp)
        return removed

    def restore(self, step: int | None = None, shardings=None):
        """Digest-verified restore: newest COMPLETE step (or ``step``),
        every shard verified against its manifest digest BEFORE the
        treespec is read.  ``shardings``: where the leaves go (a device,
        or a pytree of devices; None is the card).  A torn/corrupt shard disqualifies its step
        LOUDLY (``ckpt_integrity_rejects``) and the walk degrades to
        the previous complete step (``ckpt_degraded_restores``) — a
        recovery never dies on a bad checkpoint while an older good one
        exists."""
        if shardings is None:
            from ..models.transformer import _device

            shardings = _device(None)
        with self._op_lock:
            self._join_worker()
            self.heal()
            candidates = self.all_steps()
            if step is not None:
                candidates = [s for s in candidates if s == int(step)]
            if not candidates:
                raise errors.ArgError(
                    f"no complete checkpoint found in {self.directory}"
                    + (f" for step {step}" if step is not None else ""))
            degraded = 0
            for s in reversed(candidates):
                out = self._try_restore(s, shardings)
                if out is not None:
                    if degraded:
                        spc.record("ckpt_degraded_restores")
                    return out
                degraded += 1
                mca_output.verbose(
                    0, _stream,
                    "checkpoint step %d REJECTED by integrity "
                    "verification; degrading to the previous "
                    "complete step", s)
            raise errors.ArgError(
                f"every complete checkpoint in {self.directory} failed "
                f"integrity verification ({degraded} rejected)")

    def _try_restore(self, step: int, shardings):
        """One candidate: verify + assemble, or None (rejected)."""
        d = os.path.join(self.directory, f"{_STEP_PREFIX}{step}")
        m = _read_manifest(d)
        if m is None:
            return None
        base = fbtl_mod.select_fbtl()
        # every shard's bytes, digest-verified BEFORE the tree is read
        leaf_bytes: dict[int, dict[int, bytes]] = {}
        ok = True
        for entry in m["shards"]:
            path = os.path.join(self.directory, entry["file"])
            nbytes = int(entry["nbytes"])
            if nbytes == 0:
                raw = b""
            else:
                try:
                    fd = os.open(path, os.O_RDONLY)
                except OSError:
                    spc.record("ckpt_integrity_rejects")
                    ok = False
                    continue
                try:
                    raw = base.preadv(
                        fd, [(int(entry["offset"]), nbytes)], nbytes
                    ).tobytes()
                finally:
                    os.close(fd)
            spc.record("ckpt_restore_bytes", nbytes)
            if _digest(raw) != entry["digest"]:
                spc.record("ckpt_integrity_rejects")
                mca_output.verbose(
                    0, _stream,
                    "TORN SHARD (leaf=%d rank=%d step=%d): digest "
                    "mismatch against the manifest", entry["leaf"],
                    entry["rank"], step)
                ok = False
                continue
            leaf_bytes.setdefault(int(entry["leaf"]), {})[
                int(entry["rank"])] = raw
        td = m["treedef"]
        td_path = os.path.join(self.directory, td["file"])
        try:
            with open(td_path, "rb") as f:
                td_raw = f.read()
        except OSError:
            td_raw = b""
        if _digest(td_raw) != td["digest"]:
            spc.record("ckpt_integrity_rejects")
            ok = False
        if not ok:
            return None
        # only after every digest verified
        treedef = pytree.treespec_loads(json.loads(td_raw))
        where = (pytree._broadcast_to_and_flatten(shardings, treedef)
                 if not isinstance(shardings, (str, torch.device))
                 else [shardings] * int(m["n_leaves"]))
        if where is None:
            raise errors.ArgError(
                "shardings do not match the checkpoint's structure")
        leaves = []
        for li, lm in enumerate(m["leaves"]):
            parts = leaf_bytes.get(li, {})
            raw = b"".join(parts[r] for r in sorted(parts))
            leaves.append(_from_bytes(raw, lm["dtype"], tuple(lm["shape"]))
                          .to(where[li]))
        return pytree.tree_unflatten(leaves, treedef), step

    # -- retention ---------------------------------------------------------

    def _retain(self) -> None:
        """Keep the last ``keep`` complete steps PLUS any older step a
        retained manifest still delta-references (deleting a referenced
        data file would tear every incremental descendant)."""
        steps = self.all_steps()
        if self.keep <= 0:
            return
        kept = set(steps[-self.keep:])
        referenced: set[int] = set()
        for s in kept:
            m = _read_manifest(
                os.path.join(self.directory, f"{_STEP_PREFIX}{s}"))
            if m is None:
                continue
            for entry in m["shards"]:
                top = entry["file"].split("/", 1)[0]
                if top.startswith(_STEP_PREFIX):
                    try:
                        referenced.add(int(top[len(_STEP_PREFIX):]))
                    except ValueError:
                        continue
        for s in steps:
            if s not in kept and s not in referenced:
                shutil.rmtree(
                    os.path.join(self.directory, f"{_STEP_PREFIX}{s}"),
                    ignore_errors=True)
