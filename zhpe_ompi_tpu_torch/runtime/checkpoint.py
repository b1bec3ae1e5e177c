"""Checkpoint/restart as async snapshots (namesake:
``zhpe_ompi_tpu/runtime/checkpoint.py``).

- ``Checkpointer.save(step, state)`` copies every tensor of ``state`` (a
  pytree: dicts, lists and tuples of tensors, numpy arrays and plain
  values, such as ``{"params": ..., "opt": optimizer.state_dict()}``) to
  host memory before it returns, then writes the files in a background
  thread.  The copy is a synchronous device-to-host copy (never
  ``non_blocking``), so an optimizer that updates the tensors in place
  right after ``save`` returns cannot race it; a CPU tensor is cloned.
- Atomicity by write-to-tmp-then-rename: a crashed writer leaves only a
  ``.tmp`` directory, which restore ignores; a republish of a step retires
  the old version to ``.old`` first, and a half-done republish is healed
  (backwards) on open and before every restore.
- ``restore()`` returns the newest complete checkpoint; retention keeps
  the last ``keep``.

Each array leaf is a file of :mod:`zhpe_ompi_tpu_torch.io.sharded`, in the
JAX package's format (``leaf_<i>.zmpi``), and ``meta.json`` keeps the
namesake's ``step`` and ``n_leaves`` (the number of leaf files).  The
namesake pickles a JAX treedef (``treedef.pkl``); the port writes
``tree.json`` instead: the torch pytree spec (``treespec_dumps``) and, per
leaf, its file number or its plain JSON value (the floats, ints, bools,
strings and Nones of an optimizer's ``param_groups``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import errors
from ..io import sharded
from ..mca import output as mca_output
from . import flightrec

_stream = mca_output.open_stream("checkpoint")

_STEP_PREFIX = "step_"
_PLAIN = (bool, int, float, str, type(None))


def quiesce_check() -> None:
    """Raise if host-plane pt2pt queues are non-empty (the checkable form
    of crcp/bkmrk's 'drain in-flight messages first' protocol): the posted
    and unexpected queues of every live ``pt2pt/universe`` universe, read
    as the namesake reads them (``_queue_depth(...,
    exempt_acked_failed=True)``; a port universe has no failure state, so
    nothing is exempt)."""
    from ..pt2pt import universe as uni_mod

    posted = uni_mod._queue_depth("posted", exempt_acked_failed=True)
    unexpected = uni_mod._queue_depth("unexpected", exempt_acked_failed=True)
    if posted or unexpected:
        raise errors.InternalError(
            f"checkpoint at non-quiescent point: {posted} posted recvs, "
            f"{unexpected} unexpected messages in flight"
        )


def _snapshot(leaf):
    """A host copy of one leaf that no later write to ``leaf`` can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.array(leaf)
    if isinstance(leaf, _PLAIN):
        return leaf
    raise errors.ArgError(
        f"cannot checkpoint a leaf of type {type(leaf).__name__}: leaves are "
        "tensors, numpy arrays, or bool/int/float/str/None values")


class Checkpointer:
    """Async checkpoint manager over a directory."""

    def __init__(self, directory: str, keep: int = 3,
                 check_quiescent: bool = True):
        self.directory = directory
        self.keep = keep
        self.check_quiescent = check_quiescent
        os.makedirs(directory, exist_ok=True)
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        # save/wait/restore/heal serialize under one reentrant lock; the
        # writer thread never takes it, so joining it under the lock
        # cannot deadlock
        self._op_lock = threading.RLock()
        self._heal_interrupted()

    def _heal_interrupted(self) -> None:
        """Complete, backwards, a republish a crashed writer left half
        done: ``step_N.old`` without ``step_N`` is the newest complete
        checkpoint of that step, so put it back; with ``step_N`` the
        publish landed and only the cleanup was lost, so drop the stale
        copy."""
        with self._op_lock:
            for name in os.listdir(self.directory):
                if not (name.startswith(_STEP_PREFIX)
                        and name.endswith(".old")):
                    continue
                old = os.path.join(self.directory, name)
                final = old[:-len(".old")]
                if os.path.isdir(final):
                    shutil.rmtree(old, ignore_errors=True)
                else:
                    os.replace(old, final)
                    mca_output.verbose(
                        1, _stream,
                        "healed interrupted republish: restored %s", final,
                    )

    # -- save ------------------------------------------------------------

    def save(self, step: int, state, blocking: bool = False) -> None:
        """Snapshot ``state`` at ``step``: the host copy happens now (so the
        caller may update its tensors in place right away), the disk
        writes in the background unless ``blocking``."""
        if self.check_quiescent:
            quiesce_check()
        with self._op_lock:
            # zlint: disable=ZL002 -- save/wait/restore serialize under ONE RLock; the joined writer never takes it (no cycle) and callers accept checkpoint-grade latency
            self.wait()  # one outstanding checkpoint at a time
            flightrec.record(flightrec.CKPT_BEGIN, step=int(step),
                             plane="serial")
            leaves, spec = pytree.tree_flatten(state)
            host_leaves = [_snapshot(leaf) for leaf in leaves]

            def write():
                try:
                    self._write(step, host_leaves, spec)
                except BaseException as e:  # noqa: BLE001 - see wait()
                    self._error = e

            if blocking:
                write()
                self._raise_pending()
            else:
                self._worker = threading.Thread(target=write, daemon=True)
                self._worker.start()

    def _write(self, step, host_leaves, spec) -> None:
        final = os.path.join(self.directory, f"{_STEP_PREFIX}{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        n_files = 0
        for leaf in host_leaves:
            if isinstance(leaf, (torch.Tensor, np.ndarray)):
                sharded.save_sharded(
                    os.path.join(tmp, f"leaf_{n_files}.zmpi"), leaf)
                entries.append({"file": n_files})
                n_files += 1
            else:
                entries.append({"value": leaf})
        meta = {"step": step, "n_leaves": n_files, "treedef": str(spec)}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"spec": pytree.treespec_dumps(spec),
                       "leaves": entries}, f)
        if os.path.isdir(final):
            # re-checkpointing a step: retire the old version first; the
            # rename below republishes atomically
            old = final + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)  # atomic publish
        flightrec.record(flightrec.CKPT_COMMIT, step=int(step),
                         plane="serial")
        mca_output.verbose(1, _stream, "checkpoint step %d written", step)
        self._retain()

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.directory, f"{_STEP_PREFIX}{s}"),
                ignore_errors=True,
            )

    # -- wait/err --------------------------------------------------------

    def wait(self) -> None:
        """Block until the outstanding async save completes; re-raise its
        error if it failed."""
        with self._op_lock:
            self._join_worker()
            self._raise_pending()

    def _join_worker(self) -> None:
        """Join the outstanding writer without surfacing its error: a
        failed save must not poison a restore (it left only partials); the
        error stays pending for the next save()/wait()."""
        with self._op_lock:
            if self._worker is not None:
                # zlint: disable=ZL002 -- the writer thread never takes _op_lock, so this join cannot cycle; holding it is why concurrent restores cannot double-join
                self._worker.join()
                self._worker = None

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise errors.InternalError(f"checkpoint write failed: {e!r}")

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Complete checkpoints, ascending (ignores .tmp partials)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, placements=None):
        """Load a checkpoint (default: the newest) as ``(state, step)``.
        ``placements`` says where each array leaf goes: None gives host
        numpy arrays, as the namesake does (bfloat16: CPU tensors, see
        ``io.sharded.load_sharded``); a device or an
        :class:`~zhpe_ompi_tpu_torch.io.sharded.Placement` applies to every
        array leaf; a pytree (a prefix of the state's structure, for
        example ``{"params": "cuda", "opt": "cpu"}``) places each subtree.
        Heals interrupted republishes first; a failed async save does not
        poison the restore (its error stays pending)."""
        with self._op_lock:
            self._join_worker()
            self._heal_interrupted()
            if step is None:
                step = self.latest_step()
                if step is None:
                    raise errors.ArgError(
                        f"no checkpoint found in {self.directory}"
                    )
            d = os.path.join(self.directory, f"{_STEP_PREFIX}{step}")
            if not os.path.isdir(d):
                raise errors.ArgError(f"no checkpoint for step {step}")
            with open(os.path.join(d, "tree.json")) as f:
                tree = json.load(f)
            spec = pytree.treespec_loads(tree["spec"])
            where = ([None] * spec.num_leaves if placements is None else
                     pytree._broadcast_to_and_flatten(placements, spec))
            if where is None:
                raise errors.ArgError(
                    "placements do not match the checkpoint's structure")
            leaves = [
                sharded.load_sharded(
                    os.path.join(d, f"leaf_{e['file']}.zmpi"), place)
                if "file" in e else e["value"]
                for e, place in zip(tree["leaves"], where)
            ]
            return pytree.tree_unflatten(leaves, spec), step
