"""Hierarchical (multi-slice) data parallelism: the device plane inside a
process, the host plane (DCN) across processes (namesake:
``zhpe_ompi_tpu/parallel/hybrid.py``).

Each process (slice) averages its gradients over its own communicators;
this module averages the per-slice results across launcher-started
processes over a host-plane endpoint (``TcpProc``, or a thread rank):

- :func:`pack_tree` / :func:`unpack_tree` — flatten a pytree of tensors
  into ONE contiguous host buffer per dtype, so the cross-slice sync is a
  few large messages instead of one per parameter.  The leaves of a bucket
  are concatenated on their device and fetched to the host in one copy.
- :func:`dcn_grad_sync` — allreduce-mean of a gradient pytree over the host
  plane (``weight``: this slice's share of the global batch).
- :func:`dcn_grad_sync_sharded` — one reduction per tensor leaf, after a
  layout fingerprint agreed across the slices.
- :func:`dcn_bcast_params` — broadcast a parameter pytree from one slice.

What differs from the namesake, in form only:

- Trees are flattened with ``torch.utils._pytree`` in the namesake's leaf
  order (``utils.payload.tree_flatten``: a dict's keys sorted), so the
  buckets, their keys (numpy dtype names, ``"float32"``, …) and their
  contents are the namesake's for the same tree.
- A bfloat16 or float8 tensor travels as float32 (a lossless upcast) and is
  cast back at unpack: numpy has no bfloat16, and ``utils/dss`` refuses it
  on the wire.
- Leaves come back as tensors in their input dtypes, on the device of the
  input leaf (the CPU for a numpy array or a Python number), where the
  namesake returns numpy arrays.
- :func:`dcn_grad_sync_sharded`: a port process drives one device, so a
  tensor leaf is one shard; its fingerprint is (shape, dtype, device).
- :func:`dcn_bcast_params` sends the tree's structure as the torch
  treespec string (``pytree.treespec_dumps``), where the namesake pickles
  its JAX treedef.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import ops as zops
from ..core import errors
from ..runtime import ztrace
from ..utils.payload import tree_flatten

# carried as float32 on the wire and cast back at unpack
_EXTENSION_FLOATS = frozenset(
    getattr(torch, name) for name in (
        "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
        "float8_e5m2fnuz") if hasattr(torch, name))


class Laps:
    """Accumulates seconds by phase into ``timings`` (a dict); a no-op
    without a dict (the port's ``timings=`` hook of the training step and
    of the host-plane syncs).

    Each phase runs from one edge to the next: :meth:`lap` closes the
    current phase and opens the next, :meth:`restart` opens a new one
    after a stretch that is timed elsewhere.  On CUDA (``device`` a CUDA
    device, or None where a card is present) an edge records a
    ``torch.cuda.Event`` on the current stream and nothing waits there: a
    phase's time is the stream's own span between its two edges
    (``elapsed_time``).  A phase in which the device idles (a host-plane
    leg: ``d2h``, ``dcn``, ``h2d``) reads host time all the same, since an
    event on an idle stream completes as it is recorded.  Elsewhere an
    edge reads the host clock.  :meth:`close` adds the pending phases into
    ``timings``; on CUDA it waits on the last edge alone, which is the
    point a caller reading a result of the work waits for anyway.

    With a ``name``, :meth:`phase` runs a block as a phase inside a
    profiler range ``zmpi.<name>.<phase>`` (which puts it in a
    profiler trace on the kernels' clock), and while ``runtime/ztrace`` is
    armed :meth:`close` records each phase as a ``PHASE`` span named
    ``<name>.<phase>`` on ``rank``, from its host edges, with its device
    milliseconds as ``device_ms`` on CUDA."""

    def __init__(self, timings: dict | None, device=None,
                 name: str | None = None, rank: int = 0):
        self.timings = timings
        self._events = (timings is not None and torch.cuda.is_available()
                        and (device is None
                             or torch.device(device).type == "cuda"))
        self._device = device
        self._name = name
        self._rank = rank
        self._pending: list = []
        self.restart()

    def _edge(self) -> tuple:
        """(host monotonic ns, the event recorded on the stream or None)."""
        ev = None
        if self._events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
        return time.monotonic_ns(), ev

    def restart(self) -> None:
        if self.timings is not None:
            self._start = self._edge()

    def lap(self, phase: str) -> None:
        if self.timings is None:
            return
        end = self._edge()
        self._pending.append((phase, self._start, end))
        self._start = end

    def phase(self, phase: str):
        """Context manager: the block ends phase ``phase`` (which began at
        the last edge), in its profiler range.  A shared null
        context without a dict."""
        if self.timings is None:
            return _NO_PHASE
        return _Phase(self, phase)

    def close(self) -> dict:
        """Add the pending phases into ``timings``; returns the seconds of
        each phase this call added."""
        spent: dict = {}
        if not self._pending:
            return spent
        pending, self._pending = self._pending, []
        if self._events:
            pending[-1][2][1].synchronize()
        for phase, (h0, e0), (h1, e1) in pending:
            secs = e0.elapsed_time(e1) / 1e3 if e0 is not None else (h1 - h0) / 1e9
            self.timings[phase] = self.timings.get(phase, 0.0) + secs
            spent[phase] = spent.get(phase, 0.0) + secs
            if ztrace.active and self._name is not None:
                fields = {"device_ms": secs * 1e3} if e0 is not None else {}
                ztrace.record_span(ztrace.PHASE, self._rank, h0, h1,
                                   name=f"{self._name}.{phase}", **fields)
        return spent


class _Phase:
    """One :meth:`Laps.phase` block."""

    __slots__ = ("_laps", "_phase", "_range")

    def __init__(self, laps: Laps, phase: str):
        self._laps = laps
        self._phase = phase
        self._range = None

    def __enter__(self):
        if self._laps._name is not None:
            self._range = ztrace.profiler_range(f"zmpi.{self._laps._name}.{self._phase}")
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self._laps.lap(self._phase)
        return False


_NO_PHASE = contextlib.nullcontext()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _device_of(leaf) -> torch.device:
    """Where a leaf comes back: its own device, the CPU for anything but a
    tensor."""
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":
        raise errors.TypeError_(
            f"cannot carry a numpy {arr.dtype} leaf: pass a torch tensor")
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def _wire_form(t: torch.Tensor) -> tuple[torch.Tensor, str, torch.dtype | None]:
    """(transport tensor, bucket key, original dtype or None): extension
    floats travel as float32 (a value superset of bf16/f8), the numerically
    right reduction precision for low-bit gradients too."""
    if t.dtype in _EXTENSION_FLOATS:
        return t.float(), "float32", t.dtype
    return t, _dtype_name(t.dtype), None


def _pack_device(tree: Any, scale: float | None = None):
    """Flatten ``tree`` into one flat tensor per transport dtype, each
    concatenated on the device of its leaves (the device of its first
    non-CPU leaf, where the leaves are mixed), optionally multiplied by
    ``scale``.  Returns (flat by key, spec, leaf meta)."""
    leaves, spec = tree_flatten(tree)
    parts: dict[str, list[torch.Tensor]] = {}
    meta = []
    for leaf in leaves:
        t = _as_tensor(leaf)
        wire, key, orig = _wire_form(t)
        parts.setdefault(key, []).append(wire.reshape(-1))
        meta.append((key, tuple(wire.shape), orig, _device_of(leaf)))
    flat = {}
    for key, ts in parts.items():
        dev = next((t.device for t in ts if t.device.type != "cpu"),
                   ts[0].device)
        cat = torch.cat([t.to(dev) for t in ts])  # a copy, even of one leaf
        flat[key] = cat * scale if scale is not None else cat
    return flat, spec, meta


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy (none for a CPU tensor), as numpy."""
    return t.cpu().numpy()


def pack_tree(tree: Any) -> tuple[dict[str, np.ndarray], Any, list]:
    """Flatten a pytree of tensors (numpy arrays and numbers too) into one
    contiguous host buffer per transport dtype: one device-to-host copy per
    bucket.  Returns (buffers, spec, leaf_meta) for :func:`unpack_tree`."""
    flat, spec, meta = _pack_device(tree)
    return {k: _to_host(v) for k, v in flat.items()}, spec, meta


def unpack_tree(buffers: dict, spec: Any, meta: list) -> Any:
    """Inverse of :func:`pack_tree`: tensors in their original dtypes, each
    on its input leaf's device (one host-to-device copy per bucket and
    device).  ``buffers`` values may be numpy arrays or tensors."""
    on_dev: dict = {}
    cursors = {k: 0 for k in buffers}
    leaves = []
    for key, shape, orig, dev in meta:
        n = int(np.prod(shape or (1,)))
        src = on_dev.get((key, dev))
        if src is None:
            buf = buffers[key]
            buf = buf if isinstance(buf, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(buf))
            src = on_dev[(key, dev)] = buf.to(dev)
        pos = cursors[key]
        leaf = src[pos:pos + n].reshape(shape)
        leaves.append(leaf.to(orig) if orig is not None else leaf)
        cursors[key] = pos + n
    return pytree.tree_unflatten(leaves, spec)


def _check_float(dtype, what: str) -> None:
    if not (dtype.is_floating_point or dtype.is_complex):
        raise errors.TypeError_(f"{what} expects float gradients, got {dtype}")


def _reduce(proc, flat: torch.Tensor, laps: Laps) -> np.ndarray:
    """One host-plane allreduce SUM of one (already weighted) bucket."""
    host = _to_host(flat)
    laps.lap("d2h")
    out = np.asarray(proc.allreduce(host, zops.SUM))
    laps.lap("dcn")
    return out


def dcn_grad_sync(proc, grads: Any, weight: float | None = None,
                  timings: dict | None = None) -> Any:
    """Average a gradient pytree across host-plane ranks (slices).

    ``weight``: this slice's fraction of the global batch (defaults to
    1/size — equal slices).  Each transport-dtype bucket goes through ONE
    device-to-host copy and ONE host-plane allreduce, in sorted key order
    (the namesake's collective order).  At size 1 nothing moves; an
    explicit ``weight`` still applies (the caller asked for a weighted
    sum).  ``timings`` (see :class:`Laps`) gathers ``"d2h"`` (packing and
    the copies to the host), ``"dcn"`` and ``"h2d"``, each resolved before
    the call returns."""
    laps = Laps(timings)
    w = (1.0 / proc.size) if weight is None else float(weight)
    scale = None if (proc.size == 1 and weight is None) else w
    flat, spec, meta = _pack_device(grads, scale)
    summed = {}
    for key in sorted(flat):
        _check_float(flat[key].dtype, "dcn_grad_sync")
        summed[key] = (flat[key] if proc.size == 1
                       else _reduce(proc, flat[key], laps))
    out = unpack_tree(summed, spec, meta)
    laps.lap("h2d")
    laps.close()
    return out


def _fingerprint(leaves) -> str:
    fp = hashlib.sha256()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            fp.update(repr((tuple(leaf.shape), _dtype_name(leaf.dtype),
                            str(leaf.device))).encode())
        else:
            fp.update(b"host-leaf")
    return fp.hexdigest()


def dcn_grad_sync_sharded(proc, grads: Any, weight: float | None = None,
                          timings: dict | None = None) -> Any:
    """Per-leaf DCN gradient sync: each tensor leaf (one process drives one
    device, so a leaf is one shard) is reduced on its own across the slices
    and comes back on its device, with no bucket packing.

    The symmetry contract — every slice holds the same leaves, so leaf L
    pairs across slices — is enforced: a layout fingerprint (shape, dtype,
    device per leaf) is allgathered before any data moves, and a mismatch
    raises ``ArgError`` instead of summing unrelated tensors.  Leaves that
    are not tensors (numpy arrays, numbers) ride one bucketed
    :func:`dcn_grad_sync`."""
    laps = Laps(timings)
    w = (1.0 / proc.size) if weight is None else float(weight)
    leaves, spec = tree_flatten(grads)
    if proc.size > 1:
        digests = [str(d) for d in proc.allgather(_fingerprint(leaves))]
        if len(set(digests)) != 1:
            raise errors.ArgError(
                "dcn_grad_sync_sharded requires identical layouts on every "
                f"slice; fingerprints differ: {digests}")
    out: list = [None] * len(leaves)
    host_idx, host_leaves = [], []
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            host_idx.append(i)
            host_leaves.append(leaf)
            continue
        wire, _, orig = _wire_form(leaf.detach())
        _check_float(wire.dtype, "dcn_grad_sync_sharded")
        if proc.size == 1:
            red = wire if weight is None else wire * w
        else:
            red = torch.from_numpy(_reduce(proc, wire * w, laps)).to(
                leaf.device).reshape(wire.shape)
        out[i] = red.to(orig) if orig is not None else red
        laps.lap("h2d")
    if host_leaves:
        # a list is a pytree: one bucketed sync over the flat host leaves
        synced = dcn_grad_sync(proc, host_leaves, weight=weight,
                               timings=timings)
        for i, v in zip(host_idx, synced):
            out[i] = v
    laps.close()
    return pytree.tree_unflatten(out, spec)


def dcn_bcast_params(proc, params: Any, root: int = 0) -> Any:
    """Broadcast a parameter pytree from ``root`` to every slice (job start,
    or repairing a diverged slice).  The header (treespec string, leaf
    shapes and dtypes, bucket keys) takes the binomial tree; each dtype
    bucket the pipelined bcast.  Every rank's leaves come back on the
    devices of its own ``params`` leaves (the CPU where the trees differ in
    structure)."""
    if proc.size == 1 or proc.rank == root:
        flat, spec, meta = _pack_device(params)
    if proc.size == 1:
        return unpack_tree(flat, spec, meta)
    if proc.rank == root:
        wire_meta = [(key, list(shape),
                      _dtype_name(orig) if orig is not None else None)
                     for key, shape, orig, _ in meta]
        buffers = {k: _to_host(v) for k, v in flat.items()}
        # the header is a tuple: pin the binomial path whatever the
        # host_bcast_algorithm var says (pipeline needs an array payload)
        proc.bcast((pytree.treespec_dumps(spec), wire_meta, sorted(buffers)),
                   root=root, algorithm="binomial")
        for key in sorted(buffers):
            proc.bcast(buffers[key], root=root, algorithm="pipeline")
        return unpack_tree(buffers, spec, meta)
    spec_s, got_meta, keys = proc.bcast(None, root=root, algorithm="binomial")
    buffers = {key: np.asarray(proc.bcast(None, root=root,
                                          algorithm="pipeline"))
               for key in keys}
    leaves, spec = tree_flatten(params)
    devices = ([_device_of(leaf) for leaf in leaves]
               if spec_s == pytree.treespec_dumps(spec)
               else [torch.device("cpu")] * len(got_meta))
    new_meta = [
        (key, tuple(shape), getattr(torch, orig) if orig is not None else None,
         dev) for (key, shape, orig), dev in zip(got_meta, devices)]
    return unpack_tree(buffers, pytree.treespec_loads(spec_s), new_meta)
