"""ZeRO-1 across slices: optimizer-state sharding over the host plane
(namesake: ``zhpe_ompi_tpu/parallel/zero.py``).

The hybrid layer (``parallel/hybrid.py``) replicates optimizer state on
every slice.  ZeRO stage 1 partitions the flat parameter space across the
data-parallel group so each rank keeps optimizer state only for the 1/N
partition it owns, and the gradient sync becomes a reduce-scatter (each
owner receives its fully-reduced partition) followed by an allgather of the
updated parameters: the bytes of a ring allreduce, with the optimizer's
memory divided by the slice count.

The partition runs on the flat per-dtype buckets of ``hybrid.pack_tree``;
``proc.reduce_scatter`` and ``proc.allgather`` are the host-plane
collectives.  Extension floats (bf16, f8) ride the float32 transport, which
doubles as f32 master weights: the optimizer updates in f32 and the result
is cast back to the storage dtype at unpack.

What differs from the namesake, in form only: ``optimizer`` is a factory
``params -> torch.optim.Optimizer`` (default Adam, lr 1e-3, with optax's
defaults, as ``make_train_step_optax`` takes) built over this rank's padded
f32 chunk of each bucket; the chunks and the optimizer's state live on the
port's ``device`` (the card unless ``device="cpu"``), where the namesake's
optax state sits on JAX's default device; ``step`` returns tensors in the
params' dtypes on their devices.  A torch optimizer creates its state at
its first ``step``, so :meth:`ZeroOptimizer.state_bytes` is 0 before it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import ops as zops
from ..core import errors
from ..runtime import ztrace
from . import hybrid


class ZeroOptimizer:
    """Stage-1 ZeRO over a host-plane endpoint (a ``TcpProc`` across
    slices, or a thread rank).

    ``step(params, grads)`` takes the full (replicated) params tree and the
    LOCAL gradient tree and returns the updated full params tree.
    ``timings``, when given a dict to ``step``, accumulates its seconds
    by phase (``"d2h"``, ``"reduce_scatter"``, ``"h2d"``, ``"optimizer"``,
    ``"allgather"``): on the card each phase's span on the CUDA stream,
    with no synchronization at its edges (``parallel/hybrid.Laps``)."""

    def __init__(self, proc, optimizer=None, params: Any = None,
                 weight: float | None = None, device=None):
        from ..models.transformer import _adam, _device

        self.proc = proc
        self.optimizer = _adam if optimizer is None else optimizer
        self.weight = weight
        self.device = _device(device)
        flat, _, self._meta = hybrid._pack_device(params)
        self._keys = sorted(flat)
        self._sizes = {k: int(flat[k].numel()) for k in self._keys}
        # the optimizer over MY partition only, in the padded equal-chunk
        # geometry step() reduces into (the last rank's padded tail carries
        # zero state and its updates are discarded at unpad)
        self._build({k: self._chunks_of(flat[k].float(), k)[proc.rank]
                     for k in self._keys})

    def _build(self, chunks: dict) -> None:
        self._parts = {k: chunks[k].to(self.device, copy=True)
                       for k in self._keys}
        self._opt = self.optimizer([self._parts[k] for k in self._keys])

    def state_bytes(self) -> int:
        """Optimizer-state bytes held by THIS rank (the ZeRO saving)."""
        return sum(v.numel() * v.element_size()
                   for st in self._opt.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor))

    def _chunk(self, key: str) -> int:
        return -(-self._sizes[key] // self.proc.size)

    def _chunks_of(self, flat, key: str) -> list:
        """Rank-indexed, padded-equal blocks of one flat f32 bucket (a
        tensor or a numpy array; views of one padded copy)."""
        n, chunk = self.proc.size, self._chunk(key)
        if isinstance(flat, torch.Tensor):
            padded = torch.zeros(chunk * n, dtype=torch.float32,
                                 device=flat.device)
        else:
            padded = np.zeros(chunk * n, np.float32)
        padded[: flat.shape[0]] = flat
        return [padded[r * chunk:(r + 1) * chunk] for r in range(n)]

    # -- re-sharding (the recovery pipeline's remesh step) ---------------

    def full_state(self) -> dict:
        """The partitioned optimizer state gathered to FULL on every rank:
        ``{bucket key: {state name: value}}``, each partition-shaped tensor
        (Adam's moments) an unpadded flat f32 numpy bucket, each other
        value (Adam's step count) as numpy.  The checkpointable form
        (``io/ckptio``, ``recovery.rollback``): :meth:`reshard` re-partitions
        it onto whatever endpoint survives.  Collective over the proc's
        whole group (one allgather per partition-shaped state tensor)."""
        n = self.proc.size
        out = {}
        for k in self._keys:
            st = self._opt.state.get(self._parts[k], {})
            full = {}
            for name in sorted(st):
                v = st[name]
                if isinstance(v, torch.Tensor) and v.numel() == self._chunk(k) \
                        and v.dim() == 1:
                    mine = v.detach().float().cpu().numpy()
                    if n == 1:
                        full[name] = mine[: self._sizes[k]].copy()
                    else:
                        parts = self.proc.allgather(mine)
                        full[name] = np.concatenate(
                            [np.asarray(p, np.float32) for p in parts]
                        )[: self._sizes[k]]
                else:
                    full[name] = np.asarray(
                        v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            out[k] = full
        return out

    def reshard(self, proc, full_state: dict) -> None:
        """Re-partition onto a NEW endpoint (the survivors of a shrink, or
        the full-size endpoint after a respawn): adopt ``proc``'s size and
        rank as the partition geometry and take this rank's chunk of every
        bucket-sized state of ``full_state`` (from :meth:`full_state`, or a
        checkpoint restore).  The optimizer is rebuilt over the new chunks
        with that state."""
        sp = ztrace.begin(ztrace.REMESH, getattr(proc, "rank", -1),
                          what="zero-opt") if ztrace.active else None
        self.proc = proc
        self._build({k: torch.zeros(self._chunk(k)) for k in self._keys})
        for k in self._keys:
            st = {}
            for name, v in full_state.get(k, {}).items():
                arr = np.asarray(v)
                if arr.ndim == 1 and arr.size == self._sizes[k]:
                    full = torch.from_numpy(arr.astype(np.float32))
                    st[name] = self._chunks_of(full, k)[proc.rank].to(
                        self.device, copy=True)
                else:
                    st[name] = torch.tensor(arr)
            if st:
                self._opt.state[self._parts[k]] = st
        if sp is not None:
            sp.end(size=proc.size)

    def step(self, params: Any, grads: Any, timings: dict | None = None) -> Any:
        """One ZeRO-1 step: reduce-scatter the gradients, update the owned
        partition on the device, allgather the updated parameters.
        Collective over the proc's whole group."""
        laps = hybrid.Laps(timings, self.device)
        p_flat, p_spec, p_meta = hybrid._pack_device(params)
        n, me = self.proc.size, self.proc.rank
        w = (1.0 / n) if self.weight is None else float(self.weight)
        g_flat, _, _ = hybrid._pack_device(
            grads, None if (n == 1 and self.weight is None) else w)
        for flat in (p_flat, g_flat):
            if {k: int(v.numel()) for k, v in flat.items()} != self._sizes:
                raise errors.ArgError(
                    "params/grads buckets do not match the tree this "
                    "optimizer was built for (keys AND sizes must agree)")
        for k in self._keys:
            if n == 1:
                my_g = g_flat[k].float().to(self.device)
            else:
                blocks = self._chunks_of(hybrid._to_host(g_flat[k].float()), k)
                laps.lap("d2h")
                my_g = np.asarray(self.proc.reduce_scatter(blocks, zops.SUM),
                                  np.float32)
                laps.lap("reduce_scatter")
                my_g = torch.from_numpy(my_g).to(self.device)
            my_p = self._chunks_of(p_flat[k].float().to(self.device), k)[me]
            with torch.no_grad():
                self._parts[k].copy_(my_p)
            self._parts[k].grad = my_g
        laps.lap("h2d")
        with torch.no_grad():
            self._opt.step()
        for k in self._keys:
            self._parts[k].grad = None
        laps.lap("optimizer")
        new = {}
        for k in self._keys:
            mine = self._parts[k].detach()
            if n == 1:
                new[k] = mine[: self._sizes[k]]
            else:
                host = hybrid._to_host(mine)
                laps.lap("d2h")
                gathered = self.proc.allgather(host)
                new[k] = np.concatenate(
                    [np.asarray(g, np.float32) for g in gathered]
                )[: self._sizes[k]]
                laps.lap("allgather")
        out = hybrid.unpack_tree(new, p_spec, p_meta)
        laps.lap("h2d")
        laps.close()
        return out
