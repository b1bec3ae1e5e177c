"""Shared payload helpers (namesake: ``zhpe_ompi_tpu/utils/payload.py``).

The port's own copy, over torch tensors: where the JAX package flattens a
pytree with ``jax.tree.leaves``, this one walks tuples, lists and dicts
(``None`` is an empty subtree, as in a JAX pytree)."""

from __future__ import annotations

import numpy as np
import torch


def payload_size_estimate(obj, _depth: int = 0) -> int:
    """Cheap recursive payload-size estimate for per-send decision points
    (the eager/rendezvous switch, per-phase byte counters).  Container-aware
    to depth 4; strings count len() — bytes-per-char >= 1, and a lower
    bound is enough.  One implementation on purpose: a transport switch and
    the SPC accounting must never disagree about the same payload."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    if _depth < 4:
        if isinstance(obj, (list, tuple)):
            return sum(payload_size_estimate(o, _depth + 1) for o in obj)
        if isinstance(obj, dict):
            return sum(
                payload_size_estimate(k, _depth + 1)
                + payload_size_estimate(v, _depth + 1)
                for k, v in obj.items()
            )
    return 0


def _leaves(x, out: list) -> list:
    if x is None:
        return out
    if isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for k in sorted(x, key=repr):
            _leaves(x[k], out)
    else:
        out.append(x)
    return out


def payload_nbytes(x) -> int:
    """Total bytes of a nest of tensors (defensive: shapeless or exotic
    leaves count conservatively instead of raising — used by decision and
    monitoring paths that must never fail a collective)."""
    total = 0
    for leaf in _leaves(x, []):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        try:
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                total += 8
            else:
                total += int(np.prod(shape or (1,))) * np.dtype(dtype).itemsize
        except Exception:
            total += 8
    return total
