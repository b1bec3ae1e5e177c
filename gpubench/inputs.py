"""The inputs of a run, made from ``--seed`` by the benchmark and handed to
the program and to the reference alike: the weights, drawn on the device,
and the token batches, drawn on the host.

Weights follow the JAX package's ``init_params`` layout and scales, as
float32 masters (the type the port holds them in): ``embed`` (V, D) at
0.02, ``wqkv`` (L, D, 3, D) at D^-1/2, ``wo`` (L, D, D) at D^-1/2, ``w1``
(L, D, F) at D^-1/2, ``w2`` (L, F, D) at F^-1/2, the gains ``ln1``,
``ln2`` (L, D) and ``lnf`` (D,) at 1.  Each leaf comes from a generator of
its own, so one leaf can be drawn again alone, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

#: the leaves in the order they are drawn, each with its index
LEAVES = ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "lnf")


def leaf_shape_scale(name: str, vocab: int, d_model: int, d_ff: int,
                     n_layers: int, **_) -> tuple[tuple, float | None]:
    """Shape and scale of a leaf; scale None for a gain of ones."""
    V, D, F, L = vocab, d_model, d_ff, n_layers
    return {
        "embed": ((V, D), 0.02),
        "wqkv": ((L, D, 3, D), D ** -0.5),
        "wo": ((L, D, D), D ** -0.5),
        "w1": ((L, D, F), D ** -0.5),
        "w2": ((L, F, D), F ** -0.5),
        "ln1": ((L, D), None),
        "ln2": ((L, D), None),
        "lnf": ((D,), None),
    }[name]


def make_leaf(name: str, model: dict, seed: int, device) -> torch.Tensor:
    """One float32 leaf drawn on ``device`` in one call from a generator
    seeded by ``seed`` and the leaf's index."""
    shape, scale = leaf_shape_scale(name, **model)
    if scale is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * len(LEAVES) + LEAVES.index(name))
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(scale)


def make_params(model: dict, seed: int, device) -> dict:
    return {n: make_leaf(n, model, seed, device) for n in LEAVES}


def make_batches(traffic: dict, vocab: int, seed: int) -> list:
    """``traffic["pool"]`` distinct batches of ``batch`` rows of ``seq + 1``
    tokens drawn uniformly from the vocabulary; each batch is
    ``(tokens, targets)``, the targets the tokens shifted by one, as int64
    host tensors, as a data loader hands them over."""
    rng = np.random.default_rng(int(seed))
    B, S, n = int(traffic["batch"]), int(traffic["seq"]), int(traffic["pool"])
    rows = rng.integers(0, vocab, size=(n, B, S + 1), dtype=np.int64)
    return [(torch.from_numpy(r[:, :-1].copy()), torch.from_numpy(r[:, 1:].copy()))
            for r in rows]
