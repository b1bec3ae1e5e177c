"""The inputs of a run, made from ``--seed`` by the benchmark and handed to
the program and to the reference alike: the weights, drawn on the device,
and the token batches, drawn on the host.

The leaves, their shapes and their scales are the architecture's
(``arch/<name>.py``: ``LEAVES`` and ``leaf_shape_scale``), as float32
masters, the type the port holds them in.  Each leaf comes from a
generator of its own, seeded by the seed and the leaf's index, so one leaf
can be drawn again alone, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


class Leaves:
    """The leaves of architecture module ``arch`` at the sizes ``model``,
    from ``seed``, on ``device``."""

    def __init__(self, arch, model: dict, seed: int, device):
        self.arch, self.model, self.seed, self.device = arch, model, int(seed), device
        self.names = tuple(arch.LEAVES)

    def draw(self, name: str) -> torch.Tensor:
        """One float32 leaf drawn on the device in one call; a leaf whose
        scale is None is a gain of ones."""
        shape, scale = self.arch.leaf_shape_scale(name, self.model)
        if scale is None:
            return torch.ones(shape, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * len(self.names) + self.names.index(name))
        out = torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)
        return out.mul_(scale)

    def all(self) -> dict:
        return {n: self.draw(n) for n in self.names}


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
