"""Published peaks of the cards the benchmark knows, by a substring of the
name ``torch.cuda.get_device_name()`` gives; the first match wins.

Dense bf16 tensor-core FLOP/s and HBM bytes/s from NVIDIA's data sheets,
without sparsity, at the card's full power limit.  A card that matches no
row has no peak: the readers of roofline and utilisation metrics then
report nothing rather than a share of a guessed peak.
"""

from __future__ import annotations

PEAKS = (
    # (name substring, bf16 FLOP/s, HBM bytes/s)
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h100", 989e12, 3.35e12),
)


def card_peaks(name: str) -> tuple[float, float] | None:
    """``(bf16 FLOP/s, bytes/s)`` of the card called ``name``, or None."""
    low = name.lower()
    for key, flops, bw in PEAKS:
        if key in low:
            return flops, bw
    return None
