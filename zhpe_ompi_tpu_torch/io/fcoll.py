"""fcoll framework — collective-IO aggregation strategies (namesake:
``zhpe_ompi_tpu/io/fcoll.py``).

Analog of OMPIO's ``fcoll`` sub-framework
(``ompi/mca/fcoll/{two_phase,dynamic,dynamic_gen2,individual,vulcan}``):
given every rank's (byte offset -> byte) assignment for one collective
call, a strategy decides how to schedule the physical transfers through
the fbtl.  Three components, selected by priority or ``ZMPI_MCA_fcoll``:

- **two_phase** (default, priority 20): globally sort and coalesce all
  ranks' extents into maximal runs, one aggregated pass — the
  ``fcoll/two_phase`` shape minus the inter-process exchange a single
  controller does not need.
- **dynamic** (priority 15): partition the file range into fixed stripes
  (``fcoll_dynamic_stripe`` bytes, the dynamic_gen2 aggregator-stripe
  shape) and aggregate each stripe independently — bounds the working
  set of the sort/coalesce at a small cost in run merging across stripe
  boundaries.
- **individual** (priority 5): no cross-rank aggregation; each rank's
  extents are transferred in rank order (``fcoll/individual`` — the
  degenerate strategy that always works).
"""

from __future__ import annotations

import numpy as np

from ..mca import component as mca_component
from ..mca import var as mca_var
from .fbtl import FbtlComponent


def runs_of(offsets: np.ndarray):
    """Coalesce sorted byte offsets into maximal (start, length) runs."""
    if offsets.size == 0:
        return []
    breaks = np.nonzero(np.diff(offsets) != 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [offsets.size - 1]))
    return [
        (int(offsets[s]), int(offsets[e] - offsets[s] + 1))
        for s, e in zip(starts, ends)
    ]


class FcollComponent(mca_component.Component):
    framework_name = "fcoll"

    def write(self, fbtl: FbtlComponent, fd: int, per_rank) -> int:
        """per_rank: list of (offsets int64 array, data uint8 array);
        returns total bytes written."""
        raise NotImplementedError

    def read(self, fbtl: FbtlComponent, fd: int, per_rank_offsets
             ) -> list[np.ndarray]:
        """per_rank_offsets: list of int64 arrays; returns each rank's
        bytes in its own offset order."""
        raise NotImplementedError


def _flatten(per_rank):
    offsets = (np.concatenate([o for o, _ in per_rank])
               if per_rank else np.empty(0, np.int64))
    data = (np.concatenate([d for _, d in per_rank])
            if per_rank else np.empty(0, np.uint8))
    return offsets, data


class TwoPhaseFcoll(FcollComponent):
    """Global sort + coalesce, one aggregated pass."""

    name = "two_phase"
    default_priority = 20

    def write(self, fbtl, fd, per_rank) -> int:
        offsets, data = _flatten(per_rank)
        order = np.argsort(offsets, kind="stable")
        return fbtl.pwritev(fd, runs_of(offsets[order]), data[order])

    def read(self, fbtl, fd, per_rank_offsets):
        offsets = (np.concatenate(per_rank_offsets)
                   if per_rank_offsets else np.empty(0, np.int64))
        order = np.argsort(offsets, kind="stable")
        gathered = np.empty(offsets.size, dtype=np.uint8)
        gathered[order] = fbtl.preadv(
            fd, runs_of(offsets[order]), offsets.size
        )
        out, pos = [], 0
        for offs in per_rank_offsets:
            out.append(gathered[pos : pos + offs.size])
            pos += offs.size
        return out


class DynamicFcoll(FcollComponent):
    """Stripe-partitioned aggregation (dynamic_gen2 shape)."""

    name = "dynamic"
    default_priority = 15

    def register_params(self) -> None:
        mca_var.register(
            "fcoll_dynamic_stripe", 4 * 1024 * 1024,
            "Aggregation stripe size (bytes) of the dynamic fcoll "
            "strategy (the dynamic_gen2 per-aggregator extent)",
            type=int,
        )

    def _stripe(self) -> int:
        return int(mca_var.get("fcoll_dynamic_stripe", 4 * 1024 * 1024))

    def write(self, fbtl, fd, per_rank) -> int:
        offsets, data = _flatten(per_rank)
        if offsets.size == 0:
            return 0
        order = np.argsort(offsets, kind="stable")
        offsets, data = offsets[order], data[order]
        stripe = self._stripe()
        total = 0
        bounds = offsets // stripe
        # stripes are contiguous groups after the global sort
        cut = np.nonzero(np.diff(bounds))[0] + 1
        for seg_off, seg_dat in zip(np.split(offsets, cut),
                                    np.split(data, cut)):
            total += fbtl.pwritev(fd, runs_of(seg_off), seg_dat)
        return total

    def read(self, fbtl, fd, per_rank_offsets):
        offsets = (np.concatenate(per_rank_offsets)
                   if per_rank_offsets else np.empty(0, np.int64))
        gathered = np.empty(offsets.size, dtype=np.uint8)
        if offsets.size:
            order = np.argsort(offsets, kind="stable")
            srt = offsets[order]
            stripe = self._stripe()
            cut = np.nonzero(np.diff(srt // stripe))[0] + 1
            parts = []
            for seg in np.split(srt, cut):
                parts.append(fbtl.preadv(fd, runs_of(seg), seg.size))
            gathered[order] = np.concatenate(parts)
        out, pos = [], 0
        for offs in per_rank_offsets:
            out.append(gathered[pos : pos + offs.size])
            pos += offs.size
        return out


class IndividualFcoll(FcollComponent):
    """No cross-rank aggregation (fcoll/individual)."""

    name = "individual"
    default_priority = 5

    def write(self, fbtl, fd, per_rank) -> int:
        total = 0
        for offs, data in per_rank:
            order = np.argsort(offs, kind="stable")
            total += fbtl.pwritev(fd, runs_of(offs[order]), data[order])
        return total

    def read(self, fbtl, fd, per_rank_offsets):
        out = []
        for offs in per_rank_offsets:
            order = np.argsort(offs, kind="stable")
            raw = np.empty(offs.size, dtype=np.uint8)
            raw[order] = fbtl.preadv(fd, runs_of(offs[order]), offs.size)
            out.append(raw)
        return out


def fcoll_framework() -> mca_component.Framework:
    return mca_component.build_framework(
        "fcoll", "collective IO strategies",
        (TwoPhaseFcoll, DynamicFcoll, IndividualFcoll),
    )


def select_fcoll() -> FcollComponent:
    return fcoll_framework().select_one()
