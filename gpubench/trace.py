"""Reduction of a ``torch.profiler`` trace of a few steps to what the
per-layer metrics and the breakdown read: device time and launches by
kernel name, the union of device intervals (kernels, copies and sets;
not the device-side copies of host ranges) inside the traced span, and the idle gaps, each named by the innermost host operation that
was running at its middle."""

from __future__ import annotations

from dataclasses import dataclass, field

TOP = 10


@dataclass
class Trace:
    #: kernel name -> [device seconds, launches]
    kernels: dict = field(default_factory=dict)
    busy_s: float = 0.0
    window_s: float = 0.0
    #: (seconds, name) of the longest idle gaps, longest first
    gaps: list = field(default_factory=list)

    def kernel(self, *needles) -> tuple[float, int] | None:
        """Seconds and launches of every kernel whose name holds one of
        ``needles``; None when none ran."""
        secs, calls = 0.0, 0
        for name, (s, n) in self.kernels.items():
            if any(k in name for k in needles):
                secs += s
                calls += n
        return (secs, calls) if calls else None

    def breakdown(self) -> dict:
        ops = sorted(((s, n) for n, (s, _) in self.kernels.items()), reverse=True)
        return {"device_ops": [[n[:120], s] for s, n in ops[:TOP]],
                "idle_gaps": [[n[:120], s] for s, n in self.gaps[:TOP]]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_profile(prof, span_name: str) -> Trace:
    """Reduce ``prof`` (a finished ``torch.profiler.profile``) over the
    host span called ``span_name``, which encloses the traced steps."""
    from torch.autograd import DeviceType

    tr = Trace()
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    device, host = [], []
    span = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a record_function range shows on the device's timeline too,
            # under its host name; no kernel, copy or set is named so
            if getattr(e, "is_user_annotation", False) or e.name in host_names:
                continue
            device.append((a, b))
            k = tr.kernels.setdefault(e.name, [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
        else:
            host.append((a, b, e.name))
            if e.name == span_name:
                span = (a, b)
    if span is None:
        raise RuntimeError(f"the trace holds no span {span_name!r}")
    lo, hi = span
    busy = [[max(a, lo), min(b, hi)] for a, b in _merge(device) if b > lo and a < hi]
    tr.busy_s = sum(b - a for a, b in busy) / 1e6
    tr.window_s = (hi - lo) / 1e6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host.sort(key=lambda h: h[1] - h[0])
    for length, start in gaps:
        mid = start + length / 2
        name = next((n for a, b, n in host if a <= mid <= b and n != span_name),
                    "idle host")
        tr.gaps.append((length / 1e6, name))
    return tr
