"""ztrace CLI — merged timelines and critical-path postmortems
(namesake: ``zhpe_ompi_tpu/tools/ztrace.py``).

The consumer half of the tracing plane (:mod:`zhpe_ompi_tpu_torch.runtime.
ztrace` is the recorder): collect every rank's published
``trace:<job>:<rank>`` buffer from the DVM's PMIx store, correct the
per-process monotonic stamps onto ONE timeline — wall anchors by
default, refined by mpisync offsets when the job published a
``tracesync:<job>`` measurement (:func:`publish_clock_sync`) — and
emit:

- **Chrome trace-event JSON** (``chrome://tracing`` / Perfetto): one
  tid per rank, duration events for spans, flow arrows for every
  wire-propagated send→deliver edge;
- a text **critical-path report**: per collective instance the
  straggler rank and a late-sender / late-receiver /
  ring-backpressure classification of its pt2pt pairs, and per FT
  event the recovery's legs (classification→agree→shrink→respawn)
  with the longest leg named.

Clock model: every span stamps ``monotonic_ns`` in its process; the
payload carries the recorder's back-to-back ``(anchor_wall,
anchor_mono_ns)`` pair, defining the rank's *trace clock*
``T_r(t) = anchor_wall + (t − anchor_mono)/1e9``.  mpisync measures
``theta_r = T_r − T_0`` directly (the ``clock`` hook feeds it
:func:`~zhpe_ompi_tpu_torch.runtime.ztrace.trace_clock`), so the corrected
time is ``T_r(t) − theta_r`` — rank 0's trace clock is the merged
timeline's time base, and a deliver span can never precede its parent
send span by more than the estimator's error.
"""

from __future__ import annotations

import json

from ..core import errors
from ..runtime import ztrace as ztrace_rt

_EPS_S = 2e-5  # pairing tolerance: below the min-RTT/2 estimator error


# -- collection --------------------------------------------------------------


def collect(pmix_addr, job: str, timeout: float = 10.0
            ) -> tuple[list[dict], list[float] | None]:
    """Read every published ``trace:<job>:<rank>`` buffer (plus the
    optional ``tracesync:<job>`` offsets) from the store — the
    non-blocking ``lookup`` verb, so ranks that never published are
    simply absent (a kill -9'd victim's LAST periodic buffer is what
    the store holds)."""
    from ..runtime.pmix import PmixClient

    client = PmixClient(pmix_addr, timeout=timeout)
    try:
        view = client.lookup(job, "trace:")
        offsets = None
        sync = client.lookup(job, "tracesync:")
        for _key, value in sorted(sync.items()):
            if isinstance(value, (list, tuple)):
                offsets = [float(v) for v in value]
                break
    finally:
        client.close()
    payloads = []
    for key, payload in sorted(view.items()):
        if not isinstance(payload, dict) or "spans" not in payload:
            continue  # foreign key shape
        payloads.append(payload)
    return payloads, offsets


def publish_clock_sync(ep, rounds: int = 16) -> list[float] | None:
    """Collective over a PMIx-served job's endpoints: run the mpisync
    ping-pong with each process's wall-anchored TRACE clock as the
    measured clock, and publish rank 0's offsets as
    ``tracesync:<job>`` so the ztrace CLI refines its merge with a
    real measurement instead of raw wall anchors.  Returns the offsets
    on rank 0, None elsewhere."""
    from . import mpisync

    offsets = mpisync.sync_clocks(
        ep, rounds=rounds,
        clock=lambda _r: ztrace_rt.trace_clock(),
    )
    if offsets is None:
        return None
    addr = getattr(ep, "_pmix_addr", None)
    ns = getattr(ep, "_pmix_ns", None)
    if addr is None:
        raise errors.UnsupportedError(
            "publish_clock_sync needs a PMIx-served endpoint (the "
            "tracesync key lives in the job's namespace)"
        )
    from ..runtime.pmix import PmixClient

    client = PmixClient(addr, timeout=10.0)
    try:
        client.put(ns, ep.rank, f"tracesync:{ns}",
                   [float(o) for o in offsets])
        client.commit(ns, ep.rank)
    finally:
        client.close()
    return offsets


# -- clock correction + merge ------------------------------------------------


def corrected_spans(payloads: list[dict],
                    offsets: list[float] | None = None) -> list[dict]:
    """One flat span list on the merged timeline: every span gains
    ``ts``/``dur`` (seconds, rank 0's trace clock) and ``tid`` (the
    publishing rank).  ``offsets[r]`` is rank r's trace clock minus
    rank 0's (the mpisync estimate); absent offsets fall back to the
    raw wall anchors (exact for same-host jobs whose wall clock is
    shared, the loopback-emulation case)."""
    def theta_of(r: int) -> float:
        if offsets is not None and 0 <= r < len(offsets):
            return float(offsets[r])
        return 0.0

    out = []
    seen: set[int] = set()
    for payload in payloads:
        rank = int(payload.get("rank", -1))
        wall = float(payload.get("anchor_wall", 0.0))
        mono = int(payload.get("anchor_mono_ns", 0))
        for span in payload.get("spans", ()):
            sid = span.get("sid")
            # thread-plane jobs share ONE per-process ring: every
            # rank's publisher ships the same spans, so dedup by sid
            # and attribute each span to ITS recording rank, not the
            # publishing payload's — else the merge holds every span
            # N-fold with wrong rank attribution
            if sid is not None:
                if sid in seen:
                    continue
                seen.add(sid)
            s = dict(span)
            srank = int(s.get("rank", -1))
            tid = srank if srank >= 0 else rank
            theta = theta_of(tid)
            t0 = wall + (int(s["t0"]) - mono) / 1e9 - theta
            t1 = wall + (int(s["t1"]) - mono) / 1e9 - theta
            s["ts"] = t0
            s["dur"] = max(0.0, t1 - t0)
            s["tid"] = tid
            out.append(s)
    out.sort(key=lambda s: s["ts"])
    return out


def happens_before_violations(spans: list[dict],
                              tolerance: float = _EPS_S) -> list[tuple]:
    """Clock-corrected causality check: a deliver/cts span whose
    corrected start precedes its parent send span's START (beyond the
    estimator tolerance) is a correction failure — the merged-timeline
    test gate."""
    by_sid = {s["sid"]: s for s in spans}
    bad = []
    for s in spans:
        parent = s.get("parent")
        if parent is None or s["kind"] not in ("deliver", "cts"):
            continue
        src = by_sid.get(parent)
        if src is None:
            continue
        if s["ts"] < src["ts"] - tolerance:
            bad.append((src, s, src["ts"] - s["ts"]))
    return bad


# -- Chrome trace-event output ----------------------------------------------


def chrome_trace(payloads: list[dict],
                 offsets: list[float] | None = None,
                 job: str = "zmpi") -> dict:
    """The ``chrome://tracing`` / Perfetto JSON object: one pid for
    the job, one tid per rank, ``X`` (complete) events for spans,
    flow arrows (``s``/``f``) along every cross-rank parent edge."""
    spans = corrected_spans(payloads, offsets)
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(s["ts"] for s in spans)
    by_sid = {s["sid"]: s for s in spans}
    events: list[dict] = []
    for rank in sorted({s["tid"] for s in spans}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": job,
            "tid": rank, "args": {"name": f"rank {rank}"},
        })
    for s in spans:
        args = {k: v for k, v in s.items()
                if k not in ("ts", "dur", "tid", "sid", "kind", "t0",
                             "t1")}
        name = s["kind"]
        if "op" in s:
            name = f"{s['kind']}:{s['op']}"
        elif "name" in s:
            name = f"{s['kind']}:{s['name']}"
        events.append({
            "name": name, "ph": "X", "cat": s["kind"],
            "ts": (s["ts"] - t_base) * 1e6,
            "dur": max(s["dur"] * 1e6, 1.0),
            "pid": job, "tid": s["tid"], "args": args,
        })
        parent = s.get("parent")
        src = by_sid.get(parent) if parent is not None else None
        if src is not None and src["tid"] != s["tid"]:
            # a cross-rank causal edge: draw the flow arrow
            fid = f"f{parent}-{s['sid']}"
            events.append({
                "name": "msg", "ph": "s", "cat": "flow", "id": fid,
                "ts": (src["ts"] - t_base) * 1e6, "pid": job,
                "tid": src["tid"],
            })
            events.append({
                "name": "msg", "ph": "f", "bp": "e", "cat": "flow",
                "id": fid, "ts": (s["ts"] - t_base) * 1e6, "pid": job,
                "tid": s["tid"],
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- critical-path report ----------------------------------------------------


def _pair_messages(spans: list[dict]) -> list[dict]:
    """Deliver→send→recv triples: each deliver span references its
    parent send by sid; the matching recv on the deliver's rank is the
    earliest compatible recv span (cid equal, src/tag wildcard-aware)
    completing at/after the delivery."""
    by_sid = {s["sid"]: s for s in spans}
    recvs_by_rank: dict[int, list[dict]] = {}
    for s in spans:
        if s["kind"] == "recv":
            recvs_by_rank.setdefault(s["tid"], []).append(s)
    for rs in recvs_by_rank.values():
        rs.sort(key=lambda r: r["ts"])
    used: set[int] = set()
    pairs = []
    for d in spans:
        # eager/loopback/sm messages pair at their deliver span; a
        # rendezvous message pairs at its receiver-side CTS leg (the
        # user-visible envelope — the tcp data frame rides a protocol
        # cid, and the thread plane's data deliver is marked leg=data)
        if d["kind"] not in ("deliver", "cts"):
            continue
        if d.get("leg") == "data":
            continue  # rndv bulk leg: already paired at its CTS
        send = by_sid.get(d.get("parent"))
        if send is None or send["kind"] != "send":
            continue
        recv = None
        for r in recvs_by_rank.get(d["tid"], ()):
            if id(r) in used:
                continue
            if r.get("cid") != d.get("cid"):
                continue  # recv spans stamp the posted cid exactly
            if r.get("src", -1) not in (-1, d.get("src")):
                continue
            if r.get("tag", -1) not in (-1, d.get("tag")):
                continue
            if r["ts"] + r["dur"] + _EPS_S < d["ts"]:
                continue  # completed before this delivery: other msg
            recv = r
            used.add(id(r))
            break
        if recv is not None:
            pairs.append({"send": send, "deliver": d, "recv": recv})
    return pairs


def _classify_pair(pair: dict) -> str:
    """The mpiP/Vampir taxonomy on one message: the receiver posted
    before the message arrived → it WAITED on a late sender; the
    message arrived (parked unexpected) before the post → late
    receiver; otherwise balanced."""
    d, r = pair["deliver"], pair["recv"]
    if pair["send"].get("bp"):
        return "ring-backpressure"
    if r["ts"] + _EPS_S < d["ts"]:
        return "late-sender"
    if d["ts"] + _EPS_S < r["ts"]:
        return "late-receiver"
    return "balanced"


def _coll_instances(spans: list[dict]) -> list[dict]:
    """COLL spans grouped into per-instance windows: the i-th
    occurrence of op X on every rank is one collective instance (the
    schedules are collective-ordered by construction — the same
    counter discipline the tag windows use)."""
    per_rank: dict[tuple, list[dict]] = {}
    for s in spans:
        if s["kind"] != "coll":
            continue
        per_rank.setdefault((s["tid"], s.get("op", "?")), []).append(s)
    for v in per_rank.values():
        v.sort(key=lambda s: s["ts"])
    instances: dict[tuple, dict] = {}
    for (rank, op), rows in per_rank.items():
        for i, s in enumerate(rows):
            inst = instances.setdefault((op, i), {
                "op": op, "index": i, "ranks": {},
            })
            inst["ranks"][rank] = s
    out = []
    for (op, i), inst in sorted(instances.items()):
        rows = inst["ranks"]
        inst["t0"] = min(s["ts"] for s in rows.values())
        inst["t1"] = max(s["ts"] + s["dur"] for s in rows.values())
        inst["straggler"] = max(rows, key=lambda r: rows[r]["ts"])
        inst["straggler_lag"] = rows[inst["straggler"]]["ts"] - inst["t0"]
        out.append(inst)
    return out


def _recovery_legs(spans: list[dict]) -> list[dict]:
    """Per FT classification (crash causes only): the recovery spans
    that follow it — agreement, shrink, respawn, and the rollback
    (checkpoint-restore) leg — with the longest leg named.  Goodbyes
    are orderly departures, not recoveries."""
    events = []
    for ft in spans:
        if ft["kind"] != "ft_class" or ft.get("cause") == "goodbye":
            continue
        events.append(ft)
    # one recovery per failed rank: the earliest classification wins
    # (every survivor records one; they describe the same recovery)
    seen: set[int] = set()
    roots = []
    for ft in sorted(events, key=lambda s: s["ts"]):
        victim = ft.get("failed", -1)
        if victim in seen:
            continue
        seen.add(victim)
        roots.append(ft)
    out = []
    for i, ft in enumerate(roots):
        # a recovery's legs live between ITS classification and the
        # NEXT victim's — without the upper bound, a later failure's
        # (usually long) respawn would be misattributed to every
        # earlier recovery in a multi-failure postmortem
        upper = roots[i + 1]["ts"] if i + 1 < len(roots) \
            else float("inf")
        legs = [
            s for s in spans
            if s["kind"] in ("agree", "shrink", "respawn", "rollback")
            and ft["ts"] - _EPS_S <= s["ts"] < upper - _EPS_S
        ]
        out.append({
            "victim": ft.get("failed", -1),
            "cause": ft.get("cause", "?"),
            "t": ft["ts"],
            "legs": legs,
            "longest": max(legs, key=lambda s: s["dur"])
            if legs else None,
        })
    return out


def critical_path_report(payloads: list[dict],
                         offsets: list[float] | None = None) -> str:
    """The text postmortem: per collective instance its straggler and
    message-pair classification, per FT event the recovery legs and
    the longest one."""
    spans = corrected_spans(payloads, offsets)
    lines = [
        f"ztrace critical-path report — {len(payloads)} rank buffer(s), "
        f"{len(spans)} span(s), offsets "
        f"{'mpisync' if offsets is not None else 'wall-anchor'}",
    ]
    dropped = {
        int(p.get("rank", -1)): int(p.get("dropped", 0))
        for p in payloads if int(p.get("dropped", 0)) > 0
    }
    if dropped:
        # a truncated ring breaks the per-rank occurrence pairing the
        # collective instances below rely on — say so up front rather
        # than letting a misaligned merge read as authoritative
        lines.append(
            "WARNING: span ring overwrote on "
            + ", ".join(f"rank {r} ({n} dropped)"
                        for r, n in sorted(dropped.items()))
            + " — collective instance pairing may be misaligned "
            "(raise ztrace_capacity)"
        )
    pairs = _pair_messages(spans)
    insts = _coll_instances(spans)
    if insts:
        lines.append("")
        lines.append("collectives:")
        for inst in insts:
            window_pairs = [
                p for p in pairs
                if inst["t0"] - _EPS_S <= p["deliver"]["ts"]
                <= inst["t1"] + _EPS_S
            ]
            counts: dict[str, int] = {}
            for p in window_pairs:
                c = _classify_pair(p)
                counts[c] = counts.get(c, 0) + 1
            if counts.get("ring-backpressure"):
                label = "ring-backpressure"
            elif counts.get("late-sender", 0) > counts.get(
                    "late-receiver", 0):
                label = "late-sender"
            elif counts.get("late-receiver", 0) > 0:
                label = "late-receiver"
            else:
                label = "balanced"
            detail = ", ".join(
                f"{k}={v}" for k, v in sorted(counts.items())
            ) or "no pairs in window"
            lines.append(
                f"  {inst['op']}[{inst['index']}]: "
                f"{len(inst['ranks'])} rank(s), straggler rank "
                f"{inst['straggler']} "
                f"(+{inst['straggler_lag'] * 1e3:.2f} ms), "
                f"classification {label} ({detail})"
            )
    recoveries = _recovery_legs(spans)
    if recoveries:
        lines.append("")
        lines.append("ft recoveries:")
        for rec in recoveries:
            lines.append(
                f"  rank {rec['victim']} ({rec['cause']}): "
                f"{len(rec['legs'])} recovery leg span(s)"
            )
            for s in sorted(rec["legs"], key=lambda s: s["ts"]):
                mark = "  <-- longest leg" \
                    if s is rec["longest"] else ""
                lines.append(
                    f"    {s['kind']:8s} rank {s['tid']} "
                    f"{s['dur'] * 1e3:9.2f} ms{mark}"
                )
    hb = happens_before_violations(spans)
    lines.append("")
    lines.append(
        f"happens-before: {len(hb)} violation(s) after clock correction"
    )
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser(
        description="merged-timeline trace collector (ztrace)")
    p.add_argument("--pmix", required=True,
                   help="the DVM store address host:port (zprted "
                        "prints it at startup)")
    p.add_argument("--job", required=True, help="job id / namespace")
    p.add_argument("-o", "--out", default=None,
                   help="write Chrome trace-event JSON here")
    p.add_argument("--report", action="store_true",
                   help="print the critical-path report")
    args = p.parse_args(argv)
    host, port = args.pmix.rsplit(":", 1)
    payloads, offsets = collect((host, int(port)), args.job)
    if not payloads:
        print(f"no trace:{args.job}:* buffers published — launch with "
              f"--trace / ZMPI_TRACE=1")
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(chrome_trace(payloads, offsets, job=args.job), f)
        print(f"wrote {args.out} "
              f"({sum(len(p.get('spans', ())) for p in payloads)} "
              f"spans, {len(payloads)} ranks)")
    if args.report or not args.out:
        print(critical_path_report(payloads, offsets))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
