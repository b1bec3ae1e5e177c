"""OSU-microbenchmark-style harness of the PyTorch port (namesake: the
repository's ``benchmarks/osu_zmpi.py``, SURVEY.md §6).

The reference ships no benchmarks in-tree — Open MPI is measured with the
external OSU/IMB suites (osu_allreduce, osu_bcast, osu_latency).  This is
the in-tree equivalent for the port: per-algorithm device collective
latency/bandwidth sweeps over OSU's size ladder (``Communicator`` →
``coll/tuned`` → ``coll/nccl`` on the card, gloo with ``--device cpu``),
the device liveness probe, and every host-plane ladder — ping-pong and
streaming pt2pt over the thread universe, TCP and the shared-memory
rings, host collectives, the hierarchical (han, NUMA, alltoall) ladders,
compute/communication overlap, one-sided direct-map RMA, the tracing
A/B, and the launch, resize and scale-out runtime ladders — all emitting
the familiar two-column table, each with the namesake's counter gates (a
ladder that silently fell back fails loudly).

Usage (``osu="python -m zhpe_ompi_tpu_torch.benchmarks.osu_zmpi"``)::

    $osu --op allreduce --algorithm ring
    $osu --op bcast --max-size 1048576
    $osu --op allreduce --device cpu
    $osu --op pt2pt
    $osu --op pt2pt --bw --json   # osu_bw shape
    $osu --op tcp --bw
    $osu --op allreduce --plane host --algorithm ring
    $osu --op all --json

The device plane runs on this process's CUDA device unless ``--device
cpu`` (``device="cpu"``) asks for gloo, and raises without a card; a
multi-rank device ladder is one process per rank under torchrun's
environment (``runtime.init`` joins it).  The host-plane ladders create
no CUDA context.

``--bw`` switches the pt2pt/tcp ops from ping-pong latency (osu_latency)
to the multi-frame in-flight bandwidth shape (osu_bw): the sender streams
a window of frames back-to-back, the receiver acks once per window —
measuring the wire plane's streaming throughput, where the zero-copy
framing matters most.  ``--plane host`` runs the collective over REAL
loopback sockets through coll/host (the DCN leg), instead of the
device-plane collectives.

``--plane sm`` measures the shared-memory plane: same-host ranks with
the mmap-ring transport selected (``pt2pt/sm.py``) — pt2pt
latency/bandwidth and the host collectives both, failing loudly if any
send silently fell back to TCP (``sm_fallback_tcp_sends`` must stay 0
along the ladder).  ``--real-procs`` runs the ranks as separate OS
processes (the cross-process case the ring exists for; the default
thread harness shares one GIL and understates the win)::

    $osu --op tcp --plane sm --real-procs
    $osu --op tcp --plane sm --bw --real-procs
    $osu --op allreduce --plane sm --nprocs 4
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Callable

import numpy as np

from ..utils import lockdep

#: what ``--real-procs`` worker interpreters run (``-m``), also when the
#: parent runs as ``__main__``
_MODULE = "zhpe_ompi_tpu_torch.benchmarks.osu_zmpi"

#: the checkout's root: worker interpreters and launched probe programs
#: import the port from here
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bench_env(repo: str) -> dict:
    """Worker-process environment: lockdep-OFF is the bench default —
    the lock-order witness belongs to the test suite; measured paths run
    the raw primitives so the numbers are honest.  ``--lockdep`` opts
    back in explicitly."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # force the flag BOTH ways: --lockdep must instrument the worker
    # ranks too (their transports construct locks at import), and the
    # default must strip an inherited ZMPI_LOCKDEP=1
    env["ZMPI_LOCKDEP"] = "1" if _keep_lockdep[0] else "0"
    # an inherited fleet-global ZMPI_METRICS must not arm publishers on
    # rows that have no store; an inherited ZMPI_TRACE=1 would grow every
    # frame by the wire context and contaminate the wire-byte gates
    env.pop("ZMPI_METRICS", None)
    env.pop("ZMPI_TRACE", None)
    return env


#: mutated once by main() when --lockdep is passed
_keep_lockdep = [False]


def _sizes(max_bytes: int, min_bytes: int = 4) -> list[int]:
    out = []
    s = min_bytes
    while s <= max_bytes:
        out.append(s)
        s *= 4
    return out


def _time_op(fn: Callable[[], None], warmup: int = 2, iters: int = 10
             ) -> float:
    """Median wall-clock seconds of fn() (fn must block to completion)."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def _rung(world, nbytes: int, dtype, device):
    """This rank's buffer of one device-ladder rung: row ``rank`` of
    ``arange(n * count).reshape(n, count)``, ``count`` the namesake's rule
    (at least one element per rank, divisible by the size for the
    scatter-type ops)."""
    import torch

    n = world.size
    itemsize = torch.empty((), dtype=dtype).element_size()
    count = max(n, nbytes // itemsize)
    count = -(-count // n) * n
    rank = world.rank
    x = torch.arange(rank * count, (rank + 1) * count, dtype=torch.float64)
    return x.to(dtype=dtype, device=device)


def _collective(world, opname: str, x):
    """The rank's call of ``opname`` on its rung buffer ``x`` (rooted
    collectives at root 0), as the timed closure."""
    if opname in ("bcast", "gather", "scatter"):
        return lambda: getattr(world, opname)(x, 0)
    return lambda: getattr(world, opname)(x)


def bench_collective(opname: str, algorithm: str = "auto",
                     max_size: int = 4 << 20, iters: int = 10,
                     dtype=None, device=None) -> list[dict]:
    """Latency sweep of one collective, optionally pinning the tuned
    algorithm (the MCA forced-algorithm knob).  ``world = runtime.init(
    device=device)``: CUDA by default (NCCL; raises without a card),
    ``device="cpu"`` for gloo; each timed call ends in a device
    synchronise.  The rows are this rank's."""
    import torch

    from ..mca import var as mca_var
    from ..runtime import init as rt

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' for the gloo device plane")
    world = rt.init(device=device)
    dtype = dtype or torch.float32
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    rows = []
    for nbytes in _sizes(max_size):
        xs = _rung(world, nbytes, dtype, dev)
        nbytes = xs.nbytes
        call = _collective(world, opname, xs)

        def once(call=call):
            call()
            sync()

        if algorithm != "auto":
            mca_var.set_var(f"coll_tuned_{opname}_algorithm", algorithm)
        try:
            once()  # first call: lazy communicator and buffers
            sec = _time_op(once, iters=iters)
        finally:
            if algorithm != "auto":
                mca_var.set_var(f"coll_tuned_{opname}_algorithm", "auto")

        rows.append({
            "op": opname, "algorithm": algorithm, "bytes": nbytes,
            "latency_us": sec * 1e6,
            "bandwidth_MBps": (nbytes / sec) / 1e6,
        })
    return rows


def bench_device_probe(rounds: int = 3, device=None) -> list[dict]:
    """``--plane device`` probe row: the device liveness probe
    (parallel/mesh.probe_device_plane — the killable-child one-element
    all-reduce the fault loop arms) run ``rounds`` times against the
    healthy plane on this process's card (``device="cpu"``: gloo),
    COUNTER-GATED:

    - ``device_probe_rounds`` rose by exactly the rounds launched;
    - ``device_probe_misses`` and ``device_faults`` stayed ZERO — with
      no wedge injected, any classification is a false positive and
      fails the run loudly (the device plane's zero-false-positive
      contract, the twin of the detector gate).

    Latency is REPORT-ONLY (the child's ``import torch`` and CUDA
    context dominate it); the gates are the deliverable."""
    from ..parallel import mesh as mesh_mod
    from ..runtime import spc

    before = spc.snapshot()
    lats = []
    for i in range(max(1, rounds)):
        t0 = time.perf_counter()
        kind, detail = mesh_mod.probe_device_plane(device=device)
        lats.append(time.perf_counter() - t0)
        if kind != "ok":
            raise SystemExit(
                f"--plane device probe round {i}: healthy plane "
                f"answered {kind!r} ({detail}) — a false-positive "
                "classification path, failing the run")
    after = spc.snapshot()
    got_rounds = after.get("device_probe_rounds", 0) \
        - before.get("device_probe_rounds", 0)
    misses = after.get("device_probe_misses", 0) \
        - before.get("device_probe_misses", 0)
    faults = after.get("device_faults", 0) \
        - before.get("device_faults", 0)
    if got_rounds < max(1, rounds) or misses or faults:
        raise SystemExit(
            f"--plane device probe gates failed: rounds={got_rounds} "
            f"(want >= {max(1, rounds)}), misses={misses} (want 0), "
            f"device_faults={faults} (want 0)")
    return [{
        "op": "device_probe", "rounds": got_rounds,
        "misses": misses, "device_faults": faults,
        "probe_latency_ms": float(np.median(lats)) * 1e3,  # report-only
    }]


def bench_pt2pt(max_size: int = 4 << 20, iters: int = 50,
                bw: bool = False, window: int = 16) -> list[dict]:
    """Host-plane pt2pt over the thread-rank universe — the btl/self+sm
    loopback analog.  Default: ping-pong latency (osu_latency shape).
    ``bw=True``: multi-frame in-flight bandwidth (osu_bw shape — the
    sender streams `window` messages, the receiver acks per window)."""
    from ..pt2pt.requests import wait_all
    from ..pt2pt.universe import LocalUniverse

    rows = []
    for nbytes in _sizes(max_size):
        payload = np.zeros(max(1, nbytes // 8), dtype=np.float64)
        uni = LocalUniverse(2)

        def main_latency(ctx, payload=payload):
            if ctx.rank == 0:
                # warmup
                ctx.send(payload, dest=1, tag=1)
                ctx.recv(source=1, tag=2)
                t0 = time.perf_counter()
                for _ in range(iters):
                    ctx.send(payload, dest=1, tag=1)
                    ctx.recv(source=1, tag=2)
                return (time.perf_counter() - t0) / iters
            ctx.recv(source=0, tag=1)
            ctx.send(payload, dest=0, tag=2)
            for _ in range(iters):
                ctx.recv(source=0, tag=1)
                ctx.send(payload, dest=0, tag=2)
            return None

        def main_bw(ctx, payload=payload):
            reps = max(1, iters // 4)
            if ctx.rank == 0:
                wait_all([ctx.isend(payload, 1, tag=1)
                          for _ in range(window)])
                ctx.recv(source=1, tag=2)  # warmup window + ack
                t0 = time.perf_counter()
                for _ in range(reps):
                    wait_all([ctx.isend(payload, 1, tag=1)
                              for _ in range(window)])
                    ctx.recv(source=1, tag=2)
                # seconds per one-way message, amortized over the window
                return (time.perf_counter() - t0) / (reps * window)
            for _ in range(reps + 1):
                reqs = [ctx.irecv(source=0, tag=1) for _ in range(window)]
                wait_all(reqs)
                ctx.send(b"ack", dest=0, tag=2)
            return None

        try:
            sec = uni.run(main_bw if bw else main_latency)[0]
        finally:
            uni.close()  # the port's universes retire explicitly
        one_way = sec if bw else sec / 2
        rows.append({
            "op": "pt2pt_bw" if bw else "pt2pt_pingpong",
            "bytes": payload.nbytes,
            "latency_us": one_way * 1e6,  # one-way, OSU convention
            "bandwidth_MBps": (payload.nbytes / one_way) / 1e6,
        })
    return rows


def _run_tcp_ranks(n: int, fn, timeout: float = 180.0,
                   sm: bool | None = None,
                   kwargs_by_rank: dict | None = None) -> list:
    """Launch fn(proc) on n TcpProc ranks over localhost sockets; rank 0
    binds an ephemeral coordinator the others learn through the
    on_coordinator_bound hook (prte forwarding the PMIx URI).  ``sm``
    pins the shared-memory transport on/off per proc (None = MCA
    default); ``kwargs_by_rank`` adds per-rank constructor overrides
    (the han ladder's emulated-host ``sm_boot_id`` pins)."""
    from ..pt2pt.tcp import TcpProc

    coord: list = []
    coord_ready = threading.Event()
    results: list = [None] * n
    excs: list = [None] * n

    def main(rank):
        kw = dict((kwargs_by_rank or {}).get(rank, {}))
        try:
            if rank == 0:
                proc = TcpProc(
                    0, n, coordinator=("127.0.0.1", 0), sm=sm,
                    on_coordinator_bound=lambda addr: (
                        coord.append(addr), coord_ready.set()), **kw,
                )
            else:
                if not coord_ready.wait(30.0) or not coord:
                    return  # rank 0 failed; its error is in excs[0]
                proc = TcpProc(rank, n, coordinator=tuple(coord[0]),
                               sm=sm, **kw)
            try:
                results[rank] = fn(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[rank] = e
            coord_ready.set()

    threads = [threading.Thread(target=main, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for e in excs:
        if e is not None:
            raise RuntimeError(f"tcp bench rank failed: {e!r}") from e
    return results


def _pingpong(proc, payload, iters: int):
    """osu_latency body over one endpoint pair: rank 0 returns seconds
    per round trip, rank 1 echoes."""
    if proc.rank == 0:
        proc.send(payload, dest=1, tag=1)
        proc.recv(source=1, tag=2, timeout=120.0)
        t0 = time.perf_counter()
        for _ in range(iters):
            proc.send(payload, dest=1, tag=1)
            proc.recv(source=1, tag=2, timeout=120.0)
        return (time.perf_counter() - t0) / iters
    proc.recv(source=0, tag=1, timeout=120.0)
    proc.send(payload, dest=0, tag=2)
    for _ in range(iters):
        proc.recv(source=0, tag=1, timeout=120.0)
        proc.send(payload, dest=0, tag=2)
    return None


def _stream(proc, payload, iters: int, window: int):
    """osu_bw body: `window` frames in flight per ack; rank 0 returns
    seconds per one-way message amortized over the window."""
    reps = max(1, iters // 4)
    if proc.rank == 0:
        for _ in range(window):
            proc.send(payload, dest=1, tag=1)
        proc.recv(source=1, tag=2, timeout=120.0)  # warmup window + ack
        t0 = time.perf_counter()
        for _ in range(reps):
            for _ in range(window):
                proc.send(payload, dest=1, tag=1)
            proc.recv(source=1, tag=2, timeout=120.0)
        return (time.perf_counter() - t0) / (reps * window)
    for _ in range(reps + 1):
        for _ in range(window):
            proc.recv(source=0, tag=1, timeout=120.0)
        proc.send(b"ack", dest=0, tag=2)
    return None


def _pt2pt_ladder(max_size: int, iters: int, bw: bool, window: int,
                  sm: bool) -> list[dict]:
    """One size ladder over a TcpProc pair in the thread harness —
    shared by the tcp and sm planes; the sm run adds the
    loud-degradation gate (no silent TCP fallback, bytes must cross
    the rings at every rung)."""
    from ..runtime import spc

    rows = []
    op = ("sm_" if sm else "tcp_") + ("bw" if bw else "pingpong")
    for nbytes in _sizes(max_size):
        payload = np.zeros(max(1, nbytes // 8), dtype=np.float64)
        fb0 = spc.read("sm_fallback_tcp_sends")
        sent0 = spc.read("sm_bytes_sent")

        def prog(proc, payload=payload):
            if bw:
                return _stream(proc, payload, iters, window)
            return _pingpong(proc, payload, iters)

        sec = _run_tcp_ranks(2, prog, sm=sm)[0]
        if sm:
            if spc.read("sm_fallback_tcp_sends") != fb0:
                raise RuntimeError(
                    f"sm plane at {payload.nbytes}B: sends silently "
                    "fell back to TCP"
                )
            if spc.read("sm_bytes_sent") == sent0:
                raise RuntimeError(
                    f"sm plane at {payload.nbytes}B: no bytes crossed "
                    "the rings (selection failed?)"
                )
        one_way = sec if bw else sec / 2
        rows.append({
            "op": op,
            "bytes": payload.nbytes,
            "latency_us": one_way * 1e6,
            "bandwidth_MBps": (payload.nbytes / one_way) / 1e6,
        })
    return rows


def bench_tcp(max_size: int = 4 << 20, iters: int = 50,
              bw: bool = False, window: int = 16) -> list[dict]:
    """REAL-socket pt2pt (over btl/tcp): two TcpProc endpoints over
    loopback, eager and rendezvous regimes both crossed as the ladder
    passes tcp_eager_limit.  Default: ping-pong latency (osu_latency).
    ``bw=True``: multi-frame in-flight bandwidth (osu_bw — `window`
    frames streamed per ack, so TCP keeps its pipe full).  The
    shared-memory transport is pinned OFF: this op measures the WIRE;
    use :func:`bench_sm` / ``--plane sm`` for the rings."""
    return _pt2pt_ladder(max_size, iters, bw, window, sm=False)


def _wire_quiesced(skew: int = 0, deadline_s: float = 5.0) -> None:
    """Wait until the process-global wire counters are quiescent:
    both ladder ranks live in THIS process (the thread harness), so
    at quiescence every frame THIS RUN counted received has its sent
    twin counted too — the peer's ``spc.record`` for a boundary frame
    can lag the frame's delivery by a scheduler quantum, and a
    snapshot taken in that window is off by one frame
    nondeterministically.  ``skew`` is the sent−recvd imbalance the
    process carried BEFORE this run (earlier suites tearing endpoints
    down mid-flight leave the lifetime counters permanently skewed);
    quiescence is the imbalance returning to that baseline, never
    absolute equality of the cumulative totals."""
    from ..runtime import spc

    deadline = time.monotonic() + deadline_s
    stable = 0
    last = (-1, -1)
    while time.monotonic() < deadline:
        now = (spc.read("tcp_bytes_sent"), spc.read("tcp_bytes_recvd"))
        if now[0] - now[1] == skew and now == last:
            stable += 1
            if stable >= 2:
                return
        else:
            stable = 0
        last = now
        time.sleep(0.002)
    raise RuntimeError(
        f"trace A/B: wire counters never quiesced "
        f"(sent/recvd {last}, baseline skew {skew})"
    )


def _trace_probe_body(proc, payload, iters: int, out: dict,
                      skew: int = 0):
    """Ladder body for the ``--trace`` A/B: one unmeasured exchange
    quiesces the wiring (modex/hello bytes — their encoding varies
    with the run's ephemeral ports — all land before the snapshot),
    then the measured ping-pong runs between two counter snapshots
    taken on rank 0 at wire quiescence, so the [pre, post] window
    holds EXACTLY the measured body's frames — byte-deterministic
    across runs."""
    from ..runtime import spc

    _pingpong(proc, b"", 1)
    if proc.rank == 0:
        _wire_quiesced(skew)
        out["pre"] = {
            k: spc.read(k)
            for k in ("tcp_bytes_sent", "tcp_bytes_recvd",
                      "trace_spans_recorded",
                      "trace_wire_context_bytes")
        }
        out["ready"] = True
        proc.send(b"go", dest=1, tag=3)
    else:
        proc.recv(source=0, tag=3, timeout=30.0)
    sec = _pingpong(proc, payload, iters)
    if proc.rank == 0:
        _wire_quiesced(skew)
        out["post"] = {k: spc.read(k) for k in out["pre"]}
        out["sec"] = sec
    return None


def bench_trace(max_size: int = 1 << 20, iters: int = 20) -> list[dict]:
    """The tracing plane's A/B ladder (``--trace``): every rung runs
    the tcp ping-pong three times — disarmed twice, armed once — and
    gates the zero-overhead-when-off contract in CI terms:

    - the two DISARMED runs' measured-body wire-byte deltas are
      byte-identical (no hidden per-run tracing cost), and their
      ``trace_spans_recorded`` / ``trace_wire_context_bytes`` deltas
      are ZERO;
    - the ARMED run's ``trace_spans_recorded`` rises at every rung and
      its wire bytes exceed the disarmed baseline by exactly the
      context bytes it accounted.

    Latency columns are report-only (a shared host's scheduler noise)."""
    from ..runtime import spc, ztrace

    rows = []
    for nbytes in _sizes(max_size):
        payload = np.zeros(max(1, nbytes // 8), dtype=np.float64)
        deltas = {}
        for mode in ("off-a", "off-b", "armed"):
            out: dict = {}
            # the process is wire-idle here (no pair running yet): the
            # lifetime counters' current imbalance is the quiescence
            # baseline for this mode's run
            skew = spc.read("tcp_bytes_sent") - spc.read(
                "tcp_bytes_recvd")
            if mode == "armed":
                ztrace.arm()
            try:
                _run_tcp_ranks(
                    2, lambda proc, payload=payload, out=out,
                    skew=skew:
                    _trace_probe_body(proc, payload, iters, out, skew),
                    sm=False,
                )
            finally:
                if mode == "armed":
                    ztrace.disarm()
            deltas[mode] = {
                k: out["post"][k] - out["pre"][k] for k in out["pre"]
            }
            deltas[mode]["sec"] = out["sec"]
        off_a, off_b, armed = (deltas["off-a"], deltas["off-b"],
                               deltas["armed"])
        for off in (off_a, off_b):
            if off["trace_spans_recorded"] or \
                    off["trace_wire_context_bytes"]:
                raise RuntimeError(
                    f"trace A/B at {payload.nbytes}B: DISARMED run "
                    f"recorded spans/context bytes ({off}) — the "
                    "zero-overhead-when-off contract is broken"
                )
        if off_a["tcp_bytes_sent"] != off_b["tcp_bytes_sent"] or \
                off_a["tcp_bytes_recvd"] != off_b["tcp_bytes_recvd"]:
            raise RuntimeError(
                f"trace A/B at {payload.nbytes}B: two disarmed runs "
                f"disagree on wire bytes ({off_a} vs {off_b}) — the "
                "measured body is not byte-deterministic"
            )
        if armed["trace_spans_recorded"] <= 0:
            raise RuntimeError(
                f"trace A/B at {payload.nbytes}B: armed run recorded "
                "no spans"
            )
        extra = armed["tcp_bytes_sent"] - off_a["tcp_bytes_sent"]
        if extra != armed["trace_wire_context_bytes"]:
            raise RuntimeError(
                f"trace A/B at {payload.nbytes}B: armed wire-byte "
                f"growth {extra} != accounted context bytes "
                f"{armed['trace_wire_context_bytes']}"
            )
        for mode, d in (("trace_off", off_a), ("trace_on", armed)):
            one_way = d["sec"] / 2
            rows.append({
                "op": f"tcp_pingpong_{mode}",
                "bytes": payload.nbytes,
                "latency_us": one_way * 1e6,
                "bandwidth_MBps": (payload.nbytes / one_way) / 1e6
                if one_way else 0.0,
                "wire_bytes": d["tcp_bytes_sent"],
                "spans": d["trace_spans_recorded"],
                "ctx_bytes": d["trace_wire_context_bytes"],
            })
    return rows


def _overlap_body(proc, payload, iters: int, window: int,
                  blocking: bool):
    """osu-style ishift overlap worker: both ranks post a window of
    irecvs from the peer, issue a window of (i)sends toward it, run
    calibrated compute, then waitall.  Two overlap views come back:

    - ``overlap`` — sender availability: the fraction of the send
      window's completion span during which the caller is FREE to
      compute, ``1 - t_issue / t_send_span`` (no-compute pass).  The
      blocking path measures 0 BY CONSTRUCTION (its sends are born
      complete — issue IS the span), a true isend approaches 1; this
      is the deterministic ratio the CI gate reads, and it holds on
      any core count.
    - ``osu_overlap`` — the OSU nonblocking-benchmark formula
      ``(t_pure + t_compute - t_total) / t_pure`` with compute sized
      to ``t_pure``: the fraction of comm time the hardware actually
      hid under compute.  On a single-CPU affinity mask this is ~0
      for everything (compute and the progress engine serialize on
      the one core — there is nothing to hide INTO); on multi-core
      hosts it converges toward the availability ratio.
    """
    peer = 1 - proc.rank
    mat = np.ones((128, 128))

    def compute(duration):
        # BLAS matmul releases the GIL: the push-pool workers and the
        # peer's drain threads run WHILE this rank computes wherever a
        # core is free to take them
        end = time.perf_counter() + duration
        while time.perf_counter() < end:
            mat @ mat

    def one_iter(compute_s: float) -> tuple[float, float]:
        """Returns (t_issue, t_send_span) of this iteration."""
        rreqs = [proc.irecv(peer, tag=1) for _ in range(window)]
        t0 = time.perf_counter()
        if blocking:
            sreqs = []
            for _ in range(window):
                proc.send(payload, dest=peer, tag=1)
        else:
            sreqs = [proc.isend(payload, dest=peer, tag=1)
                     for _ in range(window)]
        t_issue = time.perf_counter() - t0
        if compute_s:
            compute(compute_s)
        for r in sreqs:
            r.wait(120.0)
        t_span = time.perf_counter() - t0
        for r in rreqs:
            r.wait(120.0)
        return t_issue, t_span

    one_iter(0.0)  # warmup: connections, pools, rings
    proc.barrier()
    issue = span = 0.0
    t0 = time.perf_counter()
    for _ in range(iters):
        i, s = one_iter(0.0)
        issue += i
        span += s
    t_pure = (time.perf_counter() - t0) / iters
    proc.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_iter(t_pure)
    t_total = (time.perf_counter() - t0) / iters
    proc.barrier()
    avail = max(0.0, min(1.0, 1.0 - issue / span)) if span > 0 else 0.0
    osu = max(0.0, min(1.0, (2.0 * t_pure - t_total) / t_pure))
    return t_pure, t_total, avail, osu


def bench_overlap(max_size: int = 4 << 20, iters: int = 20,
                  window: int = 8) -> list[dict]:
    """Compute/communication overlap ladder (``--overlap``): the
    osu-style ishift shape over a real-socket TcpProc pair, nonblocking
    (deferred-contract isend) vs blocking at every size.  CI gates —
    the loud-degradation discipline applied to the nonblocking engine:

    - every nonblocking rung must actually enter the deferred engine
      (``tcp_isend_deferred`` rises);
    - above ``tcp_eager_limit`` the rendezvous isends must park the
      caller's buffers, not a copy (``rndv_park_bytes_avoided`` rises
      and ``tcp_rndv_park_copy_bytes`` stays flat — zero silent
      fallback to the copy-at-park path)."""
    from ..mca import var as mca_var
    from ..runtime import spc

    rows = []
    limit = int(mca_var.get("tcp_eager_limit", 1 << 20))
    for nbytes in _sizes(max_size, min_bytes=1 << 10):
        payload = np.zeros(max(1, nbytes // 8), np.float64)
        d0 = spc.read("tcp_isend_deferred")
        a0 = spc.read("rndv_park_bytes_avoided")
        c0 = spc.read("tcp_rndv_park_copy_bytes")
        nb = _run_tcp_ranks(
            2, lambda p, payload=payload: _overlap_body(
                p, payload, iters, window, blocking=False), sm=False,
        )
        if spc.read("tcp_isend_deferred") == d0:
            raise RuntimeError(
                f"overlap ladder at {payload.nbytes}B: no isend entered "
                "the deferred engine"
            )
        if payload.nbytes > limit:
            if spc.read("rndv_park_bytes_avoided") == a0:
                raise RuntimeError(
                    f"overlap ladder at {payload.nbytes}B: rendezvous "
                    "isends did not avoid the park copy"
                )
            if spc.read("tcp_rndv_park_copy_bytes") != c0:
                raise RuntimeError(
                    f"overlap ladder at {payload.nbytes}B: the isend "
                    "path silently fell back to copy-at-park"
                )
        bl = _run_tcp_ranks(
            2, lambda p, payload=payload: _overlap_body(
                p, payload, iters, window, blocking=True), sm=False,
        )
        (tp_nb, _tt_nb, av_nb, osu_nb) = nb[0]
        (tp_b, _tt_b, av_b, osu_b) = bl[0]
        rows.append({
            "op": "tcp_ishift_overlap", "bytes": payload.nbytes,
            "latency_us": tp_nb * 1e6,
            "bandwidth_MBps": (window * payload.nbytes / tp_nb) / 1e6,
            "overlap": round(av_nb, 3),
            "blocking_overlap": round(av_b, 3),
            "osu_overlap": round(osu_nb, 3),
            "blocking_osu_overlap": round(osu_b, 3),
            "blocking_latency_us": tp_b * 1e6,
        })
    return rows


def bench_sm(max_size: int = 4 << 20, iters: int = 50, bw: bool = False,
             window: int = 16, real_procs: bool = False) -> list[dict]:
    """Shared-memory-plane pt2pt: the same OSU shapes as
    :func:`bench_tcp` with the mmap-ring transport selected, and a
    LOUD-degradation gate — the ladder fails if any send silently fell
    back to TCP (``sm_fallback_tcp_sends`` must not move).

    ``real_procs=True`` runs the two ranks as separate OS processes:
    the cross-process case the ring exists for (thread ranks share one
    GIL and understate the win)."""
    if real_procs:
        return _run_proc_bench({
            "kind": "pt2pt", "max_size": max_size, "iters": iters,
            "bw": bw, "window": window,
        }, nprocs=2)
    return _pt2pt_ladder(max_size, iters, bw, window, sm=True)


# -------------------------------------------- one-sided (osc) plane

# counters every --plane osc rank reports (per-rung deltas); the gates
# read them: direct bytes strictly rising, AM applies and wire bytes
# FLAT on the same-host rungs, zero silent fallbacks
_OSC_COUNTERS = (
    "osc_direct_bytes", "osc_direct_puts", "osc_direct_gets",
    "osc_direct_atomics", "osc_am_fallbacks", "osc_am_applied",
    "tcp_bytes_sent",
)


def _osc_worker_body(proc, spec: dict):
    """--plane osc rank body (thread-mode AND --real-procs): put/get
    ladder plus a fetch-atomic row on an ALLOCATED window (the
    region-backed path).  Every rung records counter deltas and a
    result checksum — the forced-AM reference run (osc_direct=0) must
    produce byte-identical checksums, which is the correctness gate
    that makes the latency rows honest.  Returns (rows [rank 0 only],
    per-rung deltas, checksums)."""
    from ..mca import var as mca_var
    from ..osc.direct import allocate_window
    from ..runtime import spc

    mca_var.set_var("osc_direct", 1 if spec.get("direct", True) else 0)
    label = "direct" if spec.get("direct", True) else "am"
    n, rank = proc.size, proc.rank
    iters = int(spec["iters"])
    max_size = int(spec["max_size"])
    target = (rank + 1) % n
    source = (rank - 1) % n
    win = allocate_window(proc, max_size, np.float64)
    win.fence()
    rows: list[dict] = []
    deltas: list[dict] = []
    sums: list = []
    for nbytes in _sizes(max_size, 64):
        count = nbytes // 8
        data = (np.arange(count, dtype=np.float64) + rank) * 0.5
        base = {c: spc.read(c) for c in _OSC_COUNTERS}
        win.put(data, target, 0)  # warmup
        win.fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            win.put(data, target, 0)
        put_sec = (time.perf_counter() - t0) / iters
        win.fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            got = win.get(target, 0, count)
        get_sec = (time.perf_counter() - t0) / iters
        win.fence()
        # my window holds `source`'s last put; `got` is `target`'s
        csum = (float(np.asarray(win.base[:count]).sum()),
                float(got.sum()))
        deltas.append({c: spc.read(c) - base[c] for c in _OSC_COUNTERS})
        sums.append(csum)
        if rank == 0:
            for op, sec in ((f"osc_{label}_put", put_sec),
                            (f"osc_{label}_get", get_sec)):
                rows.append({
                    "op": op, "bytes": nbytes,
                    "latency_us": sec * 1e6,
                    "bandwidth_MBps": (nbytes / sec) / 1e6,
                })
        proc.barrier()
    # fetch-atomic row: 8-byte fetch-and-op rate through the lock word
    awin = allocate_window(proc, 16, np.int64)
    awin.fence()
    base = {c: spc.read(c) for c in _OSC_COUNTERS}
    t0 = time.perf_counter()
    for _ in range(iters):
        awin.fetch_and_op(1, target=target, offset=0)
    amo_sec = (time.perf_counter() - t0) / iters
    awin.fence()
    mine = int(awin.base[0])
    if mine != iters:  # exactly one origin per target
        raise RuntimeError(
            f"osc {label} ladder: fetch-atomic count {mine} != {iters}"
        )
    deltas.append({c: spc.read(c) - base[c] for c in _OSC_COUNTERS})
    sums.append((float(mine), 0.0))
    if rank == 0:
        rows.append({
            "op": f"osc_{label}_fetch_op", "bytes": 8,
            "latency_us": amo_sec * 1e6,
            "bandwidth_MBps": (8 / amo_sec) / 1e6,
        })
    proc.barrier()
    awin.free()
    win.free()
    return rows, deltas, sums


def _gate_osc_run(label: str, all_deltas: list[list[dict]],
                  exact: bool) -> None:
    """Deterministic gates over every rank's per-rung counter deltas.
    ``exact`` = per-process counter tables (--real-procs); thread-mode
    ranks share one table, so the flat gates stay exact but the rising
    gate is qualitative."""
    for rank, deltas in enumerate(all_deltas):
        prev = -1
        for i, d in enumerate(deltas):
            where = f"rank {rank} rung {i}"
            if label == "direct":
                if d["osc_am_fallbacks"]:
                    raise RuntimeError(
                        f"osc ladder {where}: {d['osc_am_fallbacks']} "
                        "ops silently fell back to the AM path"
                    )
                if d["osc_am_applied"]:
                    raise RuntimeError(
                        f"osc ladder {where}: osc_am_applied moved "
                        f"({d['osc_am_applied']}) on a same-host rung"
                    )
                if d["tcp_bytes_sent"]:
                    raise RuntimeError(
                        f"osc ladder {where}: {d['tcp_bytes_sent']} "
                        "wire bytes moved (one-sided ops must not "
                        "touch the wire between same-host ranks)"
                    )
                if d["osc_direct_bytes"] <= 0:
                    raise RuntimeError(
                        f"osc ladder {where}: no direct bytes moved"
                    )
                is_amo_row = i == len(deltas) - 1
                if exact and not is_amo_row \
                        and d["osc_direct_bytes"] <= prev:
                    raise RuntimeError(
                        f"osc ladder {where}: direct bytes not "
                        f"strictly rising ({d['osc_direct_bytes']} "
                        f"after {prev})"
                    )
                if not is_amo_row:
                    prev = d["osc_direct_bytes"]
            else:  # forced-AM reference: the direct path must be OFF
                if d["osc_direct_bytes"]:
                    raise RuntimeError(
                        f"osc ladder (forced-AM) {where}: direct "
                        "bytes moved with osc_direct=0"
                    )


def bench_osc(max_size: int = 1 << 20, iters: int = 10,
              real_procs: bool = False) -> list[dict]:
    """--plane osc: the direct-map one-sided ladder — put/get latency
    per size plus a fetch-atomic row, run TWICE (direct, then the
    forced-AM reference) with byte-identical-result and counter gates;
    latency is report-only on a shared host, the counters are
    the deterministic claim."""
    from ..mca import var as mca_var

    saved_direct = int(mca_var.get("osc_direct", 1))
    runs: dict[str, tuple] = {}
    for direct in (True, False):
        label = "direct" if direct else "am"
        spec = {"kind": "osc", "max_size": max_size, "iters": iters,
                "direct": direct}
        if real_procs:
            reports = _run_proc_bench(dict(spec), nprocs=2,
                                      collect_all=True)
            rows = reports[0]["rows"]
            all_deltas = [r["deltas"] for r in reports]
            all_sums = [r["sums"] for r in reports]
        else:
            try:
                res = _run_tcp_ranks(
                    2, lambda p, s=spec: _osc_worker_body(p, s),
                    sm=True)
            finally:
                mca_var.set_var("osc_direct", saved_direct)
            rows = res[0][0]
            all_deltas = [r[1] for r in res]
            all_sums = [r[2] for r in res]
        _gate_osc_run(label, all_deltas, exact=real_procs)
        runs[label] = (rows, all_sums)
    # byte-identical gate: same checksums per rank per rung both ways
    if runs["direct"][1] != runs["am"][1]:
        raise RuntimeError(
            "osc ladder: forced-AM reference results differ from the "
            f"direct run (direct {runs['direct'][1]} vs AM "
            f"{runs['am'][1]})"
        )
    return runs["direct"][0] + runs["am"][0]


# -------------------------------------------- real-process harness

# counters every --plane han worker reports (deltas over its run); the
# parent sums them across ranks for the silent-fallback and wire-byte
# gates
_HAN_COUNTERS = (
    "han_flat_fallbacks", "coll_han_inter_bytes", "coll_han_intra_bytes",
    "coll_han_leader_elections", "coll_han_pipelined",
    "tcp_bytes_sent", "sm_bytes_sent",
    "tcp_isend_deferred", "sm_ring_full_spins", "sm_frag_sends",
    "coll_han_numa_collectives", "coll_han_dleader_bytes",
    "han_numa_fallbacks", "sm_rings_materialized",
)


def _han_worker_body(proc, spec: dict) -> tuple[list[dict], dict]:
    """--plane han rank body: allreduce + bcast ladder on the emulated
    mixed topology, result-checked per rung; per-rung seconds are the
    BEST of `trials` timing windows (oversubscribed containers —
    every rank polls, cores are shared — inflate single windows with
    scheduler noise; the sm plane's discipline), MAX-reduced over
    the ranks so the reported latency is the slowest rank's (the OSU
    convention for collectives).  Returns (rows — rank 0 only,
    counter deltas)."""
    from .. import ops
    from ..runtime import spc

    n, rank = proc.size, proc.rank
    iters = int(spec["iters"])
    trials = max(1, int(spec.get("trials", 3)))
    label = spec.get("label") or (
        "flat" if spec["han_mode"] == "off" else "han")
    rows: list[dict] = []
    base = {c: spc.read(c) for c in _HAN_COUNTERS}
    for nbytes in _sizes(int(spec["max_size"]),
                         int(spec.get("min_bytes", 1 << 10))):
        arr = np.full(max(n, nbytes // 8), float(rank + 1))
        expect = float(n * (n + 1) // 2)
        out = proc.allreduce(arr, ops.SUM)  # warmup + correctness
        got = np.asarray(out).reshape(-1)
        if got[0] != expect or got[-1] != expect:
            raise RuntimeError(
                f"{label} ladder: wrong allreduce at {arr.nbytes}B "
                f"(got {got[0]}, want {expect})"
            )
        ar_sec = float("inf")
        for _ in range(trials):
            proc.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                proc.allreduce(arr, ops.SUM)
            ar_sec = min(ar_sec, (time.perf_counter() - t0) / iters)
        payload = arr if rank == 0 else None
        bc = proc.bcast(payload, 0)  # warmup + correctness
        if np.asarray(bc).reshape(-1)[0] != 1.0:
            raise RuntimeError(f"{label} ladder: wrong bcast payload")
        bc_sec = float("inf")
        for _ in range(trials):
            proc.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                proc.bcast(payload, 0)
            bc_sec = min(bc_sec, (time.perf_counter() - t0) / iters)
        for op, sec in (("allreduce", ar_sec), ("bcast", bc_sec)):
            sec = float(np.asarray(
                proc.allreduce(np.float64(sec), ops.MAX)))
            if rank == 0:
                rows.append({
                    "op": f"{label}_host_{op}", "bytes": arr.nbytes,
                    "latency_us": sec * 1e6,
                    "bandwidth_MBps": (arr.nbytes / sec) / 1e6,
                })
        proc.barrier()
    sm_stats = None
    if spec.get("report_sm"):
        # the demand-mapping footprint view of THIS rank's own segment
        # (read before close() — the numa ladder's role-bound gate)
        fn = getattr(proc, "sm_segment_stats", None)
        sm_stats = fn() if fn is not None else None
    return (rows, {c: spc.read(c) - base[c] for c in _HAN_COUNTERS},
            sm_stats)


def _worker_main(spec: dict) -> int:
    """Entry point of a ``--real-procs`` rank (its own interpreter, its
    own GIL): joins the parent-reserved coordinator port, runs the
    requested ladder, and — on rank 0 — emits the rows plus the
    sm-selection counters as one JSON line on stdout.  ``--plane han``
    workers (kind "han") emit one line PER RANK: the parent needs every
    rank's counter deltas (the flat ring's wire hops live on specific
    ranks of the emulated topology)."""
    from ..pt2pt.tcp import TcpProc
    from ..runtime import spc

    rank, n = int(spec["rank"]), int(spec["size"])
    metrics_kw = {}
    if spec.get("via_metrics"):
        # --via-metrics: modex through the parent's resident store and
        # run the rank-side publisher — counters leave via the final
        # flush, not the stdout JSON
        metrics_kw = {"pmix": spec["pmix"], "namespace": spec["ns"],
                      "metrics": True}
    proc = TcpProc(rank, n, coordinator=("127.0.0.1", int(spec["port"])),
                   timeout=120.0, sm=bool(spec.get("sm", True)),
                   sm_boot_id=spec.get("boot"),
                   sm_numa_id=spec.get("numa"), **metrics_kw)
    if spec["kind"] == "han":
        from ..mca import var as mca_var

        mca_var.set_var("coll_han_enable", spec["han_mode"])
        mca_var.set_var("coll_han_pipeline",
                        spec.get("pipeline", "auto"))
        mca_var.set_var("coll_han_numa_level",
                        spec.get("numa_mode", "auto"))
        if spec.get("via_metrics"):
            # the pre-ladder baseline rides the store too, so the
            # parent's delta window matches the in-band one exactly
            from ..runtime.pmix import PmixClient

            ns = spec["ns"]
            cl = PmixClient(spec["pmix"])
            try:
                cl.put(ns, rank, f"metrics_base:{ns}:{rank}",
                       {c: spc.read(c) for c in _HAN_COUNTERS})
                cl.commit(ns, rank)
            finally:
                cl.close()
        try:
            rows, deltas, sm_stats = _han_worker_body(proc, spec)
        finally:
            proc.close()
        print(json.dumps({"rank": rank, "rows": rows,
                          "counters": deltas,
                          "sm_stats": sm_stats}), flush=True)
        return 0
    if spec["kind"] == "alltoall":
        from ..mca import var as mca_var

        mca_var.set_var("coll_han_enable", spec["han_mode"])
        try:
            rows, deltas = _alltoall_worker_body(proc, spec)
        finally:
            proc.close()
        print(json.dumps({"rank": rank, "rows": rows,
                          "counters": deltas}), flush=True)
        return 0
    if spec["kind"] == "osc":
        try:
            rows, odeltas, sums = _osc_worker_body(proc, spec)
        finally:
            proc.close()
        print(json.dumps({"rank": rank, "rows": rows,
                          "deltas": odeltas, "sums": sums}),
              flush=True)
        return 0
    rows = []
    fb0 = spc.read("sm_fallback_tcp_sends")
    try:
        for nbytes in _sizes(int(spec["max_size"]),
                             int(spec.get("min_bytes", 4))):
            if spec["kind"] == "pt2pt":
                payload = np.zeros(max(1, nbytes // 8), np.float64)
                if spec["bw"]:
                    sec = _stream(proc, payload, int(spec["iters"]),
                                  int(spec["window"]))
                else:
                    sec = _pingpong(proc, payload, int(spec["iters"]))
                plane = "sm" if spec.get("sm", True) else "tcp"
                op = f"{plane}_bw" if spec["bw"] else f"{plane}_pingpong"
            else:  # host collective
                from .. import ops

                payload = np.zeros(max(n, nbytes // 8), np.float64)
                proc.allreduce(payload, ops.SUM)  # warmup
                proc.barrier()
                t0 = time.perf_counter()
                for _ in range(int(spec["iters"])):
                    proc.allreduce(payload, ops.SUM)
                sec = (time.perf_counter() - t0) / int(spec["iters"])
                op = "sm_host_allreduce"
            if rank == 0:
                one_way = sec if spec.get("bw") else (
                    sec / 2 if spec["kind"] == "pt2pt" else sec)
                rows.append({
                    "op": op, "bytes": payload.nbytes,
                    "latency_us": one_way * 1e6,
                    "bandwidth_MBps": (payload.nbytes / one_way) / 1e6,
                })
            proc.barrier()
        if rank == 0:
            print(json.dumps({
                "rows": rows,
                "sm_fallback": spc.read("sm_fallback_tcp_sends") - fb0,
                "sm_bytes_sent": spc.read("sm_bytes_sent"),
            }), flush=True)
    finally:
        proc.close()
    return 0


def _run_proc_bench(spec: dict, nprocs: int,
                    rank_overrides: dict | None = None,
                    collect_all: bool = False) -> list:
    """Spawn `nprocs` worker interpreters sharing a fixed coordinator
    port, parse rank 0's JSON report, and enforce the sm-selection
    gate across REAL process boundaries.  The ephemeral port is
    reserved by bind-then-close, so another process can steal it
    before rank 0 re-binds (TOCTOU) — a bind failure retries the whole
    launch on a fresh port.  ``rank_overrides`` merges per-rank spec
    fields (the han ladder's emulated-host boot ids);
    ``collect_all=True`` parses and returns EVERY rank's JSON report
    instead of rank 0's rows."""
    last_exc: Exception | None = None
    for _attempt in range(3):
        try:
            return _run_proc_bench_once(spec, nprocs, rank_overrides,
                                        collect_all)
        except RuntimeError as e:
            if "Address already in use" not in str(e):
                raise
            last_exc = e
    raise last_exc


def _run_proc_bench_once(spec: dict, nprocs: int,
                         rank_overrides: dict | None = None,
                         collect_all: bool = False) -> list:
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = _REPO
    env = _bench_env(repo)
    procs = []
    try:
        for rank in range(nprocs):
            wspec = dict(spec, rank=rank, size=nprocs, port=port)
            wspec.update((rank_overrides or {}).get(rank, {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, "--_worker",
                 json.dumps(wspec)],
                env=env, cwd=repo, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            ))
        # drain every worker CONCURRENTLY: a worker blocked writing a
        # full stderr pipe (verbose streams, a long traceback) stops
        # answering the benchmark and wedges the whole ladder if the
        # parent reads the ranks one at a time
        outs: list = [None] * nprocs
        errs: list = [None] * nprocs

        def drain(rank, p):
            try:
                outs[rank], errs[rank] = p.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                p.kill()
                outs[rank], errs[rank] = p.communicate()
        threads = [threading.Thread(target=drain, args=(r, p), daemon=True)
                   for r, p in enumerate(procs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"sm bench worker rank {rank} failed:\n"
                    f"{errs[rank]}\n{outs[rank]}"
                )
    finally:
        for p in procs:  # no orphan interpreters (nor their segments)
            if p.poll() is None:
                p.kill()
                p.wait()
    if collect_all:
        return [json.loads(out.strip().splitlines()[-1]) for out in outs]
    report = json.loads(outs[0].strip().splitlines()[-1])
    if not spec.get("sm", True):
        return report["rows"]  # tcp baseline run: no selection gate
    if report["sm_fallback"]:
        raise RuntimeError(
            f"sm plane: {report['sm_fallback']} sends silently fell "
            "back to TCP across the real-process ladder"
        )
    if report["sm_bytes_sent"] == 0:
        raise RuntimeError(
            "sm plane: no bytes crossed the rings across real "
            "processes (selection failed?)"
        )
    return report["rows"]


class _ViaMetricsHarness:
    """``--via-metrics``: the han/numa workers' per-rank counter deltas
    are collected THROUGH the metrics plane — each worker modexes via a
    resident in-process zprted store, publishes its pre-ladder baseline
    plus final-flush snapshots (``TcpProc(metrics=True)``), and the
    parent reads them back over the daemon's ``metrics`` RPC — instead
    of the pipe-serialized dicts.  The deterministic gates then run
    UNCHANGED on the store-collected values, and every via-metrics row
    must move ``pmix_puts`` (rows without the flag never touch a
    store, so the counter rises ONLY on metrics-enabled rows)."""

    def __init__(self, nprocs: int):
        from ..runtime import dvm as dvm_mod

        self.nprocs = nprocs
        self.dvm = dvm_mod.Dvm()
        self._row_puts = 0

    def arm(self, spec: dict, label: str) -> dict:
        from ..runtime import spc

        ns = f"bench_{label}"
        self.dvm.store.ensure_ns(ns, self.nprocs)
        self._row_puts = spc.read("pmix_puts")
        return dict(spec, pmix=f"127.0.0.1:{self.dvm.pmix.address[1]}",
                    ns=ns, via_metrics=True)

    def collect(self, label: str, reports: list) -> list:
        """Replace each report's in-band counters with the store-
        collected deltas (final flush minus published baseline), then
        drop the row's namespace (zero stale metrics keys)."""
        from ..runtime import spc
        from ..runtime.dvm import DvmClient

        ns = f"bench_{label}"
        if spc.read("pmix_puts") <= self._row_puts:
            raise RuntimeError(
                f"via-metrics ({label}): pmix_puts did not rise — the "
                "workers never published into the store"
            )
        cli = DvmClient(self.dvm.address)
        try:
            view = cli.metrics(ns)
        finally:
            cli.close()
        bases = {
            int(key.rsplit(":", 1)[1]): dict(value)
            for key, value in
            self.dvm.store.lookup(ns, "metrics_base:").items()
        }
        out = []
        for rep in reports:
            rank = int(rep["rank"])
            rec = view["ranks"].get(rank)
            if rec is None:
                raise RuntimeError(
                    f"via-metrics ({label}): rank {rank} published no "
                    "snapshot (final flush missing?)"
                )
            base = bases.get(rank, {})
            counters = rec.get("counters") or {}
            out.append(dict(rep, counters={
                c: int(counters.get(c, 0)) - int(base.get(c, 0))
                for c in _HAN_COUNTERS
            }))
        self.dvm.store.destroy_ns(ns)
        return out

    def close(self) -> None:
        self.dvm.stop()


def _run_han_threads(spec: dict, nprocs: int, boots: dict,
                     numas: dict | None = None) -> list:
    """Thread-harness variant of the han/numa ladder (one process,
    shared counters): used by the fast CI rows tests; real deployments
    and the slow gates use ``--real-procs``.  Returns one report per
    rank — rank 0 carries the rows and the PROCESS-GLOBAL counter
    deltas (threads share the spc registry), every rank carries its
    own segment's demand-mapping stats."""
    from ..mca import var as mca_var
    from ..runtime import spc

    base = {c: spc.read(c) for c in _HAN_COUNTERS}
    kwargs_by_rank = {r: {"sm_boot_id": b} for r, b in boots.items()}
    for r, numa in (numas or {}).items():
        kwargs_by_rank.setdefault(r, {})["sm_numa_id"] = numa
    mca_var.set_var("coll_han_enable", spec["han_mode"])
    mca_var.set_var("coll_han_pipeline", spec.get("pipeline", "auto"))
    mca_var.set_var("coll_han_numa_level", spec.get("numa_mode", "auto"))
    try:
        res = _run_tcp_ranks(
            nprocs, lambda p: _han_worker_body(p, spec),
            kwargs_by_rank=kwargs_by_rank,
        )
    finally:
        mca_var.unset("coll_han_enable")
        mca_var.unset("coll_han_pipeline")
        mca_var.unset("coll_han_numa_level")
    deltas = {c: spc.read(c) - base[c] for c in _HAN_COUNTERS}
    zeros = {c: 0 for c in _HAN_COUNTERS}
    return [{"rank": r,
             "rows": rows if rows else [],
             "counters": deltas if r == 0 else zeros,
             "sm_stats": stats}
            for r, (rows, _d, stats) in enumerate(res)]


def bench_han(max_size: int = 4 << 20, iters: int = 5, nprocs: int = 4,
              hosts: int = 2, real_procs: bool = True,
              via_metrics: bool = False) -> list[dict]:
    """Hierarchical-collective ladder on an EMULATED mixed topology:
    `nprocs` ranks carved into `hosts` same-boot groups (per-rank
    ``sm_boot_id`` overrides — each emulated host's ranks share real
    mmap rings, cross-host pairs degrade to TCP exactly like a real
    2-host job), measuring flat (``coll_han_enable=off``) vs han
    (``on``) allreduce + bcast at every size.  Gates — the sm plane's
    loud-degradation discipline applied to the decision layer:

    - the han run may not silently fall back to flat
      (``han_flat_fallbacks`` summed over ranks must stay 0 on this
      qualified 2-group topology);
    - the leader phase must actually run (``coll_han_inter_bytes``
      must rise);
    - han's leader-phase payload bytes must stay STRICTLY below the
      flat run's on-wire TCP bytes at equal total payload — the
      fewer-wire-hops claim, byte-accounted rather than timed;
    - the pipeline row (``coll_han_pipeline=on``) must actually take
      the pipelined schedule at >= 2-segment sizes
      (``coll_han_pipelined`` rises) — segment k's intra bcast under
      segment k+1's wire exchange, never a silent sequential run.

    ``via_metrics=True`` (CLI ``--via-metrics``) collects the per-rank
    counter deltas THROUGH the PMIx store (publisher final flush +
    zprted ``metrics`` RPC) instead of the pipe-serialized dicts; the
    gates above run unchanged on the store-collected values."""
    group = max(1, -(-nprocs // hosts))
    boots = {r: f"hanhost{r // group}" for r in range(nprocs)}
    if via_metrics and not real_procs:
        raise RuntimeError("--via-metrics needs real-process workers")
    # a max_size below the ladder floor must still yield one rung, not
    # an empty-rows crash after the workers already ran
    spec_base = {"kind": "han", "max_size": max_size, "iters": iters,
                 "min_bytes": max(1, min(1 << 10, max_size))}
    out_rows: list[dict] = []
    agg: dict[str, dict] = {}
    harness = _ViaMetricsHarness(nprocs) if via_metrics else None
    # three ladders: flat, han with the sequential leader
    # exchange, and han with the pipelined inter/intra overlap
    configs = (
        ("off", "off", "flat"),
        ("on", "off", "han"),
        ("on", "on", "han_pipe"),
    )
    try:
        for han_mode, pipeline, label in configs:
            spec = dict(spec_base, han_mode=han_mode, pipeline=pipeline,
                        label=label)
            if harness is not None:
                spec = harness.arm(spec, label)
            if real_procs:
                reports = _run_proc_bench(
                    spec, nprocs,
                    rank_overrides={r: {"boot": b}
                                    for r, b in boots.items()},
                    collect_all=True,
                )
            else:
                reports = _run_han_threads(spec, nprocs, boots)
            if harness is not None:
                reports = harness.collect(label, reports)
            rows = next(r["rows"] for r in reports if r["rows"])
            agg[label] = {
                c: sum(r["counters"][c] for r in reports)
                for c in _HAN_COUNTERS
            }
            out_rows += rows
    finally:
        if harness is not None:
            harness.close()
    for label in ("han", "han_pipe"):
        if agg[label]["han_flat_fallbacks"]:
            raise RuntimeError(
                f"han plane ({label}): "
                f"{agg[label]['han_flat_fallbacks']} collective(s) "
                "silently fell back to flat on a qualified topology"
            )
        if agg[label]["coll_han_inter_bytes"] == 0:
            raise RuntimeError(
                f"han plane ({label}): no leader-phase bytes moved "
                "(hierarchy never engaged?)"
            )
    if agg["han"]["coll_han_inter_bytes"] >= agg["flat"]["tcp_bytes_sent"]:
        raise RuntimeError(
            f"han plane: leader-phase bytes "
            f"({agg['han']['coll_han_inter_bytes']}) not below the flat "
            f"run's wire bytes ({agg['flat']['tcp_bytes_sent']})"
        )
    from ..mca import var as mca_var

    seg = int(mca_var.get("coll_han_inter_segment", 1 << 20))
    if max_size >= 2 * seg and agg["han_pipe"]["coll_han_pipelined"] == 0:
        raise RuntimeError(
            "han plane: the pipeline ladder crossed >= 2-segment sizes "
            "but no allreduce took the pipelined schedule"
        )
    return out_rows


# counters every --plane alltoall worker reports (deltas over its
# run); the parent sums them for the fallback and wire-byte gates
_ALLTOALL_COUNTERS = _HAN_COUNTERS + (
    "coll_han_alltoall_collectives", "coll_han_alltoall_inter_bytes",
    "coll_han_alltoall_leader_msgs",
)


def _alltoall_worker_body(proc, spec: dict) -> tuple[list[dict], dict]:
    """--plane alltoall rank body: alltoall + alltoallv ladder on the
    emulated topology, result-checked per rung, per-rung seconds the
    BEST of ``trials`` windows MAX-reduced over the ranks (the han
    ladder's timing discipline).  Returns (rows — rank 0 only,
    counter deltas)."""
    from .. import ops
    from ..runtime import spc

    n, rank = proc.size, proc.rank
    iters = int(spec["iters"])
    trials = max(1, int(spec.get("trials", 3)))
    label = spec.get("label") or (
        "flat" if spec["han_mode"] == "off" else "han")
    rows: list[dict] = []
    base = {c: spc.read(c) for c in _ALLTOALL_COUNTERS}
    for nbytes in _sizes(int(spec["max_size"]),
                         int(spec.get("min_bytes", 1 << 10))):
        w = max(1, nbytes // (8 * n))  # per-destination block words
        blocks = [np.full(w, float(rank * 10 + d)) for d in range(n)]
        out = proc.alltoall(blocks)  # warmup + correctness
        for s in range(n):
            got = np.asarray(out[s])
            if got[0] != float(s * 10 + rank) or got.size != w:
                raise RuntimeError(
                    f"{label} ladder: wrong alltoall block from rank "
                    f"{s} at {w * 8}B/dest (got {got[0]})"
                )
        a2a_sec = float("inf")
        for _ in range(trials):
            proc.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                proc.alltoall(blocks)
            a2a_sec = min(a2a_sec, (time.perf_counter() - t0) / iters)
        # alltoallv: rank r ships (d+1)*w words to rank d — the
        # variable blocks ride the same aggregated leader exchange
        counts = [(d + 1) * w for d in range(n)]
        sendbuf = np.concatenate(
            [np.full((d + 1) * w, float(rank * 10 + d))
             for d in range(n)])
        outv = proc.alltoallv(sendbuf, counts)
        for s in range(n):
            got = np.asarray(outv[s])
            if got.size != (rank + 1) * w or got[0] != float(s * 10 + rank):
                raise RuntimeError(
                    f"{label} ladder: wrong alltoallv block from rank "
                    f"{s} (size {got.size}, head {got[0]})"
                )
        v_sec = float("inf")
        for _ in range(trials):
            proc.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                proc.alltoallv(sendbuf, counts)
            v_sec = min(v_sec, (time.perf_counter() - t0) / iters)
        for op, sec, total in (
                ("alltoall", a2a_sec, n * w * 8),
                ("alltoallv", v_sec, sum(counts) * 8)):
            sec = float(np.asarray(
                proc.allreduce(np.float64(sec), ops.MAX)))
            if rank == 0:
                rows.append({
                    "op": f"{label}_host_{op}", "bytes": total,
                    "latency_us": sec * 1e6,
                    "bandwidth_MBps": (total / sec) / 1e6,
                })
        proc.barrier()
    return rows, {c: spc.read(c) - base[c] for c in _ALLTOALL_COUNTERS}


def _run_alltoall_threads(spec: dict, nprocs: int, boots: dict,
                          numas: dict | None = None) -> list:
    """Thread-harness variant of the alltoall ladder (one process,
    shared counters) — the fast CI rows; the slow gates use
    ``--real-procs``."""
    from ..mca import var as mca_var
    from ..runtime import spc

    base = {c: spc.read(c) for c in _ALLTOALL_COUNTERS}
    kwargs_by_rank = {r: {"sm_boot_id": b} for r, b in boots.items()}
    for r, numa in (numas or {}).items():
        kwargs_by_rank.setdefault(r, {})["sm_numa_id"] = numa
    mca_var.set_var("coll_han_enable", spec["han_mode"])
    try:
        res = _run_tcp_ranks(
            nprocs, lambda p: _alltoall_worker_body(p, spec),
            kwargs_by_rank=kwargs_by_rank,
        )
    finally:
        mca_var.unset("coll_han_enable")
    deltas = {c: spc.read(c) - base[c] for c in _ALLTOALL_COUNTERS}
    zeros = {c: 0 for c in _ALLTOALL_COUNTERS}
    return [{"rank": r, "rows": rows if rows else [],
             "counters": deltas if r == 0 else zeros}
            for r, (rows, _d) in enumerate(res)]


def bench_alltoall(max_size: int = 4 << 20, iters: int = 5,
                   nprocs: int = 4, hosts: int = 2,
                   real_procs: bool = True) -> list[dict]:
    """The alltoall-family ladder on the emulated 2-host ×
    2-domain topology: flat pairwise (``coll_han_enable=off``) vs the
    hierarchical three-phase block schedule (``on``) for alltoall AND
    alltoallv at every size.  Gates — the serving plane's
    expert-dispatch acceptance, byte-accounted rather than timed:

    - the han run may not silently fall back to flat
      (``han_flat_fallbacks`` summed over ranks stays 0);
    - the aggregated leader exchange must actually run
      (``coll_han_alltoall_collectives`` and
      ``coll_han_alltoall_inter_bytes`` must rise);
    - the han run's ON-WIRE TCP bytes must stay STRICTLY below the
      flat run's at equal total payload — one aggregated message per
      leader pair against a message per cross-host RANK pair;
    - the aggregated payload itself (``coll_han_alltoall_inter_bytes``)
      must also sit below the flat run's wire bytes."""
    group = max(1, -(-nprocs // hosts))
    boots = {r: f"hanhost{r // group}" for r in range(nprocs)}
    numas = {r: f"d{r % group}" for r in range(nprocs)}
    spec_base = {"kind": "alltoall", "max_size": max_size,
                 "iters": iters,
                 "min_bytes": max(1, min(1 << 10, max_size))}
    out_rows: list[dict] = []
    agg: dict[str, dict] = {}
    for han_mode, label in (("off", "flat"), ("on", "han")):
        spec = dict(spec_base, han_mode=han_mode, label=label)
        if real_procs:
            reports = _run_proc_bench(
                spec, nprocs,
                rank_overrides={r: {"boot": boots[r],
                                    "numa": numas[r]}
                                for r in range(nprocs)},
                collect_all=True,
            )
        else:
            reports = _run_alltoall_threads(spec, nprocs, boots, numas)
        rows = next(r["rows"] for r in reports if r["rows"])
        agg[label] = {c: sum(r["counters"][c] for r in reports)
                      for c in _ALLTOALL_COUNTERS}
        out_rows += rows
    if agg["han"]["han_flat_fallbacks"]:
        raise RuntimeError(
            f"alltoall plane: {agg['han']['han_flat_fallbacks']} "
            "collective(s) silently fell back to flat on a qualified "
            "topology"
        )
    if agg["han"]["coll_han_alltoall_collectives"] == 0 \
            or agg["han"]["coll_han_alltoall_inter_bytes"] == 0:
        raise RuntimeError(
            "alltoall plane: the aggregated leader exchange never "
            "engaged (collectives="
            f"{agg['han']['coll_han_alltoall_collectives']}, "
            f"inter_bytes={agg['han']['coll_han_alltoall_inter_bytes']})"
        )
    if agg["han"]["tcp_bytes_sent"] >= agg["flat"]["tcp_bytes_sent"]:
        raise RuntimeError(
            f"alltoall plane: han wire bytes "
            f"({agg['han']['tcp_bytes_sent']}) not strictly below the "
            f"flat run's ({agg['flat']['tcp_bytes_sent']})"
        )
    if agg["han"]["coll_han_alltoall_inter_bytes"] >= \
            agg["flat"]["tcp_bytes_sent"]:
        raise RuntimeError(
            f"alltoall plane: aggregated payload bytes "
            f"({agg['han']['coll_han_alltoall_inter_bytes']}) not "
            f"below the flat run's wire bytes "
            f"({agg['flat']['tcp_bytes_sent']})"
        )
    return out_rows


def _numa_layout(nprocs: int, hosts: int, domains: int
                 ) -> tuple[dict, dict, dict]:
    """(boots, numas, domains-as-hosts boots) of the emulated
    ``hosts × domains × ranks-per-domain`` topology: real boot ids per
    host + numa tokens per domain for the three-level row, and one
    DISTINCT boot per (host, domain) for the pre-NUMA baseline — the
    only way the two-level world could express domain structure at
    all (every domain leader then pays wire prices)."""
    per_host = max(1, -(-nprocs // hosts))
    per_dom = max(1, -(-per_host // domains))
    boots, numas, domhost_boots = {}, {}, {}
    for r in range(nprocs):
        h, d = r // per_host, (r % per_host) // per_dom
        boots[r] = f"numahost{h}"
        numas[r] = f"d{d}"
        domhost_boots[r] = f"numahost{h}d{d}"
    return boots, numas, domhost_boots


def bench_numa(max_size: int = 1 << 20, iters: int = 3, nprocs: int = 8,
               hosts: int = 2, domains: int = 2, real_procs: bool = True,
               trials: int | None = None,
               via_metrics: bool = False) -> list[dict]:
    """NUMA-level ladder on the emulated ``hosts × domains ×
    ranks-per-domain`` real-process topology (per-rank ``sm_boot_id``
    + ``sm_numa_id`` pins): three-level han (``han3``) against the
    pre-NUMA two-level world's only way to respect domains —
    domains-as-hosts (``han2dom``, one distinct boot per (host,
    domain), every domain leader on the wire) — plus an ungated flat
    reference row.  Sizes start at 256 KiB (the acceptance band).
    Deterministic gates, byte-accounted rather than timed (latency
    rows are best-of-N but a shared host's scheduler noise makes
    them report-only):

    - zero ``han_flat_fallbacks`` AND zero ``han_numa_fallbacks`` on
      both hierarchical rows (no silent degradation);
    - the three-level schedule actually engaged
      (``coll_han_numa_collectives`` > 0) and both exchange phases
      moved bytes (``coll_han_dleader_bytes`` > 0,
      ``coll_han_inter_bytes`` > 0);
    - han3's inter-host wire bytes STRICTLY below han2dom's leader
      bytes at equal payload — the fewer-wire-bytes claim;
    - demand-mapping footprint: every han3 rank's materialized ring
      set stays within its ROLE bound (domain siblings + fellow
      domain leaders for dleaders — never the whole universe) and its
      logical footprint under the pre-carve equivalent
      ``(size-1) × sm_ring_bytes``."""
    from ..mca import var as mca_var

    boots, numas, domhost_boots = _numa_layout(nprocs, hosts, domains)
    if via_metrics and not real_procs:
        raise RuntimeError("--via-metrics needs real-process workers")
    min_bytes = min(256 << 10, max_size)
    spec_base = {"kind": "han", "max_size": max_size, "iters": iters,
                 "min_bytes": min_bytes, "report_sm": True}
    if trials:
        spec_base["trials"] = trials
    configs = (
        ("flat", "off", "off", boots, numas),
        ("han2dom", "on", "off", domhost_boots, {}),
        ("han3", "on", "on", boots, numas),
    )
    out_rows: list[dict] = []
    agg: dict[str, dict] = {}
    stats: dict[str, list] = {}
    harness = _ViaMetricsHarness(nprocs) if via_metrics else None
    try:
        for label, han_mode, numa_mode, blist, nlist in configs:
            spec = dict(spec_base, han_mode=han_mode,
                        numa_mode=numa_mode, pipeline="off", label=label)
            if harness is not None:
                spec = harness.arm(spec, label)
            if real_procs:
                overrides = {r: {"boot": blist[r]}
                             for r in range(nprocs)}
                for r, numa in nlist.items():
                    overrides[r]["numa"] = numa
                reports = _run_proc_bench(spec, nprocs,
                                          rank_overrides=overrides,
                                          collect_all=True)
            else:
                reports = _run_han_threads(spec, nprocs, blist, nlist)
            if harness is not None:
                reports = harness.collect(label, reports)
            out_rows += next(r["rows"] for r in reports if r["rows"])
            agg[label] = {c: sum(r["counters"][c] for r in reports)
                          for c in _HAN_COUNTERS}
            stats[label] = [r.get("sm_stats") for r in reports]
    finally:
        if harness is not None:
            harness.close()
    for label in ("han2dom", "han3"):
        if agg[label]["han_flat_fallbacks"]:
            raise RuntimeError(
                f"numa plane ({label}): "
                f"{agg[label]['han_flat_fallbacks']} collective(s) "
                "silently fell back to flat on a qualified topology"
            )
    if agg["han3"]["han_numa_fallbacks"]:
        raise RuntimeError(
            f"numa plane: {agg['han3']['han_numa_fallbacks']} "
            "collective(s) silently fell back to two-level on a "
            "qualified nested topology"
        )
    if agg["han3"]["coll_han_numa_collectives"] == 0:
        raise RuntimeError(
            "numa plane: the three-level schedule never engaged"
        )
    for counter in ("coll_han_dleader_bytes", "coll_han_inter_bytes"):
        if agg["han3"][counter] == 0:
            raise RuntimeError(
                f"numa plane: no {counter} moved (a nested phase "
                "never ran?)"
            )
    if agg["han3"]["coll_han_inter_bytes"] >= \
            agg["han2dom"]["coll_han_inter_bytes"]:
        raise RuntimeError(
            "numa plane: three-level wire bytes "
            f"({agg['han3']['coll_han_inter_bytes']}) not strictly "
            "below the domains-as-hosts leader bytes "
            f"({agg['han2dom']['coll_han_inter_bytes']})"
        )
    # role-bound footprint gate (the demand-mapping win, bitmap-gated)
    per_host = max(1, -(-nprocs // hosts))
    per_dom = max(1, -(-per_host // domains))
    precarve = (nprocs - 1) * int(mca_var.get("sm_ring_bytes", 4 << 20))
    for rank, st in enumerate(stats["han3"]):
        if st is None:
            raise RuntimeError(
                f"numa plane: rank {rank} reported no segment stats "
                "(sm plane off?)"
            )
        def dom_of(r):
            return r // per_host, (r % per_host) // per_dom

        dom = [r for r in range(nprocs) if dom_of(r) == dom_of(rank)]
        allowed = set(dom)
        if rank == dom[0]:  # domain leader: fellow dleaders of the host
            host_members = [r for r in range(nprocs)
                            if r // per_host == rank // per_host]
            allowed |= {min(r for r in host_members
                            if dom_of(r) == dom_of(m))
                        for m in host_members}
        allowed.discard(rank)
        extra = set(st["materialized"]) - allowed
        if extra:
            raise RuntimeError(
                f"numa plane: rank {rank} materialized rings outside "
                f"its role bound: {sorted(extra)} (allowed "
                f"{sorted(allowed)})"
            )
        if st["footprint_bytes"] >= precarve:
            raise RuntimeError(
                f"numa plane: rank {rank}'s footprint "
                f"({st['footprint_bytes']}B) not below the pre-carve "
                f"equivalent ({precarve}B)"
            )
    return out_rows


def bench_host_coll(opname: str = "allreduce", algorithm: str = "auto",
                    max_size: int = 4 << 20, iters: int = 5,
                    nprocs: int = 4, sm: bool | None = False,
                    real_procs: bool = False) -> list[dict]:
    """Host-plane collective over REAL loopback sockets: `nprocs`
    TcpProc ranks running the coll/host algorithms (ring allreduce,
    pipeline bcast, pairwise alltoall ... the DCN leg of multi-host
    training).  ``algorithm`` pins the host algorithm MCA var where one
    exists; 'ring' for allreduce means crossing host_coll_large_msg so
    the bandwidth-optimal ring path is selected.  ``sm`` pins the
    shared-memory transport per proc (True = the collectives ride the
    mmap rings, with the loud-degradation gate); ``real_procs`` runs
    the allreduce ladder over separate OS processes instead."""
    from .. import ops
    from ..mca import var as mca_var
    from ..runtime import spc

    if real_procs:
        if opname != "allreduce":
            raise ValueError("real-process host plane: allreduce only")
        return _run_proc_bench({
            "kind": "coll", "max_size": max_size, "iters": iters,
            "min_bytes": 1 << 10, "bw": False,
        }, nprocs=nprocs)

    pinned = None
    if algorithm != "auto" and opname in ("bcast", "reduce"):
        pinned = f"host_{opname}_algorithm"
        mca_var.set_var(pinned, algorithm)
    elif algorithm == "ring" and opname == "allreduce":
        # the ring path has no forced-algorithm var; it is selected by
        # size — drop the threshold so EVERY rung actually runs ring
        # and the row's algorithm label is honest
        pinned = "host_coll_large_msg"
        mca_var.set_var(pinned, 1)
    elif algorithm != "auto":
        raise ValueError(
            f"host plane: no algorithm knob for {opname}/{algorithm}"
        )
    try:
        rows = []
        for nbytes in _sizes(max_size, min_bytes=1 << 10):
            arr = np.zeros(max(nprocs, nbytes // 8), dtype=np.float64)

            def prog(p, arr=arr):
                def once():
                    if opname == "allreduce":
                        p.allreduce(arr, ops.SUM)
                    elif opname == "bcast":
                        p.bcast(arr if p.rank == 0 else None, 0)
                    elif opname == "alltoall":
                        blocks = np.array_split(arr, p.size)
                        p.alltoall(list(blocks))
                    else:
                        raise ValueError(f"host plane: unknown {opname}")

                once()  # warmup
                p.barrier()
                t0 = time.perf_counter()
                for _ in range(iters):
                    once()
                return (time.perf_counter() - t0) / iters

            fb0 = spc.read("sm_fallback_tcp_sends")
            sent0 = spc.read("sm_bytes_sent")
            per_rank = _run_tcp_ranks(nprocs, prog, sm=sm)
            if sm:
                if spc.read("sm_fallback_tcp_sends") != fb0:
                    raise RuntimeError(
                        f"sm host plane at {arr.nbytes}B: sends "
                        "silently fell back to TCP"
                    )
                if spc.read("sm_bytes_sent") == sent0:
                    raise RuntimeError(
                        f"sm host plane at {arr.nbytes}B: no ring "
                        "traffic (selection failed?)"
                    )
            sec = max(per_rank)
            rows.append({
                "op": (f"sm_host_{opname}" if sm else f"host_{opname}"),
                "algorithm": algorithm,
                "bytes": arr.nbytes, "latency_us": sec * 1e6,
                "bandwidth_MBps": (arr.nbytes / sec) / 1e6,
            })
        return rows
    finally:
        if pinned:
            mca_var.unset(pinned)


def bench_launch(nprocs: int = 2, reps: int = 5) -> list[dict]:
    """Launch-latency ladder (the runtime-plane win): what one job
    START costs on three rungs —

    - ``cold zmpirun (launcher proc)``: the full per-job price a shell
      user pays today — a fresh launcher interpreter (python -m ...
      import included), its rendezvous coordinator + name server, the
      rank spawns, teardown.
    - ``cold launch() (in-process)``: the embedded-library shape — the
      launcher interpreter is already warm, but every job still builds
      its own rendezvous/name-server infrastructure.
    - ``dvm (resident zprted)``: one RPC into the running VM; the PMIx
      store and daemon outlive the job, so the job pays ONLY its rank
      spawns + the store modex.

    Every rung launches the SAME trivial program (host_init → barrier →
    finalize) with the same rank count; best-of-N and median of N are
    both reported (a shared host's scheduler noise — the
    best-of is the honest point estimate).  Gates, so a silently
    misrouted rung fails instead of lying: every dvm launch must bump
    ``dvm_jobs_launched`` and drive ``pmix_puts``/``pmix_fences`` (the
    store-served modex really ran), and the dvm rows come from the SAME
    daemon (resident across reps by construction)."""
    import io
    import subprocess
    import sys
    import tempfile

    from ..runtime import dvm as dvm_mod
    from ..runtime import spc
    from ..tools import mpirun

    repo = _REPO
    prog = tempfile.NamedTemporaryFile(
        "w", suffix="_launch_probe.py", delete=False)
    prog.write(
        f"import sys\nsys.path.insert(0, {repo!r})\n"
        "import zhpe_ompi_tpu_torch as zmpi\n"
        "p = zmpi.host_init()\np.barrier()\nzmpi.host_finalize()\n"
    )
    prog.close()
    env = _bench_env(repo)
    rows = []

    def record(mode, times):
        rows.append({
            "op": "launch", "mode": mode, "nprocs": nprocs, "reps": reps,
            "best_ms": min(times) * 1e3,
            "median_ms": sorted(times)[len(times) // 2] * 1e3,
        })

    try:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.mpirun",
                 "-n", str(nprocs), "--no-tag-output", prog.name],
                env=env, capture_output=True, text=True, timeout=120,
            )
            times.append(time.perf_counter() - t0)
            assert res.returncode == 0, res.stderr
        record("cold zmpirun (launcher proc)", times)

        times = []
        for _ in range(reps):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            rc = mpirun.launch(nprocs, [prog.name], timeout=120.0,
                               tag_output=False, stdout=out, stderr=err)
            times.append(time.perf_counter() - t0)
            assert rc == 0, err.getvalue()
        record("cold launch() (in-process)", times)

        d = dvm_mod.Dvm()
        try:
            cli = dvm_mod.DvmClient(d.address)
            jobs0 = spc.read("dvm_jobs_launched")
            puts0 = spc.read("pmix_puts")
            fences0 = spc.read("pmix_fences")
            times = []
            for _ in range(reps):
                out, err = io.StringIO(), io.StringIO()
                t0 = time.perf_counter()
                rc = cli.launch(nprocs, [prog.name], timeout=120.0,
                                tag_output=False, stdout=out, stderr=err)
                times.append(time.perf_counter() - t0)
                assert rc == 0, err.getvalue()
            # the gates: every rep really launched into the resident VM
            # and really modexed through the store
            launched = spc.read("dvm_jobs_launched") - jobs0
            assert launched == reps, (launched, reps)
            assert spc.read("pmix_puts") - puts0 >= nprocs * reps
            assert spc.read("pmix_fences") - fences0 >= reps
            record("dvm (resident zprted)", times)
            cli.close()
        finally:
            d.stop()

        # per-tree-depth rungs: the same store-served launch through a
        # DVM tree, 2 ranks per daemon (the smallest shape where a
        # leaf cache can hit — one rank per daemon fetches each key
        # once and caches for nobody).  All three rungs run 2*NDAEMONS
        # ranks so their counters are comparable; the depth-0 rung
        # re-measures at that size for the gate baseline.
        from ..runtime import dvmtree

        ndaemons = 3
        tprocs = 2 * ndaemons
        gets_per_depth: dict[int, int] = {}
        for depth, fanout in ((0, None), (1, 2), (2, 1)):
            tree = dvmtree.spawn_tree(1 if depth == 0 else ndaemons,
                                      fanout=fanout, in_process=True)
            try:
                cli = dvm_mod.DvmClient(tree.root_address)
                hits0 = spc.read("dvm_store_cache_hits")
                gets0 = spc.read("pmix_gets")
                times = []
                for _ in range(reps):
                    out, err = io.StringIO(), io.StringIO()
                    t0 = time.perf_counter()
                    rc = cli.launch(tprocs, [prog.name], timeout=120.0,
                                    tag_output=False, stdout=out,
                                    stderr=err)
                    times.append(time.perf_counter() - t0)
                    assert rc == 0, err.getvalue()
                hits = spc.read("dvm_store_cache_hits") - hits0
                gets = spc.read("pmix_gets") - gets0
                gets_per_depth[depth] = gets
                if depth == 0:
                    assert hits == 0, hits  # no tree, no leaf cache
                else:
                    # the routing gates: leaf-served gets appear at
                    # every depth >= 1 (2 ranks/daemon -> the second
                    # rank's fetches hit its daemon's cache) while the
                    # ROOT store's get traffic drops below the
                    # depth-0 every-rank-dials-the-root shape
                    assert hits >= tprocs * reps, (depth, hits)
                    assert gets < gets_per_depth[0], \
                        (depth, gets, gets_per_depth[0])
                rows.append({
                    "op": "launch",
                    "mode": (f"dvm tree depth={depth} "
                             f"({1 if depth == 0 else ndaemons} "
                             f"daemons, {tprocs} ranks)"),
                    "nprocs": tprocs, "reps": reps,
                    "best_ms": min(times) * 1e3,
                    "median_ms": sorted(times)[len(times) // 2] * 1e3,
                    "cache_hits": hits, "root_gets": gets,
                })
                cli.close()
            finally:
                tree.stop()
    finally:
        try:
            os.unlink(prog.name)
        except OSError:
            pass
    return rows


def _print_launch_table(rows: list[dict]) -> None:
    print(f"# launch latency ({rows[0]['nprocs']} ranks, "
          f"best/median of {rows[0]['reps']})")
    print(f"{'Mode':<44} {'Best (ms)':>12} {'Median (ms)':>12}"
          f" {'hits':>7} {'gets':>7}")
    for r in rows:
        extra = ""
        if "cache_hits" in r:
            extra = f" {r['cache_hits']:>7d} {r['root_gets']:>7d}"
        print(f"{r['mode']:<44} {r['best_ms']:>12.1f} "
              f"{r['median_ms']:>12.1f}{extra}")


def bench_resize(reps: int = 3) -> list[dict]:
    """Elastic grow/shrink round-trip ladder against a resident
    daemon: one ft job launched 2-live-of-4, then ``reps`` grow(4) /
    shrink(2) round trips while the job's allreduce loop runs.  The
    RTT is the RESIZE RPC's — grow returns once every new rank's spawn
    is confirmed, shrink once every retiree exited (orderly BYE).

    REPORT-ONLY timing on a shared host (spawn latency is
    dominated by interpreter start and scheduler contention; see
    BENCH notes) — the gates are structural: every round trip bumps
    ``dvm_resizes`` twice and the events carry exactly the grown /
    retired membership."""
    import io
    import tempfile

    from ..runtime import dvm as dvm_mod
    from ..runtime import spc

    repo = _REPO
    prog = tempfile.NamedTemporaryFile(
        "w", suffix="_resize_probe.py", delete=False)
    prog.write(
        f"import sys\nsys.path.insert(0, {repo!r})\n"
        "import os, time\n"
        "import numpy as np\n"
        "import zhpe_ompi_tpu_torch as zmpi\n"
        "from zhpe_ompi_tpu_torch import ops\n"
        "from zhpe_ompi_tpu_torch.ft import recovery\n"
        "ep = zmpi.host_init()\n"
        "ses = recovery.ElasticSession(ep)\n"
        "print('resize-probe-ready', flush=True)\n"
        "stop_after = int(os.environ['BENCH_RESIZE_EVENTS'])\n"
        "seen = 0\n"
        "deadline = time.monotonic() + 300.0\n"
        "while True:\n"
        "    stop = 1.0 if (seen >= stop_after\n"
        "                   or time.monotonic() > deadline) else 0.0\n"
        "    out = ses.live.allreduce(np.array([1.0, stop]), ops.SUM)\n"
        "    assert np.isclose(out[0], ses.live.size), out\n"
        "    if out[1] > 0:\n"
        "        break\n"
        "    act = ses.step()\n"
        "    if act in ('retire', 'halt'):\n"
        "        break\n"
        "    if act == 'resized':\n"
        "        seen += 1\n"
        "ses.close()\n"
        "zmpi.host_finalize()\n"
    )
    prog.close()
    os.environ["BENCH_RESIZE_EVENTS"] = str(2 * reps)
    rows = []
    d = dvm_mod.Dvm()
    try:
        cli = dvm_mod.DvmClient(d.address)
        out, err = io.StringIO(), io.StringIO()
        done = {}

        def run():
            done["rc"] = cli.launch(
                2, [prog.name], ft=True, max_size=4, timeout=600.0,
                mca=[("ft_detector_period", "2.0"),
                     ("ft_detector_timeout", "60.0")],
                stdout=out, stderr=err)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        ctl = dvm_mod.DvmClient(d.address)
        deadline = time.monotonic() + 60.0
        while not ctl.stat()["jobs"]:
            assert time.monotonic() < deadline, err.getvalue()
            time.sleep(0.05)
        job_id = next(iter(ctl.stat()["jobs"]))
        # the first grow waits until both launch ranks have built their
        # sessions.  This steps round an open fault of ft/recovery that
        # the namesake shares (ROADMAP C15): a grow that lands before
        # the launch sessions exist meets their constructor agreement,
        # whose failed set still holds the grown ranks, and the job dies
        # ("rank 2 is not a survivor of the shrink")
        while out.getvalue().count("resize-probe-ready") < 2:
            assert time.monotonic() < deadline, err.getvalue()
            time.sleep(0.05)
        r0 = spc.read("dvm_resizes")
        grow_times, shrink_times = [], []
        for _ in range(reps):
            for new_n, await_live, times in ((4, 2, grow_times),
                                             (2, 4, shrink_times)):
                deadline = time.monotonic() + 120.0
                while ctl.stat()["jobs"][job_id]["live"] != await_live:
                    assert time.monotonic() < deadline, \
                        (ctl.stat(), out.getvalue(), err.getvalue())
                    time.sleep(0.05)
                t0 = time.perf_counter()
                evt = ctl.resize(job_id, new_n, timeout=120.0)
                times.append(time.perf_counter() - t0)
                # structural gate: exactly the expected membership
                # moved
                moved = evt["grown"] if new_n == 4 else evt["retired"]
                assert moved == [2, 3], evt
        assert spc.read("dvm_resizes") - r0 == 2 * reps
        t.join(timeout=120.0)
        assert not t.is_alive() and done.get("rc") == 0, \
            (done, out.getvalue(), err.getvalue())
        ctl.close()
        cli.close()
        for mode, times in (("grow 2->4 (spawn-confirmed RTT)",
                             grow_times),
                            ("shrink 4->2 (retire-confirmed RTT)",
                             shrink_times)):
            rows.append({
                "op": "resize", "mode": mode, "nprocs": 4,
                "reps": reps,
                "best_ms": min(times) * 1e3,
                "median_ms": sorted(times)[len(times) // 2] * 1e3,
            })
    finally:
        d.stop()
        os.environ.pop("BENCH_RESIZE_EVENTS", None)
        try:
            os.unlink(prog.name)
        except OSError:
            pass
    return rows


def _print_resize_table(rows: list[dict]) -> None:
    print(f"# elastic resize RTT (2-live-of-4 ft job, best/median of "
          f"{rows[0]['reps']}; report-only)")
    print(f"{'Round trip':<40} {'Best (ms)':>12} {'Median (ms)':>12}")
    for r in rows:
        print(f"{r['mode']:<40} {r['best_ms']:>12.1f} "
              f"{r['median_ms']:>12.1f}")


def bench_scale(ns: tuple = (8, 32, 128), reps: int = 3,
                launch_ranks: int = 8) -> list[dict]:
    """Scale-out fabric ladder (the 512-rank-universe win): wire-up and
    per-death flood cost vs universe size on the thread plane, plus the
    launch RTT vs tree depth on a resident DVM.

    Latency columns are report-only (scheduler noise); the GATES
    are the deterministic counters —

    - ``tcp_lazy_connects`` per wire-up stays ≪ n² (the eager all-pairs
      shape the lazy connect ladder replaced), and per-rank live
      sockets/channels fit ``2·log2(n)+4`` with the same constants at
      every n;
    - flood frames per death (``ft_overlay_hops``) stay under
      ``2·log2(n)+2`` per surviving rank — the log-degree overlay, not
      an all-pairs fallback — and kill → universe-wide classification
      beats 2 s via the transport reset;
    - the ROOT store's get traffic is FLAT vs tree depth: a deeper tree
      serves the same job from leaf caches
      (``dvm_store_cache_hits``) without multiplying root gets, and
      remote ranks spawn via tree frames
      (``dvm_tree_routed_launches``)."""
    import io
    import math
    import tempfile

    from .. import ops
    from ..core import errhandler as errh
    from ..core import errors
    from ..ft import ulfm
    from ..pt2pt.tcp import TcpProc
    from ..runtime import dvm as dvm_mod
    from ..runtime import dvmtree
    from ..runtime import spc

    rows: list[dict] = []

    def universe(n, fn, ft=False):
        coord_ready = threading.Event()
        coord_addr = [None]
        results = [None] * n
        procs = [None] * n
        excs = [None] * n
        sync = threading.Barrier(n)

        def publish(addr):
            coord_addr[0] = addr
            coord_ready.set()

        def main(rank):
            p = None
            try:
                if rank == 0:
                    p = TcpProc(0, n, coordinator=("127.0.0.1", 0),
                                on_coordinator_bound=publish, sm=False,
                                ft=ft)
                else:
                    coord_ready.wait(30)
                    p = TcpProc(rank, n, coordinator=coord_addr[0],
                                sm=False, ft=ft)
                procs[rank] = p
                results[rank] = fn(p, sync)
            except BaseException as e:  # noqa: BLE001
                excs[rank] = e
                coord_ready.set()
                try:
                    sync.abort()
                except Exception:  # noqa: BLE001 - already broken
                    pass
            finally:
                if p is not None and not p._ft_dead:
                    p.close()

        threads = [threading.Thread(target=main, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
            assert not t.is_alive(), "scale bench rank hung"
        for p in procs:
            if p is not None and p._ft_dead:
                p.close()
        for e in excs:
            if e is not None:
                raise e
        return results

    # -- rung 1: wire-up ladder (lazy connects + per-rank resources) --
    for n in ns:
        lazy0 = spc.read("tcp_lazy_connects")
        t0 = time.perf_counter()

        def wire_prog(p, sync):
            p.barrier()
            p.allreduce(np.float64(p.rank), ops.SUM)
            sync.wait(60)
            stats = p.resource_stats()
            sync.wait(60)
            return stats

        stats = universe(n, wire_prog)
        wire_s = time.perf_counter() - t0
        lazy = spc.read("tcp_lazy_connects") - lazy0
        max_socks = max(s["sockets"] for s in stats)
        max_chans = max(s["channels"] for s in stats)
        bound = 2 * math.log2(n) + 4
        assert max_socks <= bound and max_chans <= bound, \
            (n, max_socks, max_chans)
        if n >= 32:
            assert lazy < n * n // 4, (n, lazy)
        rows.append({
            "op": "scale-wireup", "n": n, "wireup_ms": wire_s * 1e3,
            "lazy_connects": lazy, "max_sockets": max_socks,
            "max_channels": max_chans,
        })

    # -- rung 2: flood frames + classification latency per death -----
    from ..mca import var as mca_var

    saved = {v.name: (v._value, v._source)
             for v in mca_var.registry.all_vars()}
    mca_var.set_var("ft_detector_period", 2.0)
    mca_var.set_var("ft_detector_timeout", 60.0)
    try:
        for n in ns:
            victim = n - 1
            hops0 = [None]
            t_sever = [None]
            hops_delta = [None]
            survivors = threading.Barrier(n - 1)

            def flood_prog(p, sync, n=n, victim=victim, hops0=hops0,
                           t_sever=t_sever, hops_delta=hops_delta,
                           survivors=survivors):
                p.set_errhandler(errh.ERRORS_RETURN)
                if p.rank == 0:
                    p.send(b"warm", dest=victim, tag=1)
                    p.recv(source=victim, tag=2, timeout=30.0)
                elif p.rank == victim:
                    p.recv(source=0, tag=1, timeout=30.0)
                    p.send(b"ack", dest=0, tag=2)
                sync.wait(90)
                if p.rank == victim:
                    ulfm.expect_failure(p.ft_state, victim)
                    hops0[0] = spc.read("ft_overlay_hops")
                    t_sever[0] = time.monotonic()
                    p.sever()
                    return None
                if p.rank == 0:
                    time.sleep(0.05)
                    try:
                        p.send(b"poke", dest=victim, tag=3)
                    except errors.ProcFailed:
                        pass
                assert p.ft_state.wait_failed(victim, timeout=10.0)
                elapsed = time.monotonic() - t_sever[0]
                p.failure_ack()
                survivors.wait(60)
                if p.rank == 0:
                    time.sleep(0.2)
                    hops_delta[0] = \
                        spc.read("ft_overlay_hops") - hops0[0]
                survivors.wait(60)
                return elapsed

            res = universe(n, flood_prog, ft=True)
            per_rank = hops_delta[0] / (n - 1)
            classify_s = max(r for r in res if r is not None)
            assert per_rank <= 2 * math.log2(n) + 2, (n, per_rank)
            assert classify_s < 2.0, (n, classify_s)
            rows.append({
                "op": "scale-flood", "n": n,
                "flood_frames": hops_delta[0],
                "frames_per_rank": per_rank,
                "classify_ms": classify_s * 1e3,
            })
            ulfm.clear_expected_failures()
    finally:
        for v in mca_var.registry.all_vars():
            if v.name in saved:
                v._value, v._source = saved[v.name]

    # -- rung 3: launch RTT vs tree depth (root gets must stay flat) --
    if not launch_ranks:  # the thread-plane-only fast gate shape
        return rows
    repo = _REPO
    prog = tempfile.NamedTemporaryFile(
        "w", suffix="_scale_probe.py", delete=False)
    prog.write(
        f"import sys\nsys.path.insert(0, {repo!r})\n"
        "import zhpe_ompi_tpu_torch as zmpi\n"
        "p = zmpi.host_init()\np.barrier()\nzmpi.host_finalize()\n"
    )
    prog.close()
    try:
        gets_by_depth: dict[int, int] = {}
        for depth, ndaemons, fanout in ((0, 1, None), (1, 3, 2),
                                        (3, 4, 1)):
            tree = dvmtree.spawn_tree(ndaemons, fanout=fanout,
                                      in_process=True)
            try:
                cli = dvm_mod.DvmClient(tree.root_address)
                gets0 = spc.read("pmix_gets")
                hits0 = spc.read("dvm_store_cache_hits")
                routed0 = spc.read("dvm_tree_routed_launches")
                times = []
                for _ in range(reps):
                    out, err = io.StringIO(), io.StringIO()
                    t0 = time.perf_counter()
                    rc = cli.launch(launch_ranks, [prog.name],
                                    timeout=180.0, tag_output=False,
                                    stdout=out, stderr=err)
                    times.append(time.perf_counter() - t0)
                    assert rc == 0, err.getvalue()
                gets = spc.read("pmix_gets") - gets0
                hits = spc.read("dvm_store_cache_hits") - hits0
                routed = spc.read("dvm_tree_routed_launches") - routed0
                gets_by_depth[depth] = gets
                if depth > 0:
                    # the flat-vs-depth gates: leaf caches serve the
                    # deeper tree's modex without multiplying root
                    # gets, and remote ranks spawn via tree frames
                    assert hits > 0, (depth, hits)
                    assert routed > 0, (depth, routed)
                    assert gets < gets_by_depth[0], \
                        (depth, gets, gets_by_depth[0])
                if depth == 3:
                    assert gets <= gets_by_depth[1] * 3 // 2, \
                        (gets, gets_by_depth[1])
                rows.append({
                    "op": "scale-launch", "depth": depth,
                    "ndaemons": ndaemons, "nprocs": launch_ranks,
                    "reps": reps, "best_ms": min(times) * 1e3,
                    "median_ms": sorted(times)[len(times) // 2] * 1e3,
                    "root_gets": gets, "cache_hits": hits,
                    "routed_launches": routed,
                })
                cli.close()
            finally:
                tree.stop()
    finally:
        try:
            os.unlink(prog.name)
        except OSError:
            pass
    return rows


def _print_scale_table(rows: list[dict]) -> None:
    print("# scale-out fabric ladder (latency report-only; "
          "counter gates enforced)")
    wire = [r for r in rows if r["op"] == "scale-wireup"]
    if wire:
        print(f"{'n':>6} {'Wire-up (ms)':>14} {'lazy dials':>11} "
              f"{'max socks':>10} {'max chans':>10}")
        for r in wire:
            print(f"{r['n']:>6} {r['wireup_ms']:>14.1f} "
                  f"{r['lazy_connects']:>11d} {r['max_sockets']:>10d} "
                  f"{r['max_channels']:>10d}")
    flood = [r for r in rows if r["op"] == "scale-flood"]
    if flood:
        print(f"{'n':>6} {'Classify (ms)':>14} {'flood frames':>13} "
              f"{'per rank':>9}")
        for r in flood:
            print(f"{r['n']:>6} {r['classify_ms']:>14.1f} "
                  f"{r['flood_frames']:>13d} "
                  f"{r['frames_per_rank']:>9.1f}")
    launch = [r for r in rows if r["op"] == "scale-launch"]
    if launch:
        print(f"{'depth':>6} {'Best (ms)':>12} {'Median (ms)':>12} "
              f"{'root gets':>10} {'hits':>7} {'routed':>7}")
        for r in launch:
            print(f"{r['depth']:>6} {r['best_ms']:>12.1f} "
                  f"{r['median_ms']:>12.1f} {r['root_gets']:>10d} "
                  f"{r['cache_hits']:>7d} {r['routed_launches']:>7d}")


def _print_table(rows: list[dict]) -> None:
    if not rows:
        return
    print(f"# {rows[0]['op']}"
          + (f" [{rows[0]['algorithm']}]" if "algorithm" in rows[0] else ""))
    overlap = "overlap" in rows[0]
    print(f"{'Size (B)':>12} {'Latency (us)':>16} {'BW (MB/s)':>14}"
          + (f" {'Overlap':>8} {'Blocking':>9}" if overlap else ""))
    for r in rows:
        if r.get("op") == "device_probe":
            # the trailing probe row (gates already enforced): its
            # latency is report-only and has no bytes axis
            print(f"# device_probe rounds={r['rounds']} "
                  f"misses={r['misses']} "
                  f"device_faults={r['device_faults']} "
                  f"latency={r['probe_latency_ms']:.0f}ms (report-only)")
            continue
        line = (f"{r['bytes']:>12} {r['latency_us']:>16.2f} "
                f"{r['bandwidth_MBps']:>14.1f}")
        if overlap:
            line += (f" {r['overlap']:>8.2f}"
                     f" {r['blocking_overlap']:>9.2f}")
        print(line)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--op", default="allreduce",
                   help="allreduce|bcast|allgather|alltoall|reduce|"
                        "reduce_scatter|pt2pt|tcp|all")
    p.add_argument("--algorithm", default="auto",
                   help="tuned forced algorithm name, or 'auto'")
    p.add_argument("--max-size", type=int, default=1 << 20)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.add_argument("--bw", action="store_true",
                   help="pt2pt/tcp: multi-frame in-flight bandwidth "
                        "(osu_bw shape) instead of ping-pong latency")
    p.add_argument("--overlap", action="store_true",
                   help="compute/communication overlap ladder (osu-style "
                        "ishift: compute under outstanding isends), "
                        "nonblocking vs blocking, gated on the deferred-"
                        "engine counters")
    p.add_argument("--window", type=int, default=16,
                   help="frames in flight per ack in --bw mode")
    p.add_argument("--plane", default="device",
                   choices=("device", "host", "sm", "han", "numa",
                            "osc", "alltoall"),
                   help="collectives: device = Communicator over "
                        "coll/tuned -> coll/nccl (default; gloo with "
                        "--device cpu); "
                        "host = coll/host over real loopback sockets; "
                        "sm = same, with the shared-memory rings "
                        "selected (pt2pt/tcp ops too) and silent TCP "
                        "fallback failing the run; han = real-process "
                        "flat-vs-hierarchical ladder on an emulated "
                        "--hosts-way mixed topology, silent flat "
                        "fallback failing the run; numa = three-level "
                        "vs domains-as-hosts two-level ladder on the "
                        "emulated --hosts x --domains topology, "
                        "counter- and footprint-gated; osc = the "
                        "direct-map one-sided ladder (put/get/fetch-"
                        "atomic on sm-region windows vs the forced-AM "
                        "reference, byte-identical + counter-gated; "
                        "--real-procs for per-process counter tables); "
                        "alltoall = flat-vs-hierarchical alltoall/"
                        "alltoallv ladder on the emulated topology, "
                        "han wire bytes gated strictly below flat")
    p.add_argument("--nprocs", type=int, default=4,
                   help="socket ranks for --plane host/sm/han/numa "
                        "collectives (numa defaults to hosts*domains*2)")
    p.add_argument("--hosts", type=int, default=2,
                   help="--plane han/numa: emulated same-boot host "
                        "groups")
    p.add_argument("--domains", type=int, default=2,
                   help="--plane numa: emulated NUMA domains per host")
    p.add_argument("--real-procs", action="store_true",
                   help="--plane sm: ranks as separate OS processes "
                        "(the cross-process case; threads share a GIL)")
    p.add_argument("--launch", action="store_true",
                   help="launch-latency ladder: cold zmpirun (launcher "
                        "proc / in-process) vs a resident zprted DVM, "
                        "plus per-tree-depth rungs (0/1/2; leaf-cache "
                        "hits must rise at depth >= 1 while the root "
                        "store's gets drop), counter-gated (runtime "
                        "plane)")
    p.add_argument("--scale", action="store_true",
                   help="scale-out fabric ladder: wire-up + per-death "
                        "flood cost vs universe size (thread plane, "
                        "n in {8,32,128}) and launch RTT vs tree "
                        "depth — latency report-only, counter-gated "
                        "(lazy dials ≪ n², flood frames per death "
                        "O(log n), root store gets flat vs depth)")
    p.add_argument("--resize", action="store_true",
                   help="elastic resize ladder: grow/shrink round-trip "
                        "latency against a resident daemon (report-"
                        "only timing; membership and "
                        "dvm_resizes counter gates)")
    p.add_argument("--lockdep", action="store_true",
                   help="run WITH the lock-order witness instrumented "
                        "(diagnosis only: numbers are not comparable "
                        "to the default raw-lock rows)")
    p.add_argument("--trace", action="store_true",
                   help="tracing-plane A/B ladder: armed vs disarmed "
                        "tcp ping-pong, gated — disarmed runs are "
                        "byte-identical on the wire with zero spans "
                        "(zero-overhead-when-off), armed runs record "
                        "spans at every rung and grow the wire by "
                        "exactly the accounted context bytes")
    p.add_argument("--via-metrics", action="store_true",
                   help="--plane han/numa: collect the workers' "
                        "per-rank counter deltas through the PMIx "
                        "store (metrics publisher + zprted metrics "
                        "RPC) instead of pipe-serialized dicts; gates "
                        "run unchanged on the store-collected values")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device-plane collectives and probe: cuda (NCCL, "
                        "default) or cpu (gloo)")
    p.add_argument("--_worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args._worker is not None:
        return _worker_main(json.loads(args._worker))
    # lockdep-off is the bench default: measured paths run raw
    # threading primitives.  An inherited ZMPI_LOCKDEP=1 (e.g. the test
    # suite's) is stripped from worker envs and disabled in-process
    # unless --lockdep explicitly opts in.
    if args.lockdep:
        _keep_lockdep[0] = True
        lockdep.enable()
    elif lockdep.enabled():
        print("# lockdep witness inherited from the environment: "
              "DISABLED for the bench (pass --lockdep to keep it)")
        lockdep.disable()
    if args.launch:
        rows = bench_launch(nprocs=min(args.nprocs, 4),
                            reps=max(args.iters, 3))
        if args.json:
            for r in rows:
                print(json.dumps(r))
        else:
            _print_launch_table(rows)
        return 0
    if args.scale:
        rows = bench_scale(reps=max(min(args.iters, 5), 3))
        if args.json:
            for r in rows:
                print(json.dumps(r))
        else:
            _print_scale_table(rows)
        return 0
    if args.resize:
        rows = bench_resize(reps=max(min(args.iters, 5), 3))
        if args.json:
            for r in rows:
                print(json.dumps(r))
        else:
            _print_resize_table(rows)
        return 0
    if args.trace:
        rows = bench_trace(args.max_size, max(args.iters, 10))
    elif args.overlap:
        rows = bench_overlap(args.max_size, max(args.iters, 10),
                             window=min(args.window, 16))
    elif args.op == "pt2pt":
        rows = bench_pt2pt(args.max_size, max(args.iters, 10),
                           bw=args.bw, window=args.window)
    elif args.plane == "han":
        rows = bench_han(args.max_size, max(args.iters, 3),
                         nprocs=args.nprocs, hosts=args.hosts,
                         via_metrics=args.via_metrics)
    elif args.plane == "osc":
        rows = bench_osc(args.max_size, max(args.iters, 5),
                         real_procs=args.real_procs)
    elif args.plane == "alltoall":
        rows = bench_alltoall(args.max_size, max(args.iters, 3),
                              nprocs=args.nprocs, hosts=args.hosts,
                              real_procs=args.real_procs)
    elif args.plane == "numa":
        nprocs = args.nprocs if args.nprocs != 4 \
            else args.hosts * args.domains * 2
        rows = bench_numa(args.max_size, max(args.iters, 2),
                          nprocs=nprocs, hosts=args.hosts,
                          domains=args.domains,
                          via_metrics=args.via_metrics)
    elif args.op == "tcp" and args.plane == "sm":
        rows = bench_sm(args.max_size, max(args.iters, 10),
                        bw=args.bw, window=args.window,
                        real_procs=args.real_procs)
    elif args.op == "tcp":
        rows = bench_tcp(args.max_size, max(args.iters, 10),
                         bw=args.bw, window=args.window)
    elif args.op == "all":
        rows = []
        for op in ("allreduce", "bcast", "allgather", "alltoall"):
            rows += bench_collective(op, "auto", args.max_size, args.iters,
                                     device=args.device)
        rows += bench_pt2pt(args.max_size, max(args.iters, 10))
        rows += bench_tcp(args.max_size, max(args.iters, 10))
        rows += bench_sm(args.max_size, max(args.iters, 10))
    elif args.plane in ("host", "sm"):
        rows = bench_host_coll(
            args.op, args.algorithm, args.max_size, args.iters,
            nprocs=args.nprocs, sm=(args.plane == "sm"),
            real_procs=args.real_procs and args.plane == "sm",
        )
    else:
        rows = bench_collective(
            args.op, args.algorithm, args.max_size, args.iters,
            device=args.device,
        )
        # the device plane carries the fault loop: every default-plane
        # ladder ends with the probe row (rounds > 0, zero
        # classifications — see bench_device_probe's gates)
        rows += bench_device_probe(rounds=max(1, min(args.iters, 3)),
                                   device=args.device)

    if args.json:
        for r in rows:
            print(json.dumps(r))
    else:
        _print_table(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
