"""ztune — the self-tuning sweep harness of the collective decision plane
(namesake: ``zhpe_ompi_tpu/tools/ztune.py``).

The reference's coll/tuned earns its name by shipping decision tables
distilled from OSU benchmark sweeps; this tool closes that loop for the
analog.  It runs the collective cells on the port's OSU harness,
``zhpe_ompi_tpu_torch/benchmarks/osu_zmpi.py`` (every ladder of its
namesake ``benchmarks/osu_zmpi.py``: its thread harness, worker
environment and size ladder), per emulated topology shape
(flat / han2 / han3 — real processes with
``--real-procs``, the in-process thread harness by default), per op ×
per size × candidate algorithm, and distills the winners into a
sectioned dynamic-rules table (``coll/ztable.py`` format) keyed on
``(n_hosts, n_domains, ranks_per_domain)``.  ``--publish host:port``
pushes the table into a DVM's PMIx store under the well-known ztune key
(``runtime/pmix.py``), so every subsequent job launched on that DVM
resolves the tuned table for ITS topology at init with zero re-sweeping.

Selection is **counter-gated, not latency-gated**: the 1-CPU container
carries ±20% scheduler noise, so a candidate wins on its deterministic
wire deltas (``tcp_bytes_sent`` + ``sm_bytes_sent``, with the han phase
counters alongside) and the measured latency rides the emitted table as
report-only comment rows.  The distiller's regression gate enforces that
a table may NEVER pick an algorithm whose counter-gated wire bytes
exceed the stock auto decision's for that ``(op, comm_size, nbytes)``
cell — a planted worse-than-default winner moves
``tuned_regression_rejects``, never the table.

Verbs::

    python -m zhpe_ompi_tpu_torch.tools.ztune --out tuned.table
    python -m zhpe_ompi_tpu_torch.tools.ztune --out tuned.table --publish 127.0.0.1:7199
    python -m zhpe_ompi_tpu_torch.tools.ztune --check tuned.table   # exit 0/1
"""

from __future__ import annotations

import json
import os
import sys
import time

#: emulated topology shapes: per-rank boot-id pins (host emulation) and
#: numa-id pins (domain emulation) exactly like the han bench ladder,
#: plus the (n_hosts, n_domains, ranks_per_domain) section key the
#: serving side derives from its own locality probe.
TOPOLOGIES = {
    "flat": {
        "boots": ("zthost0", "zthost1", "zthost2", "zthost3"),
        "numas": None,
        "key": (4, 4, 1),
        "hier": False,
    },
    "han2": {
        "boots": ("zthost0", "zthost0", "zthost1", "zthost1"),
        "numas": None,
        "key": (2, 2, 2),
        "hier": True,
    },
    "han3": {
        "boots": ("zthost0",) * 4 + ("zthost1",) * 4,
        "numas": ("ztd0", "ztd0", "ztd1", "ztd1") * 2,
        "key": (2, 4, 2),
        "hier": True,
    },
}

#: candidate algorithms per op — every name maps onto an eligibility-
#: guarded body behind coll/host.py's HOST_RULE_ALGS (or the han route);
#: crucially the set COVERS every choice the stock auto decision can
#: make, so the min-wire winner is never worse than auto and the
#: regression gate only ever fires on planted/corrupted cells.
CANDIDATES = {
    "allreduce": ("recursive_doubling", "ring", "han"),
    "reduce": ("binomial", "pipeline", "han"),
    "alltoall": ("pairwise", "bruck", "han"),
    "alltoallv": ("pairwise", "han"),
}

#: ops whose serve-time rules consult sees 0 payload bytes (per-rank
#: send lists are never congruent across ranks — the bcast discipline
#: in coll/host.py), so a rule with msg_bytes_min > 0 would be DEAD at
#: serve time: the distiller pins these ops' rules to bmin 0, electing
#: the winner from the smallest swept size (larger sizes ride the
#: report rows only — a size-split choice is not expressible).
SIZE_BLIND_OPS = frozenset(("alltoall", "alltoallv"))

#: counter deltas measured per cell: the first two are the gating wire
#: metric (sum = payload bytes that crossed a transport), the rest ride
#: the report for the han phase split.
CELL_COUNTERS = (
    "tcp_bytes_sent", "sm_bytes_sent",
    "coll_han_inter_bytes", "coll_han_intra_bytes",
    "coll_han_dleader_bytes", "sm_frag_sends",
)

_DEF_MIN_BYTES = 1 << 10
_DEF_MAX_BYTES = 64 << 10


def _wire(deltas: dict) -> int:
    return int(deltas.get("tcp_bytes_sent", 0)) \
        + int(deltas.get("sm_bytes_sent", 0))


# -- hygiene: no sweep worker may outlive its sweep ---------------------

_sweep_procs: list = []


def orphaned_sweep_processes() -> list[str]:
    """ztune sweep worker interpreters still alive — the conftest
    session gate's view (the dvm orphan-scan idiom): every ``--real-
    procs`` sweep owns killing its workers; ``--_worker`` children of a
    crashed parent are caught by the cmdline scan."""
    out = []
    for p in list(_sweep_procs):
        if p.poll() is None:
            out.append(f"ztune-worker pid {p.pid} (tracked)")
        else:
            _sweep_procs.remove(p)
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out  # no /proc: nothing to scan
    for pid in pids:
        if int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0") if a]
        except OSError:
            continue  # raced an exit
        # match ACTUAL worker invocations only ("python -m
        # zhpe_ompi_tpu_torch.tools.ztune --_worker ..."), never a shell or
        # pytest line that merely mentions ztune
        if any(a == "zhpe_ompi_tpu_torch.tools.ztune" for a in args) \
                and "--_worker" in args:
            out.append(f"pid {pid}: {' '.join(args[:4])}...")
    return out


# -- measurement --------------------------------------------------------


def _osu():
    """The port's OSU harness module, inside the package."""
    from ..benchmarks import osu_zmpi

    return osu_zmpi


def _cell_body(proc, op: str, nbytes: int, iters: int, trials: int):
    """One rank's measurement body (thread AND real-process modes):
    correctness-checked warmup, then ``trials`` barrier-bracketed
    counter windows around ``iters`` calls; returns (min-wire counter
    deltas, best seconds/op).  The window is bracketed identically for
    every mode, so the deltas are comparable cell to cell."""
    import numpy as np

    from zhpe_ompi_tpu_torch import ops as zops
    from zhpe_ompi_tpu_torch.runtime import spc

    n, rank = proc.size, proc.rank
    arr = np.full(max(n, nbytes // 8), float(rank + 1), dtype=np.float64)
    expect = float(n * (n + 1) // 2)
    # alltoall family: nbytes total per rank, split into n per-
    # destination blocks stamped with the sender (correctness below)
    blocks = [np.full(max(1, nbytes // (8 * n)), float(rank + 1),
                      dtype=np.float64) for _ in range(n)]

    def run_once():
        if op == "allreduce":
            return proc.allreduce(arr, zops.SUM)
        if op == "alltoall":
            return proc.alltoall(list(blocks))
        if op == "alltoallv":
            return proc.alltoallv(np.concatenate(blocks),
                                  [b.size for b in blocks])
        return proc.reduce(arr, zops.SUM, 0)

    out = run_once()  # warmup + correctness (a tuned table must never
    if op in SIZE_BLIND_OPS:  # trade wrong answers for bytes)
        for src, blk in enumerate(out):
            got = np.asarray(blk).reshape(-1)
            if got[0] != float(src + 1) or got[-1] != float(src + 1):
                raise RuntimeError(
                    f"ztune cell {op}/{nbytes}B: wrong block from rank "
                    f"{src} (got {got[0]}, want {float(src + 1)})"
                )
    elif op == "allreduce" or rank == 0:
        got = np.asarray(out).reshape(-1)
        if got[0] != expect or got[-1] != expect:
            raise RuntimeError(
                f"ztune cell {op}/{nbytes}B: wrong result "
                f"(got {got[0]}, want {expect})"
            )
    best = None
    best_sec = float("inf")
    for _ in range(max(1, trials)):
        proc.barrier()
        base = {c: spc.read(c) for c in CELL_COUNTERS}
        proc.barrier()
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            run_once()
        sec = (time.perf_counter() - t0) / max(1, iters)
        proc.barrier()
        deltas = {c: spc.read(c) - base[c] for c in CELL_COUNTERS}
        if best is None or _wire(deltas) < _wire(best):
            best = deltas
        best_sec = min(best_sec, sec)
    return best, best_sec


def _mode_vars(mode: str, alg: str | None, op: str,
               rules_path: str | None):
    """(var assignments) for a measurement mode: ``auto`` is the stock
    decision, ``flat`` the hand-set-constants path (han off, no rules
    — exactly the frozen defaults the sweep exists to beat), and
    ``rule:<alg>`` forces one candidate through a one-line table (the
    rules file is REWRITTEN IN PLACE per candidate — dogfooding the
    (mtime, size) cache invalidation this PR fixes)."""
    if mode == "flat":
        return {"coll_han_enable": "off", "coll_tuned_dynamic_rules": ""}
    if mode == "auto":
        return {"coll_han_enable": "auto",
                "coll_tuned_dynamic_rules": ""}
    assert alg is not None and rules_path is not None
    with open(rules_path, "w", encoding="utf-8") as fh:
        fh.write(f"{op} 0 0 {alg}\n")
    return {"coll_han_enable": "auto",
            "coll_tuned_dynamic_rules": rules_path}


def _measure_threads(topo: dict, op: str, nbytes: int, mode: str,
                     alg: str | None, rules_path: str | None,
                     iters: int, trials: int):
    """One (topology, op, size, mode) cell on the thread harness."""
    from zhpe_ompi_tpu_torch.mca import var as mca_var

    osu = _osu()
    n = len(topo["boots"])
    kwargs_by_rank = {
        r: dict(
            sm_boot_id=topo["boots"][r],
            **({"sm_numa_id": topo["numas"][r]} if topo["numas"]
               else {}),
        )
        for r in range(n)
    }
    assigns = _mode_vars(mode, alg, op, rules_path)
    try:
        for name, value in assigns.items():
            mca_var.set_var(name, value)
        results = osu._run_tcp_ranks(
            n, lambda proc: _cell_body(proc, op, nbytes, iters, trials),
            timeout=300.0, sm=True, kwargs_by_rank=kwargs_by_rank,
        )
    finally:
        for name in assigns:
            mca_var.unset(name)
    # process-global counters: rank 0's barrier-bracketed window
    # already covers every rank's traffic
    deltas, sec = results[0]
    return deltas, sec


def _measure_procs(topo: dict, op: str, nbytes: int, mode: str,
                   alg: str | None, rules_path: str | None,
                   iters: int, trials: int):
    """The real-process twin: one interpreter per rank (own GIL, own
    counters — the parent sums the per-rank deltas), the osu port-
    reservation/drain/orphan-kill pattern, workers re-entering THIS
    module via ``--_worker``."""
    import socket
    import subprocess
    import threading

    osu = _osu()
    if mode.startswith("rule"):
        _mode_vars(mode, alg, op, rules_path)  # (re)write the table
    n = len(topo["boots"])
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = osu._bench_env(repo)
    last_exc = None
    for _attempt in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        procs = []
        try:
            for rank in range(n):
                spec = {
                    "rank": rank, "size": n, "port": port, "op": op,
                    "nbytes": nbytes, "iters": iters, "trials": trials,
                    "boot": topo["boots"][rank],
                    "numa": (topo["numas"][rank] if topo["numas"]
                             else None),
                    "mode": mode,
                    "rules_path": (rules_path
                                   if mode.startswith("rule") else None),
                }
                p = subprocess.Popen(
                    [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.ztune",
                     "--_worker", json.dumps(spec)],
                    env=env, cwd=repo, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                )
                procs.append(p)
                _sweep_procs.append(p)
            outs: list = [None] * n
            errs: list = [None] * n

            def drain(rank, p):
                try:
                    outs[rank], errs[rank] = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs[rank], errs[rank] = p.communicate()

            threads = [threading.Thread(target=drain, args=(r, p),
                                        daemon=True)
                       for r, p in enumerate(procs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for rank, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"ztune worker rank {rank} failed:\n"
                        f"{errs[rank]}\n{outs[rank]}"
                    )
        finally:
            for p in procs:  # no orphan interpreters
                if p.poll() is None:
                    p.kill()
                    p.wait()
        try:
            reports = [json.loads(out.strip().splitlines()[-1])
                       for out in outs]
        except (ValueError, IndexError) as e:
            last_exc = RuntimeError(f"ztune worker report garbled: {e}")
            continue
        if any("Address already in use" in (e or "") for e in errs):
            last_exc = RuntimeError("coordinator port stolen (TOCTOU)")
            continue
        deltas = {c: sum(int(r["counters"].get(c, 0)) for r in reports)
                  for c in CELL_COUNTERS}
        sec = max(float(r["sec"]) for r in reports)
        return deltas, sec
    raise last_exc


def _worker_main(spec: dict) -> int:
    """``--_worker`` entry: one real-process sweep rank."""
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

    rank, n = int(spec["rank"]), int(spec["size"])
    if spec["mode"] == "flat":
        mca_var.set_var("coll_han_enable", "off")
    if spec.get("rules_path"):
        mca_var.set_var("coll_tuned_dynamic_rules", spec["rules_path"])
    proc = TcpProc(
        rank, n, coordinator=("127.0.0.1", int(spec["port"])),
        timeout=120.0, sm=True, sm_boot_id=spec.get("boot"),
        sm_numa_id=spec.get("numa"),
    )
    try:
        deltas, sec = _cell_body(
            proc, spec["op"], int(spec["nbytes"]), int(spec["iters"]),
            int(spec["trials"]),
        )
    finally:
        proc.close()
    print(json.dumps({"rank": rank, "counters": deltas, "sec": sec}),
          flush=True)
    return 0


# -- sweep + distill ----------------------------------------------------


def sweep(topos=("flat", "han2", "han3"),
          ops=("allreduce", "reduce", "alltoall", "alltoallv"),
          min_bytes: int = _DEF_MIN_BYTES,
          max_bytes: int = _DEF_MAX_BYTES, iters: int = 4,
          trials: int = 2, real_procs: bool = False,
          rules_path: str | None = None, progress=None) -> list[dict]:
    """Run the ladder: for every (topology, op, size) cell measure the
    stock ``auto`` decision, the hand-set-constants ``flat`` path, and
    every candidate algorithm; returns the raw cell list for
    :func:`distill`.  Counter-gated by construction — latency is
    carried report-only."""
    from zhpe_ompi_tpu_torch.runtime import spc

    osu = _osu()
    measure = _measure_procs if real_procs else _measure_threads
    if rules_path is None:
        import tempfile

        fd, rules_path = tempfile.mkstemp(prefix="ztune_force_",
                                          suffix=".rules")
        os.close(fd)
    cells = []
    try:
        for tname in topos:
            topo = TOPOLOGIES[tname]
            n = len(topo["boots"])
            cands = {
                op: tuple(a for a in CANDIDATES[op]
                          if a != "han" or topo["hier"])
                for op in ops
            }
            for op in ops:
                for nbytes in osu._sizes(max_bytes, min_bytes):
                    cell = {
                        "topo": tname, "key": topo["key"], "op": op,
                        "comm_size": n, "nbytes": nbytes,
                        "modes": {},
                    }
                    runs = [("auto", None), ("flat", None)] + [
                        (f"rule:{a}", a) for a in cands[op]
                    ]
                    for mode, alg in runs:
                        deltas, sec = measure(
                            topo, op, nbytes, mode, alg, rules_path,
                            iters, trials,
                        )
                        cell["modes"][mode] = {
                            "wire": _wire(deltas),
                            "lat_us": sec * 1e6,
                            "counters": deltas,
                        }
                        spc.record("ztune_cells_swept")
                        if progress is not None:
                            progress(tname, op, nbytes, mode,
                                     cell["modes"][mode])
                    cells.append(cell)
    finally:
        try:
            os.unlink(rules_path)
        except OSError:
            pass
    return cells


def distill(cells: list[dict]) -> dict:
    """Distill swept cells into per-topology rules, enforcing the
    regression gate: the winner of a cell is its minimum-wire
    candidate, and a cell whose proposed winner moves MORE wire bytes
    than the stock auto decision is REJECTED loudly
    (``tuned_regression_rejects``) — the builtin decision keeps that
    cell.  A cell may carry ``"winner"`` explicitly (a planted or
    hand-edited table row); the gate applies identically.

    A cell whose winner falls to the gate (or that names an unswept
    winner) keeps the builtin decision — and if a neighboring cell
    already emitted a rule for the same op, the dropped cell gets an
    explicit ``builtin`` band terminator so the neighbor's rule can
    never leak over it (rules match by largest ``bmin`` <= payload).

    Returns ``{key: {"rules": [(op, cmin, bmin, alg)],
    "report": [...]}}`` with consecutive same-winner sizes merged."""
    from zhpe_ompi_tpu_torch.mca import output as mca_output
    from zhpe_ompi_tpu_torch.runtime import spc

    stream = mca_output.open_stream("ztune")
    out: dict = {}
    for cell in cells:
        key = tuple(cell["key"])
        modes = cell["modes"]
        auto = modes.get("auto")
        candidates = {
            m.split(":", 1)[1]: v for m, v in modes.items()
            if m.startswith("rule:")
        }
        winner = cell.get("winner")
        if winner is None:
            if not candidates:
                continue
            # deterministic order: wire, then tcp share, then name
            winner = min(
                candidates,
                key=lambda a: (candidates[a]["wire"],
                               candidates[a]["counters"].get(
                                   "tcp_bytes_sent", 0), a),
            )
        wdata = candidates.get(winner)
        alg = winner
        if wdata is None:
            mca_output.emit(
                stream,
                "ztune distill: cell %s/%s/%dB names unswept winner "
                "%r; the builtin decision keeps this cell",
                cell["topo"], cell["op"], cell["nbytes"], winner,
            )
            alg = "builtin"
        elif auto is not None and wdata["wire"] > auto["wire"]:
            # THE regression gate: a tuned table may never pick an
            # algorithm whose counter-gated wire bytes exceed the
            # default's for this (op, comm_size, nbytes) cell
            spc.record("tuned_regression_rejects")
            mca_output.emit(
                stream,
                "ztune distill: REJECTED %s/%s/%dB winner %r (%d wire "
                "bytes > auto default's %d); the builtin decision "
                "keeps this cell", cell["topo"], cell["op"],
                cell["nbytes"], winner, wdata["wire"], auto["wire"],
            )
            alg = "builtin"
        entry = out.setdefault(key, {"rules": [], "report": []})
        if alg != "builtin":
            entry["report"].append({
                "op": cell["op"], "nbytes": cell["nbytes"],
                "winner": winner, "wire": wdata["wire"],
                "auto_wire": auto["wire"] if auto else None,
                "flat_wire": (modes.get("flat") or {}).get("wire"),
                "lat_us": wdata.get("lat_us"),
            })
        rules = entry["rules"]
        op_rules = [r for r in rules if r[0] == cell["op"]]
        if cell["op"] in SIZE_BLIND_OPS:
            # serve-time consult sees 0 bytes: one bmin-0 rule per op,
            # elected by the smallest swept size (sweep order)
            if op_rules or alg == "builtin":
                continue
            rules.append((cell["op"], 0, 0, alg))
            continue
        # merge: only emit when the choice changes along the size axis;
        # a leading "builtin" is implicit (no rule = builtin)
        if op_rules and op_rules[-1][3] == alg:
            continue
        if not op_rules and alg == "builtin":
            continue
        rules.append((cell["op"], 0, cell["nbytes"], alg))
    return out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def geometry_for(cells: list[dict], key: tuple) -> dict:
    """Per-class sm ring sizing from the sweep's working set: rings
    sized to hold ~4 in-flight max-payload fragments instead of the frozen 4MB/2MB defaults — adopted by segment owners
    through pt2pt/sm.py's geometry path only while the vars are
    defaulted.  Clamped so tiny sweeps never starve the slot floor."""
    sizes = [c["nbytes"] for c in cells if tuple(c["key"]) == key]
    if not sizes:
        return {}
    biggest = max(sizes)
    ring = min(max(_next_pow2(4 * biggest), 256 << 10), 4 << 20)
    leader = min(max(_next_pow2(2 * biggest), 256 << 10), 2 << 20)
    return {"sm_ring_bytes": ring, "sm_leader_ring_bytes": leader}


def format_table(distilled: dict, geometry: dict | None = None,
                 note: str = "") -> str:
    """Render distilled rules as a coll/ztable.py sectioned table;
    latency and wire columns ride as comment rows (report-only — the
    counter gate picked the winners)."""
    lines = ["# ztune-generated tuned decision table"]
    if note:
        lines.append(f"# {note}")
    for key in sorted(distilled, key=lambda k: tuple(
            -1 if f is None else f for f in k)):
        entry = distilled[key]
        fields = " ".join("*" if f is None else str(f) for f in key)
        lines.append(f"[topology {fields}]")
        for rep in entry.get("report", []):
            lines.append(
                "#   %-10s %7dB -> %-18s wire=%s auto=%s flat=%s "
                "lat_us=%.1f (report-only)" % (
                    rep["op"], rep["nbytes"], rep["winner"],
                    rep["wire"], rep["auto_wire"], rep["flat_wire"],
                    rep["lat_us"] or 0.0,
                ))
        for op, cmin, bmin, alg in entry.get("rules", []):
            lines.append(f"{op} {cmin} {bmin} {alg}")
        for var, val in (geometry or {}).get(key, {}).items():
            lines.append(f"geometry {var} {val}")
    return "\n".join(lines) + "\n"


# -- verbs --------------------------------------------------------------


def check_table(path: str) -> int:
    """``--check``: strict validation of a table file — every line must
    parse (the serving side would degrade loudly per line; the check
    verb makes that degradation a FAILING exit for CI).  Exit 0/1."""
    from zhpe_ompi_tpu_torch.coll import tuned  # installs the alg validator
    from zhpe_ompi_tpu_torch.coll import ztable

    assert tuned._valid_rule_alg  # the validator import is the point
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        print(f"ztune --check: {path}: unreadable ({e})")
        return 1
    problems: list = []
    sections = ztable.parse_table(text, origin=path, problems=problems)
    for lineno, line, reason in problems:
        print(f"ztune --check: {path}:{lineno}: {line!r}: {reason}")
    nrules = sum(len(r) for _k, r, _g in sections)
    ngeom = sum(len(g) for _k, _r, g in sections)
    print(f"ztune --check: {path}: {len(sections)} section(s), "
          f"{nrules} rule(s), {ngeom} geometry line(s), "
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


def publish(address: str, text: str) -> None:
    """Push a table into a live store (a zprted's PMIx port) under the
    well-known ztune key."""
    from zhpe_ompi_tpu_torch.runtime import pmix as pmix_mod

    client = pmix_mod.PmixClient(address)
    try:
        pmix_mod.publish_tuned_table(client, text)
    finally:
        client.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="ztune",
        description="sweep collective ladders per topology, distill a "
                    "tuned decision table, publish it to a DVM store",
    )
    ap.add_argument("--check", metavar="TABLE",
                    help="validate TABLE strictly and exit 0/1")
    ap.add_argument("--out", metavar="FILE",
                    help="write the distilled table here")
    ap.add_argument("--publish", metavar="HOST:PORT",
                    help="publish the table into this PMIx store")
    ap.add_argument("--topos", default="flat,han2,han3")
    ap.add_argument("--ops", default="allreduce,reduce,alltoall,alltoallv")
    ap.add_argument("--min-bytes", type=int, default=_DEF_MIN_BYTES)
    ap.add_argument("--max-bytes", type=int, default=_DEF_MAX_BYTES)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--real-procs", action="store_true",
                    help="one interpreter per rank (the acceptance "
                         "topology); default is the thread harness")
    ap.add_argument("--no-geometry", action="store_true",
                    help="skip the sm ring-sizing lines")
    ap.add_argument("--_worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args._worker:
        return _worker_main(json.loads(args._worker))
    if args.check:
        return check_table(args.check)

    topos = tuple(t for t in args.topos.split(",") if t)
    ops = tuple(o for o in args.ops.split(",") if o)
    for t in topos:
        if t not in TOPOLOGIES:
            print(f"ztune: unknown topology {t!r} "
                  f"(one of {', '.join(TOPOLOGIES)})")
            return 2
    for o in ops:
        if o not in CANDIDATES:
            print(f"ztune: unknown op {o!r} "
                  f"(one of {', '.join(CANDIDATES)})")
            return 2

    def progress(tname, op, nbytes, mode, data):
        print(f"ztune: {tname:5s} {op:10s} {nbytes:7d}B {mode:22s} "
              f"wire={data['wire']:<9d} lat_us={data['lat_us']:.1f}",
              flush=True)

    cells = sweep(
        topos=topos, ops=ops, min_bytes=args.min_bytes,
        max_bytes=args.max_bytes, iters=args.iters, trials=args.trials,
        real_procs=args.real_procs, progress=progress,
    )
    distilled = distill(cells)
    geometry = None
    if not args.no_geometry:
        geometry = {key: geometry_for(cells, key) for key in distilled}
    text = format_table(
        distilled, geometry,
        note=(f"swept {'real-process' if args.real_procs else 'thread'}"
              f" topologies={','.join(topos)} ops={','.join(ops)} "
              f"sizes=[{args.min_bytes},{args.max_bytes}]"),
    )
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"ztune: wrote {args.out}")
    else:
        sys.stdout.write(text)
    if args.publish:
        publish(args.publish, text)
        print(f"ztune: published to {args.publish}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
