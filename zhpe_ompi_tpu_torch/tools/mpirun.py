"""``zmpirun`` — the mpirun/PRRTE analog for the host plane
(namesake: ``zhpe_ompi_tpu/tools/mpirun.py``).

In the reference, ``mpirun`` is literally a symlink to the external ``prte``
binary (``ompi/tools/mpirun/Makefile.am:11-15``): PRRTE launches the
processes, forwards their stdio (IOF), hands each proc its rank and the
PMIx contact info through the environment, propagates exit codes, and
tears the whole job down when any rank aborts
(``test/simple/delayed_abort.c`` is the acceptance shape for that).

This CLI is that surface for the TCP/DCN plane:

- **launch**: spawn ``-n`` local processes with the ``ZMPI_*`` environment
  contract (the PMIx-put/get analog), which the JAX package's ranks share:
  a port rank or a JAX-package rank joins through its own ``host_init``,
  and either package's launcher runs either package's ranks.  Python
  programs (``*.py``) run under this interpreter; anything else is exec'd
  directly (the C ranks of the namesake's ABI shim, which the port does
  not carry yet).
- **IOF**: children's stdout/stderr are line-forwarded with a ``[r]``
  prefix (mpirun ``--tag-output`` semantics, on by default).
- **abort**: if any rank exits nonzero the remaining ranks are terminated
  after a short grace period and the job exits with the failing rank's
  code — MPI_Abort job semantics.
- **--mca name value** is forwarded as ``ZMPI_MCA_<name>`` env, exactly
  the reference's ``mpirun --mca`` → ``OMPI_MCA_*`` plumbing.

The launcher hosts the modex rendezvous (every rank, rank 0 included,
connects to it under ``ZMPI_COORD_EXTERNAL=1``) and the name server
(``ZMPI_NAMESERVER``, which ``comm/dpm_wire``'s publish and lookup use),
and after the job sweeps the ring files its killed ranks left
(``ZMPI_SESSION``).  ``--dvm`` launches into a resident daemon
(``runtime/dvm.py``) instead.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any

_TERM_GRACE = 2.0  # seconds between SIGTERM and SIGKILL on abort


class _JobSignal(Exception):
    """Raised out of the CLI's SIGINT/SIGTERM handler into the monitor
    loop: the launcher forwards the signal to the job, reaps every
    child, releases its rendezvous/name-server ports, and exits
    ``128 + signum`` — a Ctrl-C must never orphan ranks still holding
    sockets and /dev/shm rings."""

    def __init__(self, signum: int):
        super().__init__(f"signal {signum}")
        self.signum = signum


def _start_coordinator(host: str, size: int, timeout: float):
    """Host the modex rendezvous in the LAUNCHER (PRRTE hosts the PMIx
    server, ranks are all clients).  Binding port 0 here removes the
    probe-then-rebind race a launcher-chosen fixed port would have: the
    socket is listening before any rank spawns.  Every rank — including
    rank 0, told by ZMPI_COORD_EXTERNAL=1 — connects, sends its
    (rank, address) card, and receives the full address book."""
    from ..pt2pt.tcp import _recv_frame, _send_frame
    from ..utils import dss

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, 0))
    srv.listen(size + 4)
    srv.settimeout(timeout)

    def serve():
        book = [None] * size
        conns = []
        try:
            for _ in range(size):
                conn, _ = srv.accept()
                [rank, addr] = dss.unpack(_recv_frame(conn))
                book[rank] = addr
                conns.append(conn)
            payload = dss.pack(book)
            for c in conns:
                _send_frame(c, payload)
        except OSError:
            pass  # job died / timed out; ranks see their own modex timeout
        finally:
            for c in conns:
                c.close()
            srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    # the socket is returned alongside the port so the launcher can
    # RELEASE it on any exit path (signal teardown included): a port
    # held by a dead job's rendezvous thread is a leak
    return srv.getsockname()[1], srv


def _start_name_server(host: str):
    """The ompi-server analog: a tiny publish/lookup/unpublish registry
    that lives for the job (MPI_Publish_name needs a server that outlasts
    any one rank — the reference ships a separate ``ompi-server`` daemon
    for exactly this; here the launcher hosts it).  One request per
    connection: request frame = dss.pack of ONE list value —
    ["pub", service, port] / ["look", service] / ["unpub", service];
    reply frame = dss.pack of ONE result value (True, the port name or
    None, found-bool respectively)."""
    from ..pt2pt.tcp import _recv_frame, _send_frame
    from ..utils import dss

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, 0))
    srv.listen(16)
    registry: dict[str, str] = {}
    reg_lock = threading.Lock()

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return  # launcher exiting
            try:
                # a stalled/garbage client must cost at most 5s and never
                # kill the service for the rest of the job
                conn.settimeout(5.0)
                frame = _recv_frame(conn)
                if frame is None:
                    continue
                [req] = dss.unpack(frame)
                op = req[0]
                with reg_lock:
                    if op == "pub":
                        registry[req[1]] = req[2]
                        out = True
                    elif op == "look":
                        out = registry.get(req[1])
                    elif op == "unpub":
                        out = registry.pop(req[1], None) is not None
                    else:
                        out = None
                _send_frame(conn, dss.pack(out))
            except Exception:  # noqa: BLE001 - malformed request; serve on
                pass
            finally:
                conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv, srv.getsockname()[1]


def _forward(stream, rank: int, label: str, out, lock: threading.Lock,
             tag: bool) -> None:
    """IOF drain thread: line-forward a child stream with a rank prefix."""
    for line in iter(stream.readline, ""):
        with lock:
            if tag:
                out.write(f"[{rank}{label}] {line}")
            else:
                out.write(line)
            out.flush()
    stream.close()


def build_env(rank: int, size: int, host: str, port: int,
              mca: list[tuple[str, str]] | None = None,
              ns_port: int | None = None, ft: bool = False) -> dict:
    """The ZMPI_* environment contract one rank sees (PMIx envars analog)."""
    env = dict(os.environ)
    env.update({
        "ZMPI_RANK": str(rank),
        "ZMPI_SIZE": str(size),
        "ZMPI_COORD_HOST": host,
        "ZMPI_COORD_PORT": str(port),
        # the launcher hosts the rendezvous: rank 0 joins as a client
        # instead of binding the coordinator itself
        "ZMPI_COORD_EXTERNAL": "1",
        # session tag for /dev/shm segment names: INHERITED by
        # MPI_Comm_spawn children (whose coordinator port differs), so
        # the launcher's end-of-job sweep catches every segment of the
        # whole job tree with one prefix
        "ZMPI_SESSION": str(port),
    })
    if ns_port is not None:
        env["ZMPI_NAMESERVER"] = f"{host}:{ns_port}"
    if ft:
        # fault-tolerant job: every rank's host_init builds an ft=True
        # endpoint (detector, typed failures, recovery surface)
        env["ZMPI_FT"] = "1"
    # make the framework importable in every rank regardless of cwd — the
    # mpirun-exports-its-library-paths behavior (OPAL_PREFIX/LD_LIBRARY_PATH)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    parts = env.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_root] + [p for p in parts if p])
    for name, value in mca or ():
        env[f"ZMPI_MCA_{name}"] = value
    return env


def launch(n: int, argv: list[str], host: str = "127.0.0.1",
           mca: list[tuple[str, str]] | None = None,
           timeout: float | None = None, tag_output: bool = True,
           stdout=None, stderr=None, ft: bool = False) -> int:
    """Run ``argv`` as an ``n``-rank job; returns the job exit code.

    Python programs (``*.py``) run under the current interpreter; anything
    else is exec'd directly.
    """
    return launch_mpmd([(n, argv)], host=host, mca=mca, timeout=timeout,
                       tag_output=tag_output, stdout=stdout, stderr=stderr,
                       ft=ft)


def launch_dvm(dvm: str, n: int, argv: list[str] | None = None,
               mca: list[tuple[str, str]] | None = None,
               timeout: float | None = None, tag_output: bool = True,
               stdout=None, stderr=None, ft: bool = False,
               metrics: bool = False, trace: bool = False,
               max_size: int | None = None,
               apps: list[tuple[int, list[str]]] | None = None,
               priority: int = 0,
               placement: str | None = None) -> int:
    """Launch a job INTO a resident runtime daemon (``zmpirun --dvm``):
    the zprted VM hosts the PMIx store and the children, streams their
    IOF back here, and outlives the job — no per-job rendezvous, no
    name server, no launcher teardown (the prte DVM shape;
    :mod:`zhpe_ompi_tpu_torch.runtime.dvm`).  On a DVM *tree* the target may
    be any daemon, but launches go to the root (``zmpirun --dvm`` users
    pass the root's address); ranks are block-placed across the tree's
    hosts.  ``metrics=True`` exports ``ZMPI_METRICS=1`` to every rank:
    each publishes SPC snapshots into the resident store (the
    fleet-visible metrics plane).  ``max_size`` (> n) launches the job
    ELASTIC (see :meth:`DvmClient.launch`); ``apps`` is the MPMD form —
    mixed C/Python contexts share the store-served wire-up.
    ``priority`` orders this launch in the daemon's admission queue
    (``dvm_admission_policy=priority``); ``placement`` picks its
    subtree policy (pack/spread/exclusive, default the daemon's
    ``dvm_placement``)."""
    from ..runtime.dvm import DvmClient

    client = DvmClient(dvm)
    try:
        return client.launch(n, argv, mca=mca, ft=ft, timeout=timeout,
                             tag_output=tag_output, stdout=stdout,
                             stderr=stderr, metrics=metrics,
                             trace=trace, max_size=max_size, apps=apps,
                             priority=priority, placement=placement)
    finally:
        client.close()


def resize_dvm(dvm: str, job_id: str, n: int,
               timeout: float = 60.0) -> dict:
    """Elastic resize of a running ft job in the resident VM
    (``zmpirun --dvm H:P --resize JOB -n N``): grow spawns fresh ranks
    that FT_JOIN the live job, shrink retires the highest live ranks
    through the orderly-BYE path.  Returns the applied event."""
    from ..runtime.dvm import DvmClient

    client = DvmClient(dvm)
    try:
        return client.resize(job_id, n, timeout=timeout)
    finally:
        client.close()


def launch_mpmd(apps: list[tuple[int, list[str]]], host: str = "127.0.0.1",
                mca: list[tuple[str, str]] | None = None,
                timeout: float | None = None, tag_output: bool = True,
                stdout=None, stderr=None, ft: bool = False) -> int:
    """MPMD launch (mpirun's ``-n A progA : -n B progB``): one job, one
    COMM_WORLD, consecutive rank blocks per app context.  Every context
    speaks the same wire protocol, so port and JAX-package programs can
    be one job."""
    if not apps or any(n < 1 for n, _ in apps):
        raise ValueError("zmpirun: every app context needs -n >= 1")
    n = sum(cnt for cnt, _ in apps)
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr
    port, coord_srv = _start_coordinator(host, n, timeout or 120.0)
    ns_srv, ns_port = _start_name_server(host)
    cmds: list[list[str]] = []
    for cnt, argv in apps:
        cmd = list(argv)
        if cmd[0].endswith(".py"):
            cmd = [sys.executable] + cmd
        cmds.extend([cmd] * cnt)
    try:
        return _launch_job(n, cmds, host, port, ns_port, mca, timeout,
                           tag_output, stdout, stderr, ft)
    finally:
        # release the ports on EVERY exit path (signal teardown
        # included): the rendezvous and name-server sockets must not
        # outlive the job they served
        coord_srv.close()
        ns_srv.close()  # stops the name-server accept loop
        _sweep_session_shm(port)


def _sweep_session_shm(port: int) -> None:
    """The PRRTE session-directory cleanup analog: a rank that aborts
    (or is killed) never reaches MPI_Finalize, so its /dev/shm ring and
    shared-window segments survive it.  Every segment of the job TREE
    embeds the launcher's session tag (ZMPI_SESSION, inherited through
    MPI_Comm_spawn whose children rendezvous on a different port), so
    one prefix sweep covers spawned ranks too."""
    from ..pt2pt import sm

    seg_dir = sm.segment_dir()
    try:
        names = os.listdir(seg_dir)
    except OSError:
        return  # no segment directory: nothing to sweep
    for f in names:
        if f.startswith((f"zompi_ring_{port}_", f"zompi_shm_{port}_",
                         f"zompi_pyring_{port}_")):
            try:
                os.unlink(os.path.join(seg_dir, f))
            except OSError:
                pass


def _launch_job(n, cmds, host, port, ns_port, mca, timeout, tag_output,
                stdout, stderr, ft: bool = False) -> int:
    procs: list[subprocess.Popen] = []
    drains: list[threading.Thread] = []
    out_lock = threading.Lock()
    live: set = set()
    deadline = time.monotonic() + timeout if timeout else None
    exit_code = 0
    failed_rank = None
    # the spawn loop sits INSIDE the signal-handling try: a SIGTERM
    # landing mid-spawn must tear down the ranks already started, not
    # orphan them in the modex rendezvous (children run in their own
    # sessions — the terminal's signal never reaches them directly)
    try:
        for rank in range(n):
            try:
                p = subprocess.Popen(
                    cmds[rank],
                    env=build_env(rank, n, host, port, mca, ns_port, ft),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                    start_new_session=True,  # isolate from our signals
                )
            except OSError:
                # MPMD makes mid-loop spawn failure real (a later
                # context's binary may be missing): don't orphan
                # already-spawned ranks in the modex rendezvous
                _teardown(procs, set(live))
                raise
            procs.append(p)
            live.add(rank)
            for stream, label, sink in (
                (p.stdout, "", stdout), (p.stderr, ":err", stderr),
            ):
                t = threading.Thread(
                    target=_forward,
                    args=(stream, rank, label, sink, out_lock,
                          tag_output),
                    daemon=True,
                )
                t.start()
                drains.append(t)

        while live:
            for rank in sorted(live):
                rc = procs[rank].poll()
                if rc is None:
                    continue
                live.discard(rank)
                if rc != 0 and failed_rank is None:
                    failed_rank, exit_code = rank, rc
            if failed_rank is not None and live:
                # MPI_Abort job teardown: one rank failed, kill the rest
                with out_lock:
                    stderr.write(
                        f"zmpirun: rank {failed_rank} exited with code "
                        f"{exit_code}; terminating {len(live)} remaining "
                        "rank(s)\n"
                    )
                    stderr.flush()
                _teardown(procs, live)
                break
            if deadline is not None and time.monotonic() > deadline:
                with out_lock:
                    stderr.write(
                        f"zmpirun: job timeout after {timeout}s; killing "
                        f"{len(live)} rank(s)\n"
                    )
                    stderr.flush()
                _teardown(procs, live)
                exit_code = 124
                break
            time.sleep(0.02)
    except KeyboardInterrupt:
        # Ctrl-C without the CLI's handlers installed (library callers):
        # same hygiene, conventional 130 = 128 + SIGINT
        _forward_signal(procs, live, signal.SIGINT)
        _teardown(procs, live)
        exit_code = 130
    except _JobSignal as js:
        # the CLI's SIGINT/SIGTERM handler: forward the ACTUAL signal to
        # the job first (ranks may catch it and finalize), then the
        # TERM→KILL reaping ladder, then exit 128+sig
        with out_lock:
            stderr.write(
                f"zmpirun: caught signal {js.signum}; forwarding to "
                f"{len(live)} rank(s) and exiting\n"
            )
            stderr.flush()
        _forward_signal(procs, live, js.signum)
        _teardown(procs, live)
        exit_code = 128 + js.signum
    for t in drains:
        t.join(timeout=2.0)
    return exit_code


def _forward_signal(procs: list[subprocess.Popen], live: set,
                    signum: int) -> None:
    for rank in list(live):
        p = procs[rank]
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signum)
            except (OSError, ProcessLookupError):
                pass


def _teardown(procs: list[subprocess.Popen], live: set) -> None:
    for rank in list(live):
        p = procs[rank]
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (OSError, ProcessLookupError):
                pass
    grace_end = time.monotonic() + _TERM_GRACE
    for rank in list(live):
        p = procs[rank]
        try:
            p.wait(timeout=max(0.0, grace_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
            p.wait()
        live.discard(rank)


def main(args: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="zmpirun",
        description="Launch an n-rank host-plane job (mpirun analog). "
                    "MPMD: separate app contexts with ':' — "
                    "zmpirun -n 2 progA : -n 2 progB",
    )
    ap.add_argument("-n", "--np", type=int, required=True, dest="n",
                    help="number of ranks (per app context)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind/rendezvous address (default 127.0.0.1)")
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"),
                    help="set an MCA variable (forwarded as ZMPI_MCA_NAME)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill the job after this many seconds")
    ap.add_argument("--no-tag-output", action="store_true",
                    help="forward child output without [rank] prefixes")
    ap.add_argument("--dvm", default=None, metavar="HOST:PORT",
                    help="launch into a resident zprted daemon instead "
                         "of cold-spawning (python -m "
                         "zhpe_ompi_tpu_torch.runtime.dvm starts one; on a "
                         "daemon TREE pass the root's address)")
    ap.add_argument("--max-size", type=int, default=None,
                    help="elastic job (--dvm + --ft only): the "
                         "endpoint universe is this many slots, -n of "
                         "them start live, and the daemon's resize RPC "
                         "grows/shrinks membership while the job runs")
    ap.add_argument("--priority", type=int, default=0,
                    help="admission priority (--dvm only): higher "
                         "admits first when the daemon runs "
                         "dvm_admission_policy=priority; ties admit "
                         "in arrival order")
    ap.add_argument("--placement", default=None,
                    choices=("pack", "spread", "exclusive"),
                    help="subtree placement policy (--dvm only): "
                         "pack = block-fill the attach order, spread "
                         "= least-loaded daemons first, exclusive = "
                         "claim daemons hosting no other live job "
                         "(falls back to spread, loudly, when none "
                         "are free); default the daemon's "
                         "dvm_placement")
    ap.add_argument("--resize", default=None, metavar="JOB",
                    help="resize a RUNNING elastic job in the resident "
                         "VM to -n live ranks (--dvm only; no program "
                         "argument) and print the applied event")
    ap.add_argument("--ft", action="store_true",
                    help="fault-tolerant job: ranks build ft=True "
                         "endpoints (detector, typed failures, daemon "
                         "fault events under --dvm)")
    ap.add_argument("--metrics", action="store_true",
                    help="metrics plane (--dvm only): every rank "
                         "publishes its SPC counters into the resident "
                         "store (ZMPI_METRICS=1), scrapeable via the "
                         "daemon's metrics RPC / --metrics-port")
    ap.add_argument("--trace", action="store_true",
                    help="tracing plane (--dvm only, implies "
                         "--metrics): every rank records causal spans "
                         "(ZMPI_TRACE=1) and publishes trace:<job>:"
                         "<rank> buffers for tools/ztrace's merged "
                         "timeline")
    ap.add_argument("argv", nargs=argparse.REMAINDER,
                    help="program and its arguments")
    raw = list(sys.argv[1:] if args is None else args)
    # MPMD: split on ':' tokens; global flags come from the FIRST context
    contexts: list[list[str]] = [[]]
    for tok in raw:
        if tok == ":":
            contexts.append([])
        else:
            contexts[-1].append(tok)
    first = ap.parse_args(contexts[0])
    if first.resize is not None:
        if not first.dvm:
            ap.error("--resize needs --dvm (the job lives in the "
                     "resident VM)")
        if first.argv or len(contexts) > 1:
            ap.error("--resize takes no program: -n is the new live "
                     "size")
        event = resize_dvm(first.dvm, first.resize, first.n,
                           timeout=first.timeout or 60.0)
        print(f"resized {event['job']} to {event['size']} "
              f"(grown={event['grown']} retired={event['retired']} "
              f"generation={event['generation']})")
        return 0
    if not first.argv:
        ap.error("no program given")
    apps = [(first.n, first.argv)]
    for extra in contexts[1:]:
        more = ap.parse_args(extra)
        if not more.argv:
            ap.error("empty app context after ':'")
        # global flags belong to the FIRST context only; accepting them
        # later and ignoring them would silently drop user intent
        if (more.host != "127.0.0.1" or more.mca or
                more.timeout is not None or more.no_tag_output or
                more.dvm or more.ft or more.metrics or more.trace or
                more.max_size is not None or more.resize is not None or
                more.priority or more.placement is not None):
            ap.error(
                "--host/--mca/--timeout/--no-tag-output/--dvm/--ft/"
                "--metrics/--trace/--max-size/--resize/--priority/"
                "--placement are job-global: pass them in the first "
                "app context"
            )
        apps.append((more.n, more.argv))
    if first.max_size is not None and not first.dvm:
        ap.error("--max-size (elastic) needs the resident VM: run "
                 "with --dvm")
    if (first.priority or first.placement is not None) and not first.dvm:
        ap.error("--priority/--placement order and place launches in "
                 "the resident VM: run with --dvm")
    # signal hygiene (main thread only — the CLI path): SIGINT/SIGTERM
    # are forwarded to the job, children reaped, ports released, exit
    # 128+sig — see _JobSignal
    restore: dict[int, Any] = {}

    def _on_signal(signum, _frame):
        raise _JobSignal(signum)

    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGINT, signal.SIGTERM):
            restore[s] = signal.signal(s, _on_signal)
    try:
        if first.dvm:
            return launch_dvm(
                first.dvm, first.n,
                first.argv if len(apps) == 1 else None,
                mca=[tuple(m) for m in first.mca],
                timeout=first.timeout,
                tag_output=not first.no_tag_output, ft=first.ft,
                metrics=first.metrics or first.trace,
                trace=first.trace, max_size=first.max_size,
                apps=None if len(apps) == 1 else apps,
                priority=first.priority, placement=first.placement,
            )
        if first.metrics or first.trace:
            ap.error("--metrics/--trace need the resident store: run "
                     "with --dvm")
        return launch_mpmd(
            apps, host=first.host, mca=[tuple(m) for m in first.mca],
            timeout=first.timeout, tag_output=not first.no_tag_output,
            ft=first.ft,
        )
    except _JobSignal as js:
        # a signal that landed outside the monitor loop (teardown
        # already ran, or the job never started): same exit contract
        return 128 + js.signum
    finally:
        for s, h in restore.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
