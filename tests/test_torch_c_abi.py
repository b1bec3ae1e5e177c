"""The port's C ABI shim (``zhpe_ompi_tpu_torch/native/zompi_mpi.cpp`` and
its headers): C programs built from the port's own sources by the port's
``zmpicc``, held against port ranks.

- A C rank joins a universe of port ``TcpProc`` ranks (in threads): the
  modex, point-to-point both ways, a mixed barrier; its arrays arrive at a
  port rank as CPU tensors.
- 4 MiB through the RTS/CTS rendezvous between a port rank and a C rank,
  both ways; derived datatypes across the planes.
- The MPMD job of ``native/feed_c.c`` (1 C rank) and 2 port ranks under the
  port's ``zmpirun``, the port ranks taking their side of the C rank's
  ``MPI_Scatterv``/``MPI_Gatherv``/``MPI_Bcast`` through ``native/cwire``.
- ``zmpicc`` (``--showme`` and a compile of ``examples/ring_c.c``, read as
  it is) and the ring under the port's launcher.
- C ranks modexed through a port ``Dvm`` (the store verbs), alone and in
  an MPMD job with port ranks.
- A C job's shared-memory rings are unlinked at ``MPI_Finalize``.
- Pure-C examples (``ring_c``, ``halo_c``, ``oshmem_c``, ``spawn_c``)
  linked to the port's shim.

The shim is built once per session (about 25 s of ``g++``), into
``csrc/_build/``.
"""

import io
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from test_torch_dvm_tree import script
from zhpe_ompi_tpu_torch import _build
from zhpe_ompi_tpu_torch import native as tnative
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.tools import zmpicc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}


@pytest.fixture(scope="module")
def shim():
    so = tnative.build_mpi_shim()
    assert os.path.dirname(so) == _build.BUILD_DIR
    assert os.path.basename(so).startswith("libzompi_mpi_")
    return so


def _cc(src, out) -> str:
    """Compile a C source against the port's shim with zmpicc's flags."""
    res = subprocess.run(["gcc", str(src), "-o", str(out),
                          *zmpicc.compile_flags(), *zmpicc.link_flags()],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return str(out)


@pytest.fixture(scope="module")
def cbin(shim, tmp_path_factory):
    """Build-once cache of C programs: ``cbin("ring_c.c")`` compiles an
    example (read from ``examples/``), ``cbin("x.c", text)`` a source."""
    root = tmp_path_factory.mktemp("cabi")
    built = {}

    def get(name, text=None):
        if name not in built:
            src = root / name
            if text is None:
                src = os.path.join(REPO, "examples", name)
            else:
                src.write_text(text)
            built[name] = _cc(src, root / name.rsplit(".", 1)[0])
        return built[name]

    return get


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank, size, port, sm="1"):
    return {**os.environ, "ZMPI_RANK": str(rank), "ZMPI_SIZE": str(size),
            "ZMPI_COORD_HOST": "127.0.0.1", "ZMPI_COORD_PORT": str(port),
            "ZMPI_MCA_sm": sm}


def _with_port_ranks(binpath, n, port_ranks, prog, c_rank, timeout=120):
    """Run ``prog(proc)`` on port ``TcpProc`` ranks in threads beside one
    C process at ``c_rank``; returns (C stdout, results by port rank)."""
    port = _free_port()
    results, excs = {}, []

    def main(rank):
        try:
            proc = TcpProc(rank, n, coordinator=("127.0.0.1", port))
            try:
                results[rank] = prog(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs.append(e)

    threads = [threading.Thread(target=main, args=(r,)) for r in port_ranks]
    for t in threads:
        t.start()
    cproc = subprocess.Popen([binpath], env=_env(c_rank, n, port),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    out, err = cproc.communicate(timeout=timeout)
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "port rank hung"
    if excs:
        raise excs[0]
    assert cproc.returncode == 0, f"C rank failed: {err}\n{out}"
    return out, results


INTEROP_C = r'''
#include <stdio.h>
#include "zompi_mpi.h"
int main(int argc, char **argv) {
  int rank, size, i, n;
  if (MPI_Init(&argc, &argv) != MPI_SUCCESS) return 2;
  MPI_Comm_rank(MPI_COMM_WORLD, &rank);
  MPI_Comm_size(MPI_COMM_WORLD, &size);
  double buf[4];
  MPI_Status st;
  MPI_Recv(buf, 4, MPI_DOUBLE, 0, 7, MPI_COMM_WORLD, &st);
  MPI_Get_count(&st, MPI_DOUBLE, &n);
  for (i = 0; i < 4; i++) buf[i] *= 10.0;
  MPI_Send(buf, 4, MPI_DOUBLE, 0, 8, MPI_COMM_WORLD);
  MPI_Barrier(MPI_COMM_WORLD);
  long v = 12345 + rank;
  MPI_Send(&v, 1, MPI_LONG, 1, 9, MPI_COMM_WORLD);
  printf("interop rank %d/%d n=%d OK\n", rank, size, n);
  MPI_Finalize();
  return 0;
}
'''


def test_c_rank_joins_a_port_tcp_universe(cbin):
    def prog(proc):
        got = None
        if proc.rank == 0:
            proc.send(torch.arange(4, dtype=torch.float64), dest=2, tag=7)
            got = proc.recv(source=2, tag=8)
        proc.barrier()
        if proc.rank == 1:
            got = proc.recv(source=2, tag=9)
        return got

    out, res = _with_port_ranks(cbin("interop.c", INTEROP_C), 3, (0, 1),
                                prog, c_rank=2)
    assert "interop rank 2/3 n=4 OK" in out
    for r in (0, 1):
        assert isinstance(res[r], torch.Tensor) and res[r].device.type == "cpu"
    assert res[0].dtype == torch.float64
    assert res[0].tolist() == [0.0, 10.0, 20.0, 30.0]
    assert res[1].dtype == torch.int64 and res[1].tolist() == [12345 + 2]


BIGMSG_C = r'''
#include <stdio.h>
#include <stdlib.h>
#include "zompi_mpi.h"
#define N (1 << 19)
int main(int argc, char **argv) {
  int rank, size, i, n;
  if (MPI_Init(&argc, &argv) != MPI_SUCCESS) return 2;
  MPI_Comm_rank(MPI_COMM_WORLD, &rank);
  MPI_Comm_size(MPI_COMM_WORLD, &size);
  double *buf = malloc(N * sizeof(double));
  MPI_Status st;
  MPI_Recv(buf, N, MPI_DOUBLE, 0, 7, MPI_COMM_WORLD, &st);
  MPI_Get_count(&st, MPI_DOUBLE, &n);
  if (n != N) { fprintf(stderr, "short recv %d\n", n); return 3; }
  for (i = 0; i < N; i++) {
    if (buf[i] != (double)(i % 1000)) { fprintf(stderr, "bad %d\n", i); return 4; }
    buf[i] += 1.0;
  }
  MPI_Send(buf, N, MPI_DOUBLE, 0, 8, MPI_COMM_WORLD);
  MPI_Barrier(MPI_COMM_WORLD);
  printf("bigmsg rank %d/%d OK\n", rank, size);
  free(buf);
  MPI_Finalize();
  return 0;
}
'''


def test_rendezvous_4mib_between_a_port_rank_and_a_c_rank(cbin):
    """4 MiB of float64, four times the 1 MiB eager limit: port to C
    through the C rank's CTS, and back through the shim's RTS."""
    payload = torch.arange(1 << 19, dtype=torch.float64) % 1000

    def prog(proc):
        proc.send(payload, dest=1, tag=7)
        got = proc.recv(source=1, tag=8)
        proc.barrier()
        return got

    out, res = _with_port_ranks(cbin("bigmsg.c", BIGMSG_C), 2, (0,), prog,
                                c_rank=1)
    assert "bigmsg rank 1/2 OK" in out
    assert isinstance(res[0], torch.Tensor) and res[0].shape == (1 << 19,)
    assert torch.equal(res[0], payload + 1.0)


DTINTEROP_C = r'''
#include <stdio.h>
#include <string.h>
#include "zompi_mpi.h"
struct rec { double x; int id; };
int main(int argc, char **argv) {
  if (MPI_Init(&argc, &argv) != MPI_SUCCESS) return 2;
  MPI_Datatype hv;
  if (MPI_Type_vector(4, 1, 2, MPI_DOUBLE, &hv) != MPI_SUCCESS) return 3;
  MPI_Type_commit(&hv);
  double buf[8];
  for (int i = 0; i < 8; i++) buf[i] = i * 1.5;
  if (MPI_Send(buf, 1, hv, 0, 11, MPI_COMM_WORLD) != MPI_SUCCESS) return 4;
  struct rec r2[2];
  memset(r2, 0, sizeof r2);
  r2[0].x = 2.5; r2[0].id = 7;
  r2[1].x = -4.25; r2[1].id = 9;
  int bl[2] = {1, 1};
  MPI_Aint dp[2], base, a;
  MPI_Get_address(&r2[0], &base);
  MPI_Get_address(&r2[0].x, &a); dp[0] = a - base;
  MPI_Get_address(&r2[0].id, &a); dp[1] = a - base;
  MPI_Datatype fields[2] = {MPI_DOUBLE, MPI_INT}, st_t, rec_t;
  MPI_Type_create_struct(2, bl, dp, fields, &st_t);
  MPI_Type_create_resized(st_t, 0, sizeof(struct rec), &rec_t);
  MPI_Type_commit(&rec_t);
  if (MPI_Send(r2, 2, rec_t, 0, 12, MPI_COMM_WORLD) != MPI_SUCCESS) return 5;
  double landing[8];
  for (int i = 0; i < 8; i++) landing[i] = -1.0;
  MPI_Status st;
  if (MPI_Recv(landing, 1, hv, 0, 13, MPI_COMM_WORLD, &st) != MPI_SUCCESS)
    return 6;
  for (int i = 0; i < 4; i++) {
    if (landing[2 * i] != 100.0 + i) return 7;
    if (landing[2 * i + 1] != -1.0) return 8;
  }
  MPI_Type_free(&hv);
  MPI_Type_free(&st_t);
  MPI_Type_free(&rec_t);
  MPI_Barrier(MPI_COMM_WORLD);
  printf("dtinterop OK\n");
  MPI_Finalize();
  return 0;
}
'''


def test_derived_types_across_the_planes(cbin):
    """A C strided vector arrives packed (element-sealed, float64), a C
    struct byte-flattened (uint8); port float64 elements land in the C
    rank's strided layout."""
    def prog(proc):
        hv = proc.recv(source=1, tag=11)
        raw = proc.recv(source=1, tag=12)
        proc.send(torch.arange(4, dtype=torch.float64) + 100.0, dest=1,
                  tag=13)
        proc.barrier()
        return hv, raw

    out, res = _with_port_ranks(cbin("dtinterop.c", DTINTEROP_C), 2, (0,),
                                prog, c_rank=1)
    assert "dtinterop OK" in out
    hv, raw = res[0]
    assert hv.dtype == torch.float64 and hv.tolist() == [0.0, 3.0, 6.0, 9.0]
    assert raw.dtype == torch.uint8 and raw.numel() == 2 * 12
    rec = np.frombuffer(raw.numpy().tobytes(),
                        dtype=[("x", "<f8"), ("id", "<i4")])
    assert rec["x"].tolist() == [2.5, -4.25] and rec["id"].tolist() == [7, 9]


# the port ranks of the feed job: rank 1 sends the rows, every port rank
# takes its block of the C rank's Scatterv, sends one float32 per row
# (its mean) through the Gatherv and reads the Bcast mean
FEED_PORT = """
    import json

    import numpy as np
    import torch

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.native.cwire import CWorld

    ROWS, L = 8, 6
    ep = zmpi.host_init(timeout=60)
    w = CWorld(ep)
    if ep.rank == 1:
        ep.send(np.arange(ROWS * L, dtype=np.int64).reshape(ROWS, L),
                dest=0, tag=23)
    mine = w.scatterv(0, timeout=60)
    rows = mine.reshape(-1, L)
    w.gatherv(rows.float().mean(1), 0)
    mean = w.bcast(None, 0, timeout=60)
    ep.barrier()
    print("PORT " + json.dumps({
        "rank": ep.rank, "first": rows[:, 0].tolist(),
        "tensor": isinstance(mine, torch.Tensor), "dtype": str(mine.dtype),
        "mean": float(mean.reshape(-1)[0])}), flush=True)
    zmpi.host_finalize()
"""


def _feed_lines(text):
    import json

    feed, ports = None, {}
    for line in text.splitlines():
        tail = line.split("] ", 1)[-1]
        if tail.startswith("FEED "):
            feed = json.loads(tail[5:])
        elif tail.startswith("PORT "):
            rec = json.loads(tail[5:])
            ports[rec["rank"]] = rec
    return feed, ports


def _check_feed(feed, ports, n_port):
    row_means = [6 * i + 2.5 for i in range(8)]
    assert feed["size"] == n_port + 1 and feed["row_ce"] == row_means
    assert feed["mean_ce"] == pytest.approx(23.5)
    per = 8 // n_port
    assert sorted(ports) == list(range(1, n_port + 1))
    for r, rec in ports.items():
        assert rec["tensor"] and rec["dtype"] == "torch.int64"
        assert rec["first"] == [6 * ((r - 1) * per + i) for i in range(per)]
        assert rec["mean"] == pytest.approx(23.5)


def test_mpmd_c_rank_and_port_ranks_under_the_port_zmpirun(cbin, tmp_path):
    feed = cbin("feed_c.c", open(os.path.join(
        REPO, "zhpe_ompi_tpu_torch", "native", "feed_c.c")).read())
    prog = script(tmp_path, FEED_PORT)
    res = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.mpirun",
         "--timeout", "120", "-n", "1", feed, "8", "6", ":", "-n", "2",
         prog], capture_output=True, text=True, timeout=180, env=ENV)
    assert res.returncode == 0, (res.stdout, res.stderr)
    _check_feed(*_feed_lines(res.stdout), n_port=2)


def test_zmpicc_builds_ring_c_and_the_port_launcher_runs_it(shim, tmp_path):
    show = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.zmpicc",
         "--showme"], capture_output=True, text=True, timeout=120, env=ENV)
    assert show.returncode == 0, show.stderr
    flags = show.stdout.split()
    libdir = os.path.dirname(shim)
    assert flags[0] == "gcc" and tnative.mpi_header_dir() in flags
    assert f"-Wl,-rpath,{libdir}" in flags
    assert f"-l{os.path.basename(shim)[3:-3]}" in flags
    assert subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.zmpicc",
         "--showme:compile"], capture_output=True, text=True, timeout=60,
        env=ENV).stdout.split() == ["-I", tnative.mpi_header_dir()]
    binary = str(tmp_path / "ring")
    res = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.zmpicc",
         os.path.join(REPO, "examples", "ring_c.c"), "-o", binary],
        capture_output=True, text=True, timeout=180, env=ENV)
    assert res.returncode == 0, res.stderr
    run = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.mpirun",
         "--timeout", "120", "-n", "3", binary],
        capture_output=True, text=True, timeout=180, env=ENV)
    assert run.returncode == 0, run.stderr
    for r in range(3):
        assert f"ring_c rank {r}/3 OK" in run.stdout


def test_c_ranks_modexed_through_a_port_dvm(cbin, tmp_path):
    """The store verbs: a 3-rank C ring launched into the port's daemon,
    then the feed job's MPMD form (1 C rank, 2 port ranks) through it
    with ``zmpirun --dvm``."""
    ring = cbin("ring_c.c")
    feed = cbin("feed_c.c", open(os.path.join(
        REPO, "zhpe_ompi_tpu_torch", "native", "feed_c.c")).read())
    prog = script(tmp_path, FEED_PORT)
    d = tdvm.Dvm()
    try:
        cli = tdvm.DvmClient(d.address)
        try:
            out, err = io.StringIO(), io.StringIO()
            rc = cli.launch(3, [ring], timeout=120.0, stdout=out, stderr=err)
            assert rc == 0, (out.getvalue(), err.getvalue())
            assert out.getvalue().count("OK") == 3
        finally:
            cli.close()
        res = subprocess.run(
            [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.mpirun",
             "--dvm", "%s:%d" % tuple(d.address), "--timeout", "120",
             "-n", "1", feed, "8", "6", ":", "-n", "2", prog],
            capture_output=True, text=True, timeout=180, env=ENV)
        assert res.returncode == 0, (res.stdout, res.stderr)
        _check_feed(*_feed_lines(res.stdout), n_port=2)
    finally:
        d.stop()


def test_c_plane_rings_are_unlinked_at_finalize(cbin):
    """ring_c over the C plane's shared-memory rings (sm on, the rings
    named by the session tag): after MPI_Finalize none of the job's rings
    is left in the segment directory."""
    ring = cbin("ring_c.c")
    port = _free_port()
    session = f"cabi{port}"
    procs = [subprocess.Popen([ring], env={**_env(r, 3, port),
                                           "ZMPI_SESSION": session},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(3)]
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"rank {r} failed: {err}\n{out}"
        assert f"ring_c rank {r}/3 OK" in out
    left = [f for f in os.listdir(tsm.segment_dir())
            if f.startswith(f"zompi_ring_{session}_")]
    assert left == []


EXAMPLES = [("ring_c.c", 3, [], "ring_c rank {r}/{n} OK"),
            ("halo_c.c", 4, [], "halo_c rank {r}/{n} OK"),
            ("oshmem_c.c", 4, [], "oshmem_c PE {r}/{n} OK"),
            ("spawn_c.c", 2, ["self"], "spawn_c rank {r}/{n} OK")]


@pytest.mark.parametrize("example", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_pure_c_examples_on_the_port_shim(cbin, example):
    name, n, extra, want = example
    binpath = cbin(name)
    args = [binpath if a == "self" else a for a in extra]
    port = _free_port()
    procs = [subprocess.Popen([binpath, *args], env=_env(r, n, port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"rank {r} failed: {err}\n{out}"
        assert want.format(r=r, n=n) in out
