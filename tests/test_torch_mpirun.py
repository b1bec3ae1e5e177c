"""The port's ``zmpirun`` (``tools/mpirun.py``) against the namesake's
contract, on real rank processes.

- One 4-rank port job under the port's launcher: the launcher-hosted name
  server (rank 0 publishes an open port, rank 3 looks it up and connects
  to it), ``--mca`` forwarding to every rank, a host-plane allreduce, IOF
  with ``[r]`` tags.
- An abort: rank 3 exits 3 after its ring files exist; the job returns
  rc 3 and the launcher sweeps the session's ring files.
- Mixed launchers, since the ``ZMPI_*`` contract is shared: the port's
  ``zmpirun`` runs JAX-package ranks (through its CLI) and the JAX
  package's runs port ranks, each the same program.
- ``launch_dvm`` into a port ``Dvm``.

Rank processes import torch or jax (~2-3 s each here); the launches run
once per module and the tests read their results.
"""

import glob
import io
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu.tools import mpirun as jmpirun
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.tools import mpirun as tmpirun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one program for both packages: argv = package, mode
PROG = """
import importlib
import json
import os
import socket
import sys

pkg, mode = sys.argv[1], sys.argv[2]
zmpi = importlib.import_module(pkg)
dpm_wire = importlib.import_module(pkg + ".comm.dpm_wire")
ep = zmpi.host_init()
out = {"rank": ep.rank, "size": ep.size, "pkg": pkg,
       "session": os.environ.get("ZMPI_SESSION"),
       "eager": zmpi.mca_var.get("tcp_eager_limit", None),
       "sum": float(ep.allreduce(float(ep.rank + 1), zmpi.SUM))}
if mode == "names":
    if ep.rank == 0:
        port = dpm_wire.open_port()
        dpm_wire.publish_name("zsvc", port.name)
        ep.barrier()
        conn, _ = port._srv.accept()
        out["hello"] = conn.recv(64).decode()
        conn.close()
        port.close()
        ep.barrier()
        dpm_wire.unpublish_name("zsvc")
    else:
        ep.barrier()
        if ep.rank == ep.size - 1:
            name = dpm_wire.lookup_name("zsvc")
            host, port_no = name.rsplit(":", 1)
            with socket.create_connection((host, int(port_no)), 10) as c:
                c.sendall(f"hello from {ep.rank}".encode())
            out["looked_up"] = name
        ep.barrier()
elif mode == "abort":
    ep.barrier()  # every ring file of the session exists
    if ep.rank == ep.size - 1:
        print("RESULT " + json.dumps(out), flush=True)
        os._exit(3)
    ep.recv(source=ep.size - 1, tag=77)  # blocks until torn down
print("RESULT " + json.dumps(out), flush=True)
zmpi.host_finalize()
"""


def _results(text):
    import json

    return sorted((json.loads(line.split("RESULT ", 1)[1])
                   for line in text.splitlines() if "RESULT " in line),
                  key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def prog(tmp_path_factory):
    p = tmp_path_factory.mktemp("zmpirun") / "prog.py"
    p.write_text(f"import sys\nsys.path.insert(0, {REPO!r})\n"
                 + textwrap.dedent(PROG))
    return str(p)


def _launch(launcher, n, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = launcher.launch(n, argv, stdout=out, stderr=err, timeout=120.0, **kw)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def jobs(prog):
    """The module's launches, side by side: each entry is (rc, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    specs = {
        "names": lambda: _launch(tmpirun, 4, [prog, "zhpe_ompi_tpu_torch",
                                              "names"],
                                 mca=[("tcp_eager_limit", "4096")]),
        "abort": lambda: _launch(tmpirun, 4, [prog, "zhpe_ompi_tpu_torch",
                                              "abort"]),
        "jax_launcher_port_ranks": lambda: _launch(
            jmpirun, 2, [prog, "zhpe_ompi_tpu_torch", "plain"]),
        "port_cli_jax_ranks": lambda: (lambda r: (r.returncode, r.stdout,
                                                  r.stderr))(subprocess.run(
            [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.mpirun", "-n",
             "2", "--mca", "tcp_eager_limit", "8192", prog, "zhpe_ompi_tpu",
             "plain"], env=env, capture_output=True, text=True,
            timeout=180)),
    }
    res = {}

    def run(name):
        res[name] = specs[name]()

    threads = [threading.Thread(target=run, args=(k,)) for k in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(240)
        assert not t.is_alive()
    return res


def test_name_server_mca_and_collectives_under_the_port_launcher(jobs):
    rc, out, err = jobs["names"]
    assert rc == 0, err
    rows = _results(out)
    assert [r["rank"] for r in rows] == [0, 1, 2, 3]
    assert all(r["eager"] == 4096 and r["sum"] == 10.0 for r in rows)
    assert rows[0]["hello"] == "hello from 3"
    assert rows[3]["looked_up"].startswith("127.0.0.1:")
    assert all(line.startswith(("[0] ", "[1] ", "[2] ", "[3] "))
               for line in out.splitlines())


def test_abort_returns_the_rank_code_and_sweeps_ring_files(jobs):
    rc, out, err = jobs["abort"]
    assert rc == 3
    assert "rank 3 exited with code 3" in err
    rows = _results(out)
    session = rows[0]["session"]
    assert session
    assert glob.glob(os.path.join(tsm.segment_dir(),
                                  f"zompi_pyring_{session}_*")) == []


def test_each_packages_launcher_runs_the_other_packages_ranks(jobs):
    rc, out, err = jobs["jax_launcher_port_ranks"]
    assert rc == 0, err
    rows = _results(out)
    assert [(r["pkg"], r["sum"]) for r in rows] == \
        [("zhpe_ompi_tpu_torch", 3.0)] * 2
    rc, out, err = jobs["port_cli_jax_ranks"]
    assert rc == 0, err
    rows = _results(out)
    assert [(r["pkg"], r["sum"], r["eager"]) for r in rows] == \
        [("zhpe_ompi_tpu", 3.0, 8192)] * 2


def test_build_env_matches_the_namesakes_contract():
    t = tmpirun.build_env(2, 4, "127.0.0.1", 5555, mca=[("x", "1")],
                          ns_port=6666, ft=True)
    j = jmpirun.build_env(2, 4, "127.0.0.1", 5555, mca=[("x", "1")],
                          ns_port=6666, ft=True)
    keys = ("ZMPI_RANK", "ZMPI_SIZE", "ZMPI_COORD_HOST", "ZMPI_COORD_PORT",
            "ZMPI_COORD_EXTERNAL", "ZMPI_SESSION", "ZMPI_NAMESERVER",
            "ZMPI_FT", "ZMPI_MCA_x")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}


def test_launch_dvm_into_a_port_daemon(prog):
    d = tdvm.Dvm()
    try:
        out, err = io.StringIO(), io.StringIO()
        rc = tmpirun.launch_dvm(d.address, 2,
                                [prog, "zhpe_ompi_tpu_torch", "plain"],
                                stdout=out, stderr=err, timeout=120.0)
        assert rc == 0, err.getvalue()
        assert [r["sum"] for r in _results(out.getvalue())] == [3.0, 3.0]
    finally:
        d.stop()
