"""The port's ``runtime/init.host_init`` (with ``host_world`` and
``host_finalize``): the ``ZMPI_*`` coordinator contract.

- Two CPU subprocesses, each with ``ZMPI_RANK``/``ZMPI_SIZE``/
  ``ZMPI_COORD_HOST``/``ZMPI_COORD_PORT`` and ``ZMPI_COORD_EXTERNAL=1``,
  call ``zmpi.host_init()`` and run a barrier, an allreduce, an alltoall
  and a rendezvous-size message over the host plane: once with
  ``ZMPI_MCA_sm=0`` (all over TCP), once with ``ZMPI_MCA_sm`` unset (the
  default: the shared-memory rings carry the data, the wire only the
  modex).  The test itself hosts the rendezvous (the launcher's role
  under ``ZMPI_COORD_EXTERNAL``), so no port number is guessed.
- In process, a one-rank job: ``host_init`` is idempotent, ``host_world``
  returns its proc and ``host_finalize`` closes it.
- A bad contract raises ``NotInitializedError`` in both packages, a
  malformed ``ZMPI_PMIX`` too, with the namesake's message; a well-formed
  one modexes a one-rank job through a PMIx store (``runtime/pmix.py``)
  and warms the tuned-table cache from it; ``ZMPI_FT=1`` builds an ft
  endpoint (one rank agrees and shrinks).  The daemon-hosted paths
  (``ZMPI_LIFELINE``, ``ZMPI_REJOIN``, ``ZMPI_ELASTIC_LIVE``) run in real
  rank processes in ``tests/test_torch_dvm_tree.py`` and
  ``tests/test_torch_ulfm.py``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.runtime import init as jinit
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.utils import dss

ROOT = Path(__file__).resolve().parents[1]

CHILD = textwrap.dedent("""
    import json
    import numpy as np
    import torch
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.runtime import spc

    p = zmpi.host_init(timeout=30.0)
    assert zmpi.host_init() is p and zmpi.host_world() is p
    r = p.rank
    p.barrier()
    total = p.allreduce(torch.arange(4, dtype=torch.int64) * (r + 1), zmpi.SUM)
    got = p.alltoall([torch.tensor([10 * r + d]) for d in range(p.size)])
    big = torch.arange(300_000, dtype=torch.float32) + r  # 1.2 MB: rendezvous
    p.send(big, 1 - r, tag=4)
    other = p.recv(1 - r, tag=4, timeout=30.0)
    sm_on = p._sm_seg is not None
    zmpi.host_finalize()
    print(json.dumps({"rank": r, "size": p.size, "total": total.tolist(),
                      "got": [int(x) for x in got],
                      "other": float(other[1]), "world": zmpi.host_world(),
                      "sm": sm_on, "sm_bytes": spc.read("sm_bytes_sent"),
                      "tcp_bytes": spc.read("tcp_bytes_sent")}))
""")


def _host_rendezvous(srv, size):
    """The launcher-hosted coordinator: gather every rank's card, hand
    back the book (the modex of ``pt2pt/tcp``)."""
    book, conns = [None] * size, []
    for _ in range(size):
        conn, _ = srv.accept()
        rank, card = dss.unpack(ttcp._recv_frame(conn))
        book[rank] = card
        conns.append(conn)
    for conn in conns:
        ttcp._send_frame(conn, dss.pack(book))
        conn.close()


def _two_ranks(**env_extra):
    """Run CHILD as ranks 0 and 1 (``ZMPI_MCA_sm`` removed from the
    environment, then ``env_extra`` added); their JSON results."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    srv.settimeout(60.0)
    host, port = srv.getsockname()
    env = dict(os.environ, PYTHONPATH=str(ROOT), ZMPI_SIZE="2",
               ZMPI_COORD_HOST=host, ZMPI_COORD_PORT=str(port),
               ZMPI_COORD_EXTERNAL="1")
    for k in ("ZMPI_PMIX", "ZMPI_MCA_sm"):
        env.pop(k, None)
    env.update(env_extra)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD],
                              env=dict(env, ZMPI_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        _host_rendezvous(srv, 2)
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        srv.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        res.append(json.loads(out.strip().splitlines()[-1]))
    for r, got in enumerate(res):
        assert {k: got[k] for k in ("rank", "size", "total", "got", "other", "world")} == \
            {"rank": r, "size": 2, "total": [0, 3, 6, 9], "got": [r, 10 + r],
             "other": float(2 - r), "world": None}
    return res


def test_two_processes_through_the_env_contract():
    for got in _two_ranks(ZMPI_MCA_sm="0"):
        assert got["sm"] is False and got["sm_bytes"] == 0
        assert got["tcp_bytes"] > 1_200_000  # the rendezvous message


def test_two_processes_with_sm_at_its_default():
    """``ZMPI_MCA_sm`` unset: each rank builds its segment, and every
    data frame (the 1.2 MB message included) rides the rings."""
    for got in _two_ranks():
        assert got["sm"] is True and got["sm_bytes"] > 1_200_000
        assert got["tcp_bytes"] < 1024  # the modex frames only


def test_one_rank_in_process(monkeypatch):
    monkeypatch.setenv("ZMPI_RANK", "0")
    monkeypatch.setenv("ZMPI_SIZE", "1")
    monkeypatch.setenv("ZMPI_COORD_HOST", "127.0.0.1")
    monkeypatch.setenv("ZMPI_COORD_PORT", "0")
    monkeypatch.delenv("ZMPI_PMIX", raising=False)
    monkeypatch.delenv("ZMPI_FT", raising=False)
    assert zmpi.host_world() is None
    p = zmpi.host_init(timeout=10.0)
    try:
        assert zmpi.host_init() is p and zmpi.host_world() is p
        assert (p.rank, p.size) == (0, 1)
        assert p.allreduce(7, zmpi.SUM) == 7
    finally:
        zmpi.host_finalize()
    assert zmpi.host_world() is None and p._closed.is_set()


@pytest.mark.parametrize("env", [{}, {"ZMPI_RANK": "0"},
                                 {"ZMPI_RANK": "x", "ZMPI_SIZE": "2",
                                  "ZMPI_COORD_HOST": "h", "ZMPI_COORD_PORT": "1"}])
def test_bad_contract_raises_not_initialized_in_both(monkeypatch, env):
    for k in ("ZMPI_RANK", "ZMPI_SIZE", "ZMPI_COORD_HOST", "ZMPI_COORD_PORT",
              "ZMPI_PMIX", "ZMPI_FT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(errors.NotInitializedError, match="ZMPI_"):
        zmpi.host_init()
    with pytest.raises(jerrors.NotInitializedError, match="ZMPI_"):
        jinit.host_init()
    assert zmpi.host_world() is None and jinit.host_world() is None


def test_pmix_and_ft_wait_for_their_modules(monkeypatch):
    """``ZMPI_PMIX=host:port/namespace``: a one-rank job modexes through
    the store (``runtime/pmix.py``: one card put, one get) and warms the
    tuned-table cache from it; a malformed URI raises the namesake's
    ``NotInitializedError``.  ``ZMPI_FT=1`` builds an ft endpoint."""
    from zhpe_ompi_tpu_torch.coll import ztable
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
    from zhpe_ompi_tpu_torch.runtime import spc

    for k in ("ZMPI_COORD_HOST", "ZMPI_COORD_PORT", "ZMPI_LIFELINE",
              "ZMPI_REJOIN", "ZMPI_ELASTIC_LIVE", "ZMPI_METRICS",
              "ZMPI_TRACE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ZMPI_RANK", "0")
    monkeypatch.setenv("ZMPI_SIZE", "1")
    for bad in ("127.0.0.1:1", "nohost/job"):
        monkeypatch.setenv("ZMPI_PMIX", bad)
        with pytest.raises(errors.NotInitializedError) as port:
            zmpi.host_init()
        with pytest.raises(jerrors.NotInitializedError) as ref:
            jinit.host_init()
        assert str(port.value) == str(ref.value)
        assert "malformed ZMPI_PMIX" in str(port.value)
    assert zmpi.host_world() is None
    srv = tpmix.PmixServer()
    try:
        tpmix.publish_tuned_table(srv.store, "allreduce 0 0 ring\n")
        monkeypatch.setenv("ZMPI_PMIX", f"127.0.0.1:{srv.address[1]}/job")
        monkeypatch.setenv("ZMPI_FT", "1")
        ztable.invalidate_cache()
        puts0, gets0 = spc.read("pmix_puts"), spc.read("pmix_gets")
        fetches0 = spc.read("tuned_table_store_fetches")
        p = zmpi.host_init(timeout=10.0)
        try:
            assert zmpi.host_init() is p and (p.rank, p.size) == (0, 1)
            assert p.ft_state is not None and p.ft_state.live() == [0]
            assert p.agree(True) is True and p.shrink().size == 1
            assert spc.read("pmix_puts") - puts0 == 1
            assert spc.read("pmix_gets") - gets0 == 1
            assert srv.store.get("job", "card:0")[:2] == list(p.address)
            assert spc.read("tuned_table_store_fetches") - fetches0 == 1
            assert ztable.resolve_rule("allreduce", 4, 64) == "ring"
        finally:
            zmpi.host_finalize()
            ztable.invalidate_cache()
        assert srv.store.destroy_ns("job")
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
    finally:
        srv.close()
    # ft/ulfm.py through the coordinator contract: ZMPI_FT=1 builds an
    # ft endpoint
    monkeypatch.delenv("ZMPI_PMIX")
    monkeypatch.setenv("ZMPI_COORD_HOST", "127.0.0.1")
    monkeypatch.setenv("ZMPI_COORD_PORT", "0")
    p = zmpi.host_init(timeout=10.0)
    try:
        assert p.ft_state is not None and p.ft_state.live() == [0]
        assert p.agree(True) is True and p.shrink().size == 1
    finally:
        zmpi.host_finalize()
    assert zmpi.host_world() is None


FT_CHILD = textwrap.dedent("""
    import json, os, signal
    import numpy as np
    import torch
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import host as coll_host
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.ft import recovery, ulfm
    from zhpe_ompi_tpu_torch.ft.inject import FaultPlan
    from zhpe_ompi_tpu_torch.pt2pt import sm

    victim = int(os.environ["TEST_VICTIM"])
    p = zmpi.host_init(timeout=30.0)
    p.set_errhandler(errh.ERRORS_RETURN)
    r = p.rank
    x = torch.arange(70_000, dtype=torch.int64) * (r + 1) - r  # the ring
    p.barrier()
    inj = FaultPlan(seed=7).kill_rank(victim, after_ops=1).arm(p)
    kind = "completed"
    try:
        inj.allreduce(x, zmpi.SUM)
    except ulfm.RankKilled:
        os.kill(os.getpid(), signal.SIGKILL)  # a real crash: no cleanup
    except errors.ProcFailed:
        kind = "failed"
        p.revoke(coll_host.COLL_CID)
    except errors.Revoked:
        kind = "revoked"
    assert p.ft_state.wait_failed(victim, timeout=20.0)
    cause = p.ft_state.cause_of(victim)
    p.failure_ack()
    failed, gen = recovery.agree_failed_set(p)
    sh = p.shrink()
    total = sh.allreduce(x, zmpi.SUM)
    sm_on = p._sm_seg is not None
    zmpi.host_finalize()
    print(json.dumps({"rank": r, "kind": kind, "cause": cause,
                      "failed": sorted(failed.items()), "gen": gen,
                      "shrunk": [sh.rank, sh.size, list(sh.group.ranks)],
                      "total": total[:3].tolist() + [int(total.sum())],
                      "sm": sm_on, "rings": sm.orphaned_ring_files(),
                      "polls": sm.live_poll_threads(),
                      "detectors": len(ulfm.live_detectors())}))
""")


@pytest.mark.parametrize("sm_env", [{}, {"ZMPI_MCA_sm": "0"}],
                         ids=["sm-default", "sm-off"])
def test_four_processes_under_zmpi_ft_survive_a_kill(tmp_path, sm_env):
    """``ZMPI_FT=1`` with four children through the coordinator contract:
    rank 3 is killed (severed, then SIGKILL) inside a ring allreduce; the
    survivors classify it through the sm death listener or the transport,
    ack, agree on the failed set, shrink to 3 and reduce exactly.  The
    victim's ring files are the launcher's to sweep (``ZMPI_SESSION``);
    the survivors leave none, and no poll or detector thread."""
    import glob

    import numpy as np

    from zhpe_ompi_tpu_torch.pt2pt import sm as tsm

    n, victim = 4, 3
    session = f"fttest{os.getpid()}"
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n + 2)
    srv.settimeout(60.0)
    host, port = srv.getsockname()
    env = dict(os.environ, PYTHONPATH=str(ROOT), ZMPI_SIZE=str(n),
               ZMPI_COORD_HOST=host, ZMPI_COORD_PORT=str(port),
               ZMPI_COORD_EXTERNAL="1", ZMPI_FT="1", ZMPI_SESSION=session,
               TEST_VICTIM=str(victim))
    for k in ("ZMPI_PMIX", "ZMPI_MCA_sm"):
        env.pop(k, None)
    env.update(sm_env)
    procs = [subprocess.Popen([sys.executable, "-c", FT_CHILD],
                              env=dict(env, ZMPI_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    try:
        _host_rendezvous(srv, n)
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        srv.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
    pattern = os.path.join(tsm.segment_dir(), f"zompi_pyring_{session}_*")
    leftovers = glob.glob(pattern)
    for path in leftovers:  # the launcher's sweep of the victim's files
        os.unlink(path)
    assert procs[victim].returncode == -9
    res = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if r != victim:
            assert p.returncode == 0, err[-2000:]
            res.append(json.loads(out.strip().splitlines()[-1]))
    want = sum(np.arange(70_000, dtype=np.int64) * (r + 1) - r
               for r in range(n) if r != victim)
    for k, got in enumerate(res):
        assert got["kind"] in ("failed", "revoked")
        assert got["cause"] in ("transport", "notice", "detector")
        assert [f[0] for f in got["failed"]] == [victim]
        assert got["shrunk"] == [k, 3, [0, 1, 2]]
        assert got["total"] == want[:3].tolist() + [int(want.sum())]
        assert got["rings"] == [] and got["polls"] == []
        assert got["detectors"] == 0
        assert got["sm"] is (sm_env == {})
    assert len({(tuple(map(tuple, g["failed"])), g["gen"]) for g in res}) == 1
    assert any(g["kind"] == "failed" for g in res)
    # only the killed rank's files were left for the sweep
    assert all(f"_{victim}_" in os.path.basename(p) for p in leftovers)
    assert (leftovers != []) is (sm_env == {})
