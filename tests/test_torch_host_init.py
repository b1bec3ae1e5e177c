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
- A bad contract raises ``NotInitializedError`` in both packages;
  ``ZMPI_PMIX`` raises ``UnsupportedError`` naming ``runtime/pmix.py`` and
  ``ZMPI_FT=1`` naming ``ft/ulfm.py``.
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
    monkeypatch.setenv("ZMPI_RANK", "0")
    monkeypatch.setenv("ZMPI_SIZE", "1")
    monkeypatch.setenv("ZMPI_PMIX", "127.0.0.1:1/job")
    with pytest.raises(errors.UnsupportedError, match="runtime/pmix.py"):
        zmpi.host_init()
    monkeypatch.delenv("ZMPI_PMIX")
    monkeypatch.setenv("ZMPI_FT", "1")
    with pytest.raises(errors.UnsupportedError, match="ft/ulfm.py"):
        zmpi.host_init()
    assert zmpi.host_world() is None
