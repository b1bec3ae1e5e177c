"""The port's PMPI interposition point and MPI_T surface against the JAX
package's (``tools/pmpi.py``, ``tools/mpit.py``; the state pvars of
``pt2pt/universe.py`` and ``pt2pt/tcp.py``; the metrics snapshot's
``pvars`` table of ``runtime/spc.py``).

- pmpi: one interceptor chain run through both packages' ``dispatch``
  gives the same call order (the last attached runs outermost), and the
  port's ``Communicator`` dispatches through it only when an interceptor
  is attached.
- mpit: the same counter sequence read through both packages' sessions
  gives the same deltas (reset rebases included); discovery enumerates
  the documented table; the four state pvars are registered once; a
  remote session reads a port rank's published snapshot through a port
  ``Dvm``; the metrics snapshot carries the state pvars.
"""

import threading
import types

import pytest
import torch
import torch.distributed as dist

from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from test_torch_metrics_plane import run_metrics_job
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.pt2pt import universe as juniverse
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu.tools import mpit as jmpit
from zhpe_ompi_tpu.tools import pmpi as jpmpi
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.pt2pt import universe as tuniverse
from zhpe_ompi_tpu_torch.runtime import dvm as tdvm
from zhpe_ompi_tpu_torch.runtime import spc as tspc
from zhpe_ompi_tpu_torch.tools import mpit as tmpit
from zhpe_ompi_tpu_torch.tools import pmpi as tpmpi

JAX = types.SimpleNamespace(name="jax", pmpi=jpmpi, mpit=jmpit, spc=jspc,
                            var=jvar, errors=jerrors, universe=juniverse)
PORT = types.SimpleNamespace(name="port", pmpi=tpmpi, mpit=tmpit, spc=tspc,
                             var=tvar, errors=terrors, universe=tuniverse)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])

STATE_PVARS = ("pt2pt_posted_recvs", "pt2pt_unexpected_msgs",
               "tcp_posted_recvs", "tcp_unexpected_msgs")


# ================================== pmpi ====================================


def _chain_log(P):
    """Two interceptors around one call through ``P.pmpi.dispatch``: the
    order of their enter/exit records and the result."""
    log = []

    def layer(tag):
        def interceptor(opname, comm, args, kwargs, call_next):
            log.append(f"{tag}>{opname}")
            out = call_next()
            log.append(f"{tag}<{out}")
            return out + 1
        return interceptor

    inner, outer = layer("inner"), layer("outer")
    P.pmpi.attach(inner)
    P.pmpi.attach(outer)
    try:
        assert P.pmpi.active()
        out = P.pmpi.dispatch("allreduce", "comm",
                              lambda comm, x, k=0: log.append(comm) or x + k,
                              (10,), {"k": 5})
    finally:
        P.pmpi.detach(outer)
        P.pmpi.detach(inner)
    assert not P.pmpi.active()
    return log, out


def test_interceptor_order_matches_the_namesake():
    log, out = _chain_log(PORT)
    assert (log, out) == _chain_log(JAX)
    assert log[:2] == ["outer>allreduce", "inner>allreduce"]
    assert out == 17


@pytest.fixture
def one_rank_comm(tmp_path, monkeypatch):
    import zhpe_ompi_tpu_torch as zmpi

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield zmpi.Communicator(name="pmpi")
    finally:
        dist.destroy_process_group()


def test_communicator_dispatches_through_pmpi_only_when_attached(
        one_rank_comm, monkeypatch):
    comm = one_rank_comm
    calls = []

    def refuse(*a, **k):
        raise AssertionError("pmpi.dispatch ran with no interceptor")

    monkeypatch.setattr(tpmpi, "dispatch", refuse)
    assert torch.equal(comm.allreduce(torch.ones(4)), torch.ones(4))
    monkeypatch.undo()

    def counter(opname, c, args, kwargs, call_next):
        calls.append((opname, c is comm))
        return call_next()

    tpmpi.attach(counter)
    try:
        assert torch.equal(comm.allreduce(torch.ones(3)), torch.ones(3))
        comm.bcast(torch.ones(2), root=0)
        comm.barrier()
    finally:
        tpmpi.detach(counter)
    assert calls == [("allreduce", True), ("bcast", True),
                     ("barrier", True)]


# ================================== mpit ====================================


def _session_sequence(P):
    """One counter story read through two sessions: isolation, a reset
    under an open handle, a rebase."""
    P.spc.record("mpit_port_probe", 10)
    s1, s2 = P.mpit.PvarSession(), P.mpit.PvarSession()
    h1 = s1.handle_alloc("spc_mpit_port_probe")
    h1.start()
    P.spc.record("mpit_port_probe", 3)
    h2 = s2.handle_alloc("spc_mpit_port_probe")
    h2.start()
    P.spc.record("mpit_port_probe", 4)
    seen = [h1.read(), h2.read(), h1.klass]
    h2.reset()
    P.spc.record("mpit_port_probe", 1)
    seen += [h1.read(), h2.read()]
    P.spc.reset()
    P.spc.record("mpit_port_probe", 2)
    seen += [h1.read(), h2.read()]
    with pytest.raises(P.errors.ArgError):
        s1.handle_alloc("spc_no_such_pvar_xyz")
    s1.free()
    s2.free()
    return seen


def test_session_deltas_match_the_namesake():
    got = _session_sequence(PORT)
    assert got == _session_sequence(JAX)
    assert got == [7, 4, "counter", 8, 1, 2, 2]


@BOTH
def test_discovery_enumerates_the_documented_table(P):
    names = set(P.mpit.pvar_names())
    assert {f"spc_{c}" for c in P.spc.documented_counters()} <= names
    before = P.mpit.pvar_get_num()
    P.spc.record("tcp_bytes_sent", 5)  # a documented counter firing
    assert P.mpit.pvar_get_num() == before
    wm = P.mpit.pvar_defs()["spc_match_unexpected_max_depth"]
    assert wm.klass == P.mpit.PVAR_WATERMARK


def test_documented_pvar_classes_agree_with_the_namesake():
    shared = tspc.documented_counters() & jspc.documented_counters()
    tdefs, jdefs = tmpit.pvar_defs(), jmpit.pvar_defs()
    assert len(shared) > 50
    for c in shared:
        assert tdefs[f"spc_{c}"].klass == jdefs[f"spc_{c}"].klass, c
        assert tmpit._pvar_category(f"spc_{c}") == \
            jmpit._pvar_category(f"spc_{c}"), c


def test_state_pvars_register_once_and_read_live():
    unis = [tuniverse.LocalUniverse(2) for _ in range(2)]
    try:
        defs = tmpit.registered_pvars()
        assert {"pt2pt_posted_recvs", "pt2pt_unexpected_msgs"} <= set(defs)
        assert tuniverse._pvars_registered
        s = tmpit.PvarSession()
        h = s.handle_alloc("pt2pt_posted_recvs")
        base = h.read()

        def main(ctx):
            if ctx.rank == 1:
                req = ctx.irecv(source=0, tag=9)
                ctx.send(b"posted", dest=0, tag=8)
                return req.wait()
            ctx.recv(source=1, tag=8)  # rank 1's receive is posted
            depth = h.read()
            ctx.send(b"x", dest=1, tag=9)
            return depth

        depth, got = unis[0].run(main)
        assert depth == base + 1 and got == b"x"
        assert h.read() == base
        s.free()
    finally:
        for u in unis:
            u.close()
    # a TcpProc job registers the wire twins, once, beside them
    n = 2
    procs = [None] * n
    coord, ready = [], threading.Event()

    def rank_main(r):
        if r == 0:
            procs[0] = ttcp.TcpProc(0, n, coordinator=("127.0.0.1", 0), sm=False,
                                    on_coordinator_bound=lambda a: (
                                        coord.append(a), ready.set()))
        else:
            assert ready.wait(30)
            procs[r] = ttcp.TcpProc(r, n, coordinator=tuple(coord[0]), sm=False)

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    try:
        assert ttcp._wire_pvars_registered
        assert tmpit.registered_pvars()["tcp_posted_recvs"].reader() == 0
    finally:
        for p in procs:
            p.close()
    names = [n for n in tmpit.pvar_names() if n in STATE_PVARS]
    assert sorted(names) == sorted(STATE_PVARS)


def test_metrics_snapshot_carries_the_state_pvars():
    d = tdvm.Dvm()
    try:
        run_metrics_job(d, n=2, ns="jobpvars")
        for payload in d.store.lookup("jobpvars", "metrics:").values():
            assert {"tcp_posted_recvs", "tcp_unexpected_msgs"} <= \
                set(payload["pvars"])
            assert all(isinstance(v, int) for v in payload["pvars"].values())
        d.store.destroy_ns("jobpvars")
    finally:
        d.stop()


def test_a_raising_state_reader_skips_its_row_only():
    def boom():
        raise RuntimeError("torn-down state")

    tmpit.register_pvar("zz_test_raising_pvar", boom)
    tmpit.register_pvar("zz_test_live_pvar", lambda: 7)
    try:
        pub = tspc.MetricsPublisher.__new__(tspc.MetricsPublisher)
        pub._seq_lock, pub._seq, pub.interval = threading.Lock(), 0, 1.0
        payload = pub._snapshot_payload(final=False)
        assert payload["pvars"]["zz_test_live_pvar"] == 7
        assert "zz_test_raising_pvar" not in payload["pvars"]
    finally:
        with tmpit._pvar_lock:
            tmpit._pvars.pop("zz_test_raising_pvar")
            tmpit._pvars.pop("zz_test_live_pvar")


def test_remote_session_reads_a_port_rank_through_a_port_dvm():
    d = tdvm.Dvm()
    try:
        run_metrics_job(d, n=2, ns="jobremote")
        snap = d.store.lookup("jobremote", "metrics:")["metrics:jobremote:1"]
        s = tmpit.PvarSession(remote=(d.address, "jobremote", 1))
        assert s._remote.counter("tcp_bytes_sent") == \
            snap["counters"]["tcp_bytes_sent"] > 0
        h = s.handle_alloc("spc_tcp_bytes_sent")
        h.start()
        assert h.read() == 0  # baseline isolation holds remotely
        st = s.handle_alloc("tcp_posted_recvs")
        assert st.klass == tmpit.PVAR_STATE and st.read() == 0
        assert "spc_sm_bytes_sent" in s._remote.defs()
        s.free()
        d.store.destroy_ns("jobremote")
    finally:
        d.stop()
    with pytest.raises(terrors.MpiError):
        tmpit.PvarSession(remote=(d.address, "jobremote", 0))


@BOTH
def test_cvar_handles_write_through_the_registry(P):
    name = "spc_publish_interval_ms"
    h = P.mpit.CvarHandle(name)
    default = h.read()
    try:
        h.write(default + 500)
        assert P.var.get(name) == default + 500
        assert P.mpit.cvar_get_info(name)["source"] == "API"
        assert name in P.mpit.cvar_names()
    finally:
        P.var.unset(name)
    assert h.read() == default
    with pytest.raises(P.errors.ArgError):
        P.mpit.CvarHandle("no_such_var_xyz")
    cats = P.mpit.category_names()
    assert "spc" in cats and "spc.tcp" in cats
    assert "spc_tcp_bytes_sent" in P.mpit.category_info("spc.tcp")["pvars"]
