"""The port's PMIx-analog store (``runtime/pmix.py``) against the JAX
package's.

- One scripted verb sequence goes to both packages' ``PmixStore``: puts
  before and after a commit, a fence of 4 thread ranks, a get-until-
  published with a late publisher, ``get_meta`` across a
  ``bump_generation``, ``lookup`` prefixes, ``stat``, the error contracts
  and ``destroy_ns``.  Both give the same results, the same error
  messages and the same ``pmix_*`` counter deltas (each package counts in
  its own ``runtime/spc``).
- The same sequence over the wire, in all four client/server pairings:
  a port ``PmixClient`` against a JAX-package ``PmixServer`` and the
  reverse, so the frames (the port's ``utils/dss``) are the namesake's.
  A numpy array stored by one package's client comes back through the
  port's client as a CPU tensor and through the JAX package's as an
  array, equal in value.
- A tuned table published by one package is fetched by the other
  (``publish_tuned_table``/``fetch_tuned_table``), and an unreachable
  store degrades to None in both.
- The hygiene functions (``live_servers``, ``stale_namespaces``,
  ``stale_metric_keys``, ``stale_tuned_tables``) and the address helpers.

Everything is exact.  Each test closes the servers it opened; the module
fixture checks that none of the port's is left listening.
"""

import threading
import time

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.runtime import pmix as jpmix
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.runtime import pmix as tpmix
from zhpe_ompi_tpu_torch.runtime import spc as tspc

PKGS = {"jax": (jpmix, jspc, jerrors), "port": (tpmix, tspc, terrors)}
COUNTERS = ("pmix_puts", "pmix_gets", "pmix_fences")


@pytest.fixture(autouse=True, scope="module")
def _hygiene():
    yield
    assert tpmix.live_servers() == []


def _deltas(spc, before):
    return {c: spc.read(c) - before.get(c, 0) for c in COUNTERS}


def _verb_sequence(store, errors):
    """The scripted verbs: returns every observable result in order."""
    out = []
    store.ensure_ns("job", 4)
    store.ensure_ns("job", 4)  # idempotent
    with pytest.raises(errors.ArgError) as e:
        store.ensure_ns("job", 3)
    out.append(str(e.value))
    store.put("job", 0, "card:0", ["127.0.0.1", 1000, "x"])
    out.append(store.lookup("job"))  # staged: invisible before commit
    out.append(store.commit("job", 0))
    out.append(store.lookup("job"))
    store.put("job", 1, "card:1", ["127.0.0.1", 1001])
    store.put("job", 1, "meta:1", {"a": 1, "b": [2, 3]})
    out.append(store.commit("job", 1))
    # fence of 4 ranks, each its own thread; every rank then reads all
    got = [None] * 4

    def rank(r):
        if r >= 2:
            store.put("job", r, f"card:{r}", ["127.0.0.1", 1000 + r])
            store.commit("job", r)
        store.fence("job", r, timeout=10.0)
        got[r] = [store.get("job", f"card:{p}", timeout=10.0)
                  for p in range(4)]

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20.0)
    out.append(got)
    # get-until-published with a late publisher
    def late():
        time.sleep(0.2)
        store.put("job", 3, "late", 42)
        store.commit("job", 3)

    t = threading.Thread(target=late)
    t.start()
    out.append(store.get("job", "late", timeout=10.0))
    t.join(5.0)
    # generations: a fresh card only after the bump satisfies the floor
    out.append(store.get_meta("job", "card:2", timeout=1.0))
    out.append(store.bump_generation("job"))
    out.append(store.generation("job"))
    with pytest.raises(errors.InternalError) as e:
        store.get_meta("job", "card:2", timeout=0.3, min_generation=1)
    out.append(str(e.value))
    store.put("job", 2, "card:2", ["127.0.0.1", 2002])
    out.append(store.commit("job", 2))
    out.append(store.get_meta("job", "card:2", timeout=1.0,
                              min_generation=1))
    out.append(sorted(store.lookup("job", "card:")))
    out.append(store.lookup("job", "meta:"))
    out.append(store.lookup("nope"))
    out.append(store.stat())
    with pytest.raises(errors.ArgError) as e:
        store.put("nope", 0, "k", 1)
    out.append(str(e.value))
    with pytest.raises(errors.ArgError) as e:
        store.get("nope", "k", timeout=0.1)
    out.append(str(e.value))
    # a fence that cannot complete times out with the entered count
    store.ensure_ns("solo", 2)
    with pytest.raises(errors.InternalError) as e:
        store.fence("solo", 0, timeout=0.3)
    out.append(str(e.value))
    out.append(store.destroy_ns("job"))
    out.append(store.destroy_ns("job"))
    out.append(store.destroy_ns("solo"))
    out.append(store.namespaces())
    return out


def test_store_verbs_match_in_process():
    results, deltas = {}, {}
    for name, (pmix, spc, errors) in PKGS.items():
        before = spc.snapshot()
        store = pmix.PmixStore()
        results[name] = _verb_sequence(store, errors)
        deltas[name] = _deltas(spc, before)
        store.close()
    assert results["port"] == results["jax"]
    assert deltas["port"] == deltas["jax"]
    # 4 fence entries of one epoch, 16 + 1 + 2 + 1 gets
    assert deltas["port"]["pmix_fences"] == 4


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_store_verbs_match_over_the_wire(server_pkg, client_pkg):
    """Every pairing gives the in-process results.  A server error comes
    back as the client's ``InternalError`` wrapping the store's message
    (``pmix <verb>: ...``), so each message is compared with the
    in-process one at its end."""
    spmix, sspc, _ = PKGS[server_pkg]
    cpmix, _, cerrors = PKGS[client_pkg]
    srv = spmix.PmixServer()
    try:
        before = sspc.snapshot()
        wire = _wire_sequence(srv, cpmix, cerrors)
        deltas = _deltas(sspc, before)
    finally:
        srv.close()
    store = spmix.PmixStore()
    local = _verb_sequence(store, PKGS[server_pkg][2])
    store.close()
    assert len(wire) == len(local)
    for w, l in zip(wire, local):
        if isinstance(l, str) and l.startswith("pmix:"):
            assert w.endswith(l), (w, l)
        else:
            assert w == l, (w, l)
    assert deltas["pmix_fences"] == 4 and deltas["pmix_puts"] == 7


def _wire_sequence(srv, cpmix, cerrors):
    """:func:`_verb_sequence` through clients: each thread its own
    connection; server errors arrive as the client's InternalError."""
    made = []

    def client():
        c = cpmix.PmixClient(srv.address, timeout=10.0)
        made.append(c)
        return c

    main = client()

    class Errs:
        ArgError = cerrors.InternalError
        InternalError = cerrors.InternalError

    tls = threading.local()

    class View:
        def __getattr__(self, name):
            if name == "namespaces":
                return srv.store.namespaces
            if threading.current_thread() is threading.main_thread():
                return getattr(main, name)
            if not hasattr(tls, "c"):
                tls.c = client()
            return getattr(tls.c, name)

    try:
        return _verb_sequence(View(), Errs)
    finally:
        for c in made:
            c.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_array_values_cross_the_wire(writer, reader):
    """A numpy array put through one package's client: the port's client
    reads a CPU tensor, the JAX package's an array, equal in value."""
    srv = PKGS["port"][0].PmixServer()
    try:
        w = PKGS[writer][0].PmixClient(srv.address)
        r = PKGS[reader][0].PmixClient(srv.address)
        arr = np.arange(6, dtype=np.float32).reshape(2, 3)
        w.ensure_ns("arr", 1)
        w.put("arr", 0, "x", arr if writer == "jax"
              else torch.from_numpy(arr))
        w.commit("arr", 0)
        got = r.get("arr", "x", timeout=5.0)
        if reader == "port":
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            got = got.numpy()
        else:
            assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, arr)
        assert w.destroy_ns("arr")
        w.close()
        r.close()
    finally:
        srv.close()
    # the in-process store hands back the object that was put
    store = tpmix.PmixStore()
    store.ensure_ns("arr", 1)
    store.put("arr", 0, "x", arr)
    store.commit("arr", 0)
    assert store.get("arr", "x") is arr
    store.close()


def test_deferred_waiters_answer_and_error_as_the_namesake():
    """Parked wire gets/fences: a destroy mid-fence and a server close
    under a parked get answer with the namesake's messages."""
    msgs = {}
    for name, (pmix, _, errors) in PKGS.items():
        srv = pmix.PmixServer()
        c = pmix.PmixClient(srv.address)
        c.ensure_ns("d", 2)
        res = {}

        def fence():
            f = pmix.PmixClient(srv.address)
            try:
                f.fence("d", 0, timeout=10.0)
            except errors.MpiError as e:
                res["fence"] = str(e)
            finally:
                f.close()

        t = threading.Thread(target=fence)
        t.start()
        deadline = time.monotonic() + 5.0
        while srv.store.fence_status("d") != (1, 2):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        c.destroy_ns("d")
        t.join(10.0)
        assert c.ping() is True
        with pytest.raises(errors.InternalError) as e:
            c.get("gone", "k", timeout=0.2)
        msgs[name] = (res["fence"], str(e.value), c.stat())
        c.close()
        srv.close()
        assert srv.closed
    assert msgs["port"] == msgs["jax"]
    assert "destroyed mid-fence" in msgs["port"][0]


@pytest.mark.parametrize("publisher,fetcher", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_tuned_table_crosses_packages(publisher, fetcher):
    text = "[topology * * *]\nallreduce 4 1024 ring\n"
    srv = PKGS["jax" if publisher == "port" else "port"][0].PmixServer()
    try:
        pub = PKGS[publisher][0].PmixClient(srv.address)
        PKGS[publisher][0].publish_tuned_table(pub, text)
        pub.close()
        fpmix, fspc, _ = PKGS[fetcher]
        f0 = fspc.read("tuned_table_store_fetches")
        addr = f"{srv.address[0]}:{srv.address[1]}"
        assert fpmix.fetch_tuned_table(addr) == text
        assert fspc.read("tuned_table_store_fetches") - f0 == 1
        if srv.store.__class__ is tpmix.PmixStore:
            assert tpmix.stale_tuned_tables() == [
                "pmix-ztune:ztune:['tuned_table']"]
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
    finally:
        srv.close()
    assert tpmix.stale_tuned_tables() == []


def test_unreachable_store_degrades_to_none_in_both():
    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for pmix, spc, _ in PKGS.values():
        f0 = spc.read("tuned_table_store_fetches")
        assert pmix.fetch_tuned_table(("127.0.0.1", port), timeout=1.0) is None
        assert spc.read("tuned_table_store_fetches") == f0
    with pytest.raises(terrors.InternalError, match="cannot reach"):
        tpmix.PmixClient(("127.0.0.1", port), timeout=1.0)


def test_hygiene_views_and_helpers():
    srv = tpmix.PmixServer()
    try:
        name = f"pmix-server:{srv.address[0]}:{srv.address[1]}"
        assert name in tpmix.live_servers()
        store = srv.store
        store.ensure_ns("hy", 1)
        for key in ("metrics:hy:0", "flightrec:hy:0", "trace:hy:0",
                    "card:0"):
            store.put("hy", 0, key, 1)
        store.commit("hy", 0)
        assert "pmix-ns:hy" in tpmix.stale_namespaces()
        assert sorted(k for k in tpmix.stale_metric_keys()
                      if ":hy:" in k) == [
            "pmix-key:hy:flightrec:hy:0", "pmix-key:hy:metrics:hy:0",
            "pmix-key:hy:trace:hy:0"]
    finally:
        srv.close()
    assert name not in tpmix.live_servers()
    assert "pmix-ns:hy" not in tpmix.stale_namespaces()
    for addr in ("10.0.0.1:77", ("10.0.0.1", "77")):
        assert tpmix.parse_addr(addr) == jpmix.parse_addr(addr) == (
            "10.0.0.1", 77)
    a, b = __import__("socket").socketpair()
    assert tpmix.conn_alive(a) and jpmix.conn_alive(a)
    b.close()
    assert not tpmix.conn_alive(a) and not jpmix.conn_alive(a)
    a.close()
