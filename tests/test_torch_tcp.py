"""The port's TCP transport (``pt2pt/tcp``, ``engine_mux``) over loopback,
and its wire compatibility with the JAX package's.

- A 4-rank port ``TcpProc`` universe (threads, ``sm=False``): eager,
  zero-copy (out-of-band) and rendezvous (above ``tcp_eager_limit``)
  messages of numpy arrays and CPU tensors, deferred isends, per-source
  non-overtaking order across eager and rendezvous sizes, probe, the
  barrier and host collectives over the wire (the ring allreduce too).
- The store-served keywords (``pmix=``, ``rejoin=True``, elastic
  ``live_ranks``, ``metrics``, ``trace``) keep the namesake's error
  contract; a 4-rank universe modexes through a PMIx store (of either
  package), starts an elastic job on a proper subset of its slots, and a
  killed rank's replacement rejoins through the store at the recovery
  window's generation.  A proc without ``ft=True`` refuses the ULFM
  surface.
  A 2-rank ``TcpProc`` at the ``sm`` var's default (1) builds its
  shared-memory segment and advertises one host (``pt2pt/sm.py``, held
  in ``tests/test_torch_sm.py``).
- A tensor on another device (``meta`` standing in for CUDA) given to
  ``send``/``isend`` raises dss's ``TypeError_`` before any frame is
  written (the wire byte counter does not move).
- **Wire compatibility**: 2 port ranks and 2 JAX-package ranks in one
  universe run a barrier, an int64 and an f32 allreduce above
  ``host_coll_large_msg`` (the ring; all four ranks hold the same bits),
  an alltoall, and a rendezvous-size message in each direction; with
  ``ft=True`` (sm off) revokes flood across the packages, a killed rank
  of either package (or one flooding its own device fault) is classified
  by the others, and agree, ``agree_failed_set``, shrink and the
  post-shrink ring allreduce agree to the bit on every survivor.

Every proc is closed by its thread; a module fixture then checks that no
push-pool thread, channel engine, incomplete deferred send or parked
rendezvous descriptor of the port outlived its proc, and that the port's
lock-order witness saw no inversion.
"""

import os
import threading

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt import engine_mux as tengine
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import spc
from zhpe_ompi_tpu_torch.utils import lockdep

RANK_TIMEOUT = 20.0


@pytest.fixture(scope="module", autouse=True)
def _port_transport_hygiene():
    yield
    assert ttcp.live_push_threads() == []
    assert ttcp.live_incomplete_send_requests() == []
    assert ttcp.orphaned_rndv_descriptors() == []
    assert tengine.live_engines() == []
    assert lockdep.cycles() == []


def run_tcp(kinds, fn, timeout=60.0):
    """One universe of ``len(kinds)`` ranks in threads over loopback;
    ``kinds[r]`` is the TcpProc class of rank r (rank 0 binds the
    coordinator on port 0 and hands its address to the others)."""
    n = len(kinds)
    ready = threading.Event()
    addr = [None]
    results, excs = [None] * n, [None] * n

    def publish(a):
        addr[0] = a
        ready.set()

    def main(r):
        try:
            if r == 0:
                proc = kinds[0](0, n, coordinator=("127.0.0.1", 0),
                                on_coordinator_bound=publish, sm=False,
                                timeout=RANK_TIMEOUT)
            else:
                assert ready.wait(RANK_TIMEOUT)
                proc = kinds[r](r, n, coordinator=addr[0], sm=False,
                                timeout=RANK_TIMEOUT)
            try:
                results[r] = fn(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e
            ready.set()

    threads = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "tcp rank hung"
    for e in excs:
        if e is not None:
            raise e
    return results


def test_eager_zero_copy_rendezvous_and_order():
    def prog(p):
        if p.rank == 1:
            before = {k: spc.read(k) for k in ("tcp_zero_copy_sends", "tcp_rndv_sends")}
            small = torch.arange(10, dtype=torch.int64)
            p.send(small, 0, tag=7)
            small[:] = 0  # reuse after the blocking send returned
            p.send(np.arange(3, dtype=np.float32), 0, tag=7)
            big = torch.ones(300_000, dtype=torch.float32)  # 1.2 MB > 1 MiB
            p.send(big, 0, tag=7)
            big[:] = 5.0
            p.send(b"tail", 0, tag=7)
            reqs = [p.isend(torch.full((300_000,), 2.0), 0, tag=8),
                    p.isend({"k": torch.arange(4)}, 0, tag=8)]
            for r in reqs:
                r.wait(RANK_TIMEOUT)
            after = {k: spc.read(k) - before[k] for k in before}
            p.barrier()
            return after
        if p.rank == 0:
            got = [p.recv(1, tag=7, timeout=RANK_TIMEOUT) for _ in range(4)]
            nb = [p.irecv(1, tag=8) for _ in range(2)]
            vals = [r.wait(RANK_TIMEOUT) for r in nb]
            p.barrier()
            return ([type(g).__name__ for g in got[:3]], got[0].tolist(),
                    got[1].tolist(), float(got[2].sum()), got[3],
                    float(vals[0].sum()), vals[1]["k"].tolist())
        p.barrier()
        return None

    res = run_tcp([TcpProc] * 4, prog)
    kinds, small, f32, big, tail, nb_big, nb_small = res[0]
    assert kinds == ["Tensor", "Tensor", "Tensor"]
    assert small == list(range(10)) and f32 == [0.0, 1.0, 2.0]
    assert big == 300_000.0 and tail == b"tail"
    assert nb_big == 600_000.0 and nb_small == [0, 1, 2, 3]
    assert res[1]["tcp_zero_copy_sends"] >= 4 and res[1]["tcp_rndv_sends"] >= 2


def test_non_overtaking_across_protocols_and_wildcards():
    sizes = [8, 400_000, 16, 300_000, 4, 8]  # int32: eager, rndv, ...

    def prog(p):
        if p.rank in (1, 2, 3):
            for k, n in enumerate(sizes):
                if k % 2:
                    p.isend(np.full(n, p.rank * 100 + k, np.int32), 0, tag=3).wait(RANK_TIMEOUT)
                else:
                    p.send(torch.full((n,), p.rank * 100 + k, dtype=torch.int32), 0, tag=3)
            return None
        seen = {1: [], 2: [], 3: []}
        for _ in range(3 * len(sizes)):
            v, st = p.recv(-1, tag=-1, timeout=RANK_TIMEOUT, return_status=True)
            seen[st.source].append((int(v[0]), int(v.shape[0]), st.count_bytes))
        return seen

    seen = run_tcp([TcpProc] * 4, prog)[0]
    for r, got in seen.items():
        assert got == [(r * 100 + k, n, 4 * n) for k, n in enumerate(sizes)]


def test_collectives_over_the_wire():
    def prog(p):
        r = p.rank
        out = [p.allreduce(torch.full((70_000,), r + 1, dtype=torch.int64), tops.SUM)[::9999].tolist(),
               p.allreduce(np.arange(3.0) * r, tops.MAX).tolist(),
               p.iallreduce(r, tops.SUM).wait(RANK_TIMEOUT),
               [int(x) for x in p.alltoall([torch.tensor([r * 4 + d]) for d in range(p.size)])],
               p.bcast((np.arange(200_000) % 1000).astype(np.int16) if r == 2 else None,
                       root=2, algorithm="pipeline")[-3:].tolist(),
               p.scan(r, tops.SUM), sorted(x for x in p.allgather(r))]
        p.barrier()
        p.ibarrier().wait(RANK_TIMEOUT)
        return out

    res = run_tcp([TcpProc] * 4, prog)
    for r, out in enumerate(res):
        assert out[0] == [10] * 8
        assert out[1] == [0.0, 3.0, 6.0]
        assert out[2] == 6
        assert out[3] == [s * 4 + r for s in range(4)]
        assert out[4] == [997, 998, 999]
        assert out[5] == sum(range(r + 1)) and out[6] == [0, 1, 2, 3]


def test_device_tensors_are_refused_before_any_frame():
    def prog(p):
        meta = torch.empty(8, device="meta")
        if p.rank == 0:
            before = spc.read("tcp_bytes_sent")
            raised = []
            for call in (lambda: p.send(meta, 1, tag=1),
                         lambda: p.isend([1, {"x": meta}], 1, tag=1),
                         lambda: p.send(meta, 0, tag=1),  # loopback too
                         lambda: p.send(torch.ones(2, dtype=torch.bfloat16), 1, tag=1)):
                with pytest.raises(errors.TypeError_) as e:
                    call()
                raised.append(str(e.value))
            sent = spc.read("tcp_bytes_sent") - before
            p.send(b"done", 1, tag=2)
            return raised, sent, p.probe(0, 1)
        got = p.recv(0, tag=-1, timeout=RANK_TIMEOUT, return_status=True)
        return got[1].tag, p.probe(0, 1)

    (raised, sent, self_probe), (tag, probe) = run_tcp([TcpProc] * 2, prog)
    assert all(".cpu()" in m for m in raised[:3]) and "bfloat16" in raised[3]
    assert sent == 0 and self_probe is None
    assert tag == 2 and probe is None  # the first frame rank 1 saw was "done"


def test_what_waits_raises_naming_its_module():
    """The store-served keywords keep the namesake's error contract:
    each misuse raises the namesake's ``ArgError`` with its message (the
    store itself is ``runtime/pmix.py``, held in
    ``tests/test_torch_pmix.py``; the working paths are in
    ``test_store_served_modex_rejoin_and_elastic_slots`` below)."""
    from zhpe_ompi_tpu.core import errors as jerrors

    cases = [
        dict(sm=False, rejoin=True),                    # rejoin needs ft
        dict(sm=False, ft=True, rejoin=True),           # ... and a store
        dict(sm=False, ft=True, live_ranks=[0]),        # elastic needs pmix
        dict(sm=False, live_ranks=[0], pmix=("127.0.0.1", 1)),  # and ft
        dict(sm=False, ft=True, live_ranks=[1]),        # must hold the rank
        dict(sm=False, ft=True, live_ranks=[0, 5]),     # inside the universe
        dict(sm=False, metrics=True),                   # metrics needs pmix
        dict(sm=False, trace=True),                     # trace needs metrics
        dict(sm=False, rejoin_book=[("h", 1)] * 2),     # rejoin_book needs ft
    ]
    assert tvar.get("sm") == 1
    for kwargs in cases:
        with pytest.raises(errors.ArgError) as port:
            TcpProc(0, 2, **kwargs)
        with pytest.raises(jerrors.ArgError) as ref:
            JTcpProc(0, 2, **kwargs)
        assert str(port.value) == str(ref.value), kwargs
    # the sm var's default (1): TcpProc(0, 2) builds its sm segment
    def prog(p):
        assert p._sm_seg is not None and os.path.exists(p._sm_seg.path)
        assert p.boot_token_of(1) == p.boot_token_of(0) is not None
        assert p.numa_token_of(0) is not None
        # without ft the ULFM surface is refused, as in the namesake
        for call in (lambda: p.revoke(3), p.failure_ack, p.agree,
                     p.shrink):
            with pytest.raises(errors.UnsupportedError, match="ft=True"):
                call()
        p.barrier()
        return p.resource_stats()["threads"] >= 1

    ready = threading.Event()
    addr = [None]
    out = [None, None]

    def main(r):
        if r == 0:
            proc = TcpProc(0, 2, on_coordinator_bound=lambda a: (addr.__setitem__(0, a), ready.set()),
                           timeout=RANK_TIMEOUT)
        else:
            ready.wait(RANK_TIMEOUT)
            proc = TcpProc(1, 2, coordinator=addr[0], timeout=RANK_TIMEOUT)
        try:
            out[r] = prog(proc)
        finally:
            proc.close()

    ts = [threading.Thread(target=main, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(60.0) for t in ts]
    assert out == [True, True]
    # one rank needs no sm segment, as in the namesake
    solo = TcpProc(0, 1, sm=True)
    try:
        assert solo.allreduce(5, tops.SUM) == 5
    finally:
        solo.close()


def run_pmix(kinds, fn, pmix_addr, ns, timeout=60.0, **kw):
    """``run_tcp`` through a PMIx store: rank r is ``kinds[r]`` (or absent
    when None), every rank modexes with ``pmix=pmix_addr``."""
    n = len(kinds)
    results, excs = [None] * n, [None] * n

    def main(r):
        try:
            proc = kinds[r](r, n, pmix=pmix_addr, namespace=ns, sm=False,
                            timeout=RANK_TIMEOUT, **kw)
            try:
                results[r] = fn(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e

    threads = [threading.Thread(target=main, args=(r,))
               for r in range(n) if kinds[r] is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "pmix rank hung"
    for e in excs:
        if e is not None:
            raise e
    return results


@pytest.mark.parametrize("server", ["jax", "port"])
def test_store_served_modex_rejoin_and_elastic_slots(server):
    """Ranks 0 and 2 are the port's, 1 and 3 the JAX package's, wired up
    through one package's PMIx store (``pmix=``): the modex is 4 puts and
    16 gets, the cards hold the namesake's ``card:<rank>`` keys, and an
    allreduce agrees.  Then an ft job starts on slots {0, 1} of 3
    (elastic ``live_ranks``): slot 2 is a pre-acknowledged departure, a
    port rank rejoins it through the store (``rejoin=True`` at the bumped
    generation), and the three reduce at full size."""
    from zhpe_ompi_tpu.runtime import pmix as jpmix
    from zhpe_ompi_tpu.runtime import spc as jspc
    from zhpe_ompi_tpu_torch.ft import recovery as trecovery
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix

    pmix, sspc = (tpmix, spc) if server == "port" else (jpmix, jspc)
    srv = pmix.PmixServer()
    addr = f"127.0.0.1:{srv.address[1]}"
    try:
        g0, p0 = sspc.read("pmix_gets"), sspc.read("pmix_puts")

        def prog(p):
            port = isinstance(p, TcpProc)
            x = np.arange(4, dtype=np.int64) * (p.rank + 1)
            got = p.allreduce(torch.from_numpy(x) if port else x,
                              (tops if port else jops).SUM)
            p.barrier()
            return np.asarray(got).tolist()

        res = run_pmix([TcpProc, JTcpProc, TcpProc, JTcpProc], prog, addr,
                       "mixjob")
        assert res == [[0, 10, 20, 30]] * 4
        assert sspc.read("pmix_puts") - p0 == 4
        assert sspc.read("pmix_gets") - g0 == 16
        assert sorted(srv.store.lookup("mixjob", "card:")) == [
            f"card:{r}" for r in range(4)]
        assert srv.store.destroy_ns("mixjob")

        # elastic slots, then a store-served rejoin into slot 2
        joined = threading.Event()
        # both ranks read slot 2's pre-acknowledged departure before rank 0
        # starts the rejoin: once a rank has adopted the rejoin, slot 2 has
        # no departure cause any more
        checked = threading.Barrier(2)

        def elastic(p):
            state = p.ft_state
            try:
                assert state.cause_of(2) == "goodbye"  # pre-acknowledged
                checked.wait(RANK_TIMEOUT)
            except BaseException:
                checked.abort()
                raise
            if p.rank == 0:
                srv.store.bump_generation("ejob")
                gen = srv.store.generation("ejob")
                t = threading.Thread(target=rejoiner, args=(gen,))
                t.start()
            assert trecovery.await_rejoin(p, 2, RANK_TIMEOUT)
            out = float(p.allreduce(torch.tensor(float(p.rank + 1)), tops.SUM)
                        if isinstance(p, TcpProc) else
                        p.allreduce(np.float64(p.rank + 1), jops.SUM))
            if p.rank == 0:
                t.join(RANK_TIMEOUT)
            return out

        rejoin_out = []

        def rejoiner(gen):
            q = TcpProc(2, 3, pmix=addr, namespace="ejob", ft=True, sm=False,
                        rejoin=True, rejoin_gen=gen, rejoin_ranks=[2],
                        live_ranks=[0, 1, 2], timeout=RANK_TIMEOUT)
            try:
                rejoin_out.append(float(q.allreduce(torch.tensor(3.0),
                                                    tops.SUM)))
            finally:
                q.close()

        res = run_pmix([TcpProc, JTcpProc, None], elastic, addr, "ejob",
                       ft=True, live_ranks=[0, 1])
        assert res[:2] == [6.0, 6.0] and rejoin_out == [6.0]
        assert srv.store.get_meta("ejob", "card:2", timeout=1.0)[1] == 1
        assert srv.store.destroy_ns("ejob")
    finally:
        srv.close()


def test_wire_compatibility_with_the_jax_package():
    """Ranks 0 and 2 are the port's, 1 and 3 the JAX package's."""
    n = 70_000  # int64: 560 KB > host_coll_large_msg (256 KB) -> ring

    def prog(p):
        port = isinstance(p, TcpProc)
        r = p.rank
        ops = tops if port else jops
        ints = np.arange(n, dtype=np.int64) * (r + 1) - 7 * r
        rng = np.random.default_rng(r)
        flts = rng.standard_normal(n).astype(np.float32)
        p.barrier()
        a = p.allreduce(torch.from_numpy(ints) if port else ints, ops.SUM)
        b = p.allreduce(torch.from_numpy(flts) if port else flts, ops.SUM)
        blocks = [np.array([r * 10 + d, -d], np.int64) for d in range(4)]
        c = p.alltoall([torch.from_numpy(x) for x in blocks] if port else blocks)
        big = np.arange(400_000, dtype=np.float32) + r  # 1.6 MB: rendezvous
        if r == 1:
            p.send(big, 2, tag=11)  # reference -> port
            got = p.recv(2, tag=12, timeout=RANK_TIMEOUT)
        elif r == 2:
            got = p.recv(1, tag=11, timeout=RANK_TIMEOUT)
            p.send(torch.from_numpy(big), 1, tag=12)  # port -> reference
        else:
            got = None
        p.barrier()
        return (np.asarray(a).tobytes(), np.asarray(b).tobytes(),
                [np.asarray(x).tolist() for x in c],
                None if got is None else (type(got).__name__, np.asarray(got).tobytes()))

    res = run_tcp([TcpProc, JTcpProc, TcpProc, JTcpProc], prog)
    ints = sum(np.arange(n, dtype=np.int64) * (r + 1) - 7 * r for r in range(4))
    assert all(r[0] == ints.tobytes() for r in res)
    assert len({r[1] for r in res}) == 1  # f32: the same bits on all four
    f32 = np.frombuffer(res[0][1], np.float32)
    ref = sum(np.random.default_rng(r).standard_normal(n).astype(np.float32)
              for r in range(4))
    np.testing.assert_allclose(f32, ref, rtol=1e-5, atol=1e-5)
    for r in range(4):
        assert res[r][2] == [[s * 10 + r, -r] for s in range(4)]
    assert res[2][3] == ("Tensor", (np.arange(400_000, dtype=np.float32) + 1).tobytes())
    assert res[1][3] == ("ndarray", (np.arange(400_000, dtype=np.float32) + 2).tobytes())


@pytest.mark.parametrize("victim,how", [(1, "kill"), (2, "kill"),
                                        (1, "device"), (2, "device")],
                         ids=["jax-killed", "port-killed", "jax-device",
                              "port-device"])
def test_ft_wire_compatibility_with_the_jax_package(victim, how):
    """Ranks 0 and 2 are the port's, 1 and 3 the JAX package's, with
    ``ft=True`` and sm off: revokes flood across the packages, a killed
    rank of either package is classified by the others (a device fault
    with its typed cause), and agree, agree_failed_set, shrink and the
    post-shrink ring allreduce agree to the bit on all survivors."""
    from test_torch_ulfm import check_mixed_ft, mixed_ft_program, run_mixed_ft

    res = run_mixed_ft([TcpProc, JTcpProc, TcpProc, JTcpProc],
                       mixed_ft_program(victim, how), sm=False)
    check_mixed_ft(res, victim, how)
