"""The port's shared-memory transport (``pt2pt/sm``) and its seam in
``pt2pt/tcp``, held against the JAX package's.

- The ring below the transport: frames through a 4-slot ring wrap many
  times, a message larger than the whole ring streams through, a
  zero-size frame arrives, and a port producer and a JAX-package
  consumer (and the reverse) share one ring — layout v3 byte for byte.
- Demand mapping: no ring for a silent peer, the leader-class geometry
  for a cross-NUMA-domain pair, a tuned table's ``geometry`` line, and a
  stale segment unlinked at create.
- Selection on ``TcpProc`` universes in threads: sm by default on one
  boot id, a mismatched boot id degrades to TCP loudly
  (``sm_fallback_tcp_sends``), an ``sm=0`` peer rides TCP as intended
  (not counted, as in the namesake), ``tcp_priority`` above
  ``sm_priority`` forces TCP; the nonblocking ring paths.
- A tensor on another device (``meta`` standing in for CUDA) is refused
  by dss's typed error before any slot is written.
- Lifecycle: segments unlinked at close, none created with sm off, none
  left by a constructor that fails.
- **Ring compatibility**: 2 port and 2 JAX-package ranks on one boot id
  run the ring allreduce and an alltoall over each other's rings; with
  ``ft=True`` (``tests/test_torch_ulfm.py``'s mixed program) revokes flood
  across the packages, a killed rank of either package is classified (a
  stopped ring consumer is peer death), and the survivors agree, shrink
  and reduce to the bit.
- The ft paths around a respawn, on both packages: a severed rank's
  rings are unmapped by the death listener, its replacement rejoins over
  TCP from the survivors' book and its card is scrubbed.

A module fixture checks that no ring file, poll thread, audit failure or
han tag window of the port outlived its proc.
"""

import os
import time

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.pt2pt import sm as jsm
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.coll import ztable
from zhpe_ompi_tpu_torch.core import errhandler as errh
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt import groups as tgroups
from zhpe_ompi_tpu_torch.pt2pt import sm as tsm
from zhpe_ompi_tpu_torch.pt2pt import tcp as ttcp
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import run_tcp_threads as run_tcp

RANK_TIMEOUT = 20.0


@pytest.fixture(scope="module", autouse=True)
def _port_sm_hygiene():
    yield
    assert tsm.orphaned_ring_files() == []
    assert tsm.live_poll_threads() == []
    assert tsm.segment_audit_failures() == []
    assert tgroups.leaked_tag_windows() == []
    assert tgroups.live_election_threads() == []
    assert ttcp.live_push_threads() == []
    assert ttcp.live_incomplete_send_requests() == []


@pytest.fixture
def port_vars():
    """Snapshot/restore both packages' MCA registries around a test."""
    saved = [(reg, {v.name: (v._value, v._source) for v in reg.registry.all_vars()})
             for reg in (tvar, jvar)]
    yield tvar
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]


def _await(collected, count, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(collected) < count and time.monotonic() < deadline:
        time.sleep(0.001)
    assert len(collected) >= count, f"only {len(collected)}/{count} frames arrived"


def _ring_geometry(reg, nslots=4, slot_bytes=256):
    reg.set_var("sm_max_frag", slot_bytes)
    reg.set_var("sm_ring_bytes", nslots * slot_bytes)


# (segment owner's module and var registry, sender's module)
PAIRS = {"port": (tsm, tvar, tsm), "port_to_jax": (jsm, jvar, tsm),
         "jax_to_port": (tsm, tvar, jsm)}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_ring_round_trip_with_wraparound(port_vars, pair):
    seg_mod, reg, tx_mod = PAIRS[pair]
    _ring_geometry(reg)
    collected = []
    seg = seg_mod.SmSegment(0, 2, on_frame=lambda src, f: collected.append((src, bytes(f))))
    tx = tx_mod.SmSender(seg.name, src_rank=1, dest_rank=0)
    try:
        assert (tx.nslots, tx.slot_bytes) == (4, 256)
        frames = [bytes([i]) * (i * 37 % 200) for i in range(64)]  # 16 wraps
        for f in frames:
            tx.send_frame(f, [], time.monotonic() + 5.0, None)
        _await(collected, len(frames))
        assert collected == [(1, f) for f in frames]
    finally:
        tx.close()
        seg.close()
    assert not os.path.exists(seg.path)


def test_message_larger_than_the_ring_and_zero_size_frame(port_vars):
    _ring_geometry(tvar)
    collected = []
    seg = tsm.SmSegment(0, 2, on_frame=lambda src, f: collected.append(bytes(f)))
    tx = tsm.SmSender(seg.name, src_rank=1, dest_rank=0)
    try:
        big = bytes(range(256)) * 40  # 10 KiB through a 1 KiB ring
        wire, nfrags = tx.send_frame(big, [], time.monotonic() + 10.0, None)
        assert nfrags == 40 and wire == len(big) + nfrags * 16
        wire, nfrags = tx.send_frame(b"", [], time.monotonic() + 5.0, None)
        assert nfrags == 1 and wire == 16
        _await(collected, 2)
        assert collected == [big, b""]
        assert tx.pending() == 0
    finally:
        tx.close()
        seg.close()


def test_demand_mapping_no_ring_for_a_silent_peer(port_vars):
    """Only rank 1 ever sends to rank 0: rank 0's segment materializes
    one ring (from 1), and ranks 2 and 3 cost it nothing."""
    def prog(p):
        if p.rank == 1:
            p.send(np.arange(16), 0, tag=4)
        got = p.recv(1, tag=4, timeout=RANK_TIMEOUT) if p.rank == 0 else None
        stats = p.sm_segment_stats()
        return stats["materialized"], None if got is None else got.tolist()

    res = run_tcp(4, prog, sm=True, sm_boot_id="one-host")
    assert res[0] == ([1], list(range(16)))
    assert all(r[0] == [] for r in res[1:])


def test_leader_class_geometry_and_table_sizes(port_vars, tmp_path, monkeypatch):
    """Cross-NUMA-domain pairs get the leader class's ring; a tuned
    table's ``geometry`` line sizes a ring while its var holds the
    default, and an explicit setting outranks the table."""
    tvar.set_var("sm_max_frag", 1024)
    tvar.set_var("sm_leader_ring_bytes", 2 * 1024)
    seg = tsm.SmSegment(0, 3, on_frame=lambda *a: None)
    try:
        intra = tsm.SmSender(seg.name, src_rank=1, dest_rank=0)
        leader = tsm.SmSender(seg.name, src_rank=2, dest_rank=0,
                              ring_class=tsm.CLASS_LEADER)
        assert leader.nslots == 2 and intra.nslots == (4 << 20) // 1024
        assert seg.materialized() == [1, 2]
        intra.close()
        leader.close()
    finally:
        seg.close()
    table = tmp_path / "rules.txt"
    table.write_text("[topology * * *]\ngeometry sm_leader_ring_bytes 8192\n")
    tvar.registry.lookup("sm_leader_ring_bytes")._source = tvar.VarSource.DEFAULT
    tvar.set_var("coll_tuned_dynamic_rules", str(table))
    assert ztable.active() and ztable.table_geometry("sm_leader_ring_bytes") == 8192
    assert ztable.table_geometry("sm_ring_bytes") is None
    assert tsm._class_geometry(tsm.CLASS_LEADER) == (8, 1024)
    tvar.set_var("sm_leader_ring_bytes", 4096)  # explicit: outranks the table
    assert tsm._class_geometry(tsm.CLASS_LEADER) == (4, 1024)
    # under ZMPI_PMIX the store-served table's geometry comes first (the
    # namesake's rung order), while the var holds its default
    from zhpe_ompi_tpu_torch.runtime import pmix as tpmix

    srv = tpmix.PmixServer()
    try:
        tpmix.publish_tuned_table(
            srv.store, "[topology * * *]\ngeometry sm_leader_ring_bytes 16384\n")
        monkeypatch.setenv("ZMPI_PMIX", f"127.0.0.1:{srv.address[1]}/job")
        ztable.invalidate_cache()
        tvar.registry.lookup("sm_leader_ring_bytes")._source = tvar.VarSource.DEFAULT
        assert ztable.active()
        assert ztable.table_geometry("sm_leader_ring_bytes") == 16384
        assert ztable.table_geometry("sm_ring_bytes") is None
        assert tsm._class_geometry(tsm.CLASS_LEADER) == (16, 1024)
        srv.store.destroy_ns(tpmix.ZTUNE_NS)
    finally:
        srv.close()
        ztable.invalidate_cache()


_TAIL_WRITER = """
import mmap, os, sys
from zhpe_ompi_tpu_torch.pt2pt import sm
fd = os.open(sys.argv[1], os.O_RDWR)
mm = mmap.mmap(fd, 4096)
os.close(fd)
mv = memoryview(mm)
words = sm._ring_words(mv)
print("ready", flush=True)
for i in range(1, int(sys.argv[2])):
    words[sm._TAIL_WORD] = i
words.release()
mv.release()
mm.close()
"""


def test_ring_words_are_never_read_torn_across_processes(tmp_path):
    """A ring's tail, written by its consumer process and read by its
    producer, must never be read as a value it never held.  struct's
    ``pack_into`` zero-fills the word before writing it (and
    ``unpack_from`` assembles it byte by byte), so a producer racing the
    consumer could read a tail of 0 and find a ring with proven free
    slots "full"; the port loads and stores the head and tail words
    whole.  A writer process counts the tail up while this process reads
    it: the reads never go down."""
    import mmap
    import subprocess
    import sys

    path = tmp_path / "ring"
    path.write_bytes(b"\0" * 4096)
    fd = os.open(path, os.O_RDWR)
    mm = mmap.mmap(fd, 4096)
    os.close(fd)
    mv = memoryview(mm)
    words = tsm._ring_words(mv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    writer = subprocess.Popen(
        [sys.executable, "-c", _TAIL_WRITER, str(path), "2000000"],
        env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
        text=True)
    try:
        assert writer.stdout.readline().strip() == "ready"
        last, reads, drops = 0, 0, 0
        while writer.poll() is None:
            v = words[tsm._TAIL_WORD]
            reads += 1
            drops += v < last
            last = max(last, v)
        assert writer.wait(30) == 0
    finally:
        if writer.poll() is None:
            writer.kill()
        words.release()
        mv.release()
        mm.close()
    assert reads > 1000 and drops == 0, (reads, drops)
    assert last == 1999999


def test_stale_segment_unlinked_at_create():
    name = f"zompi_pyring_stale_{os.getpid()}_{time.monotonic_ns()}"
    path = os.path.join(tsm.segment_dir(), name)
    with open(path, "wb") as fh:
        fh.write(b"garbage from a crashed job" * 10)
    seg = tsm.SmSegment(0, 2, on_frame=lambda *a: None, name=name)
    try:
        with open(path, "rb") as fh:
            head = fh.read(8)
        assert int.from_bytes(head, "little") == tsm._MAGIC
        assert os.path.getsize(path) == tsm._hdr_len(2)
    finally:
        seg.close()
    assert not os.path.exists(path)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 64)  # a foreign, truncated file is refused
    try:
        with pytest.raises(errors.InternalError, match="truncated"):
            tsm.SmSender(name, src_rank=1, dest_rank=0)
    finally:
        os.unlink(path)


def _exchange(p):
    other = 1 - p.rank
    msgs = [p.rank, np.arange(256.0), b"z" * 8192, torch.zeros(1 << 15)]
    for i, m in enumerate(msgs):
        p.send(m, other, tag=20 + i)
    got = [p.recv(other, tag=20 + i, timeout=RANK_TIMEOUT) for i in range(len(msgs))]
    p.barrier()
    assert all(p.probe(other, 20 + i) is None for i in range(len(msgs)))
    return (got[0], float(np.asarray(got[1]).sum()), len(got[2]), int(got[3].numel()))


EXPECT = [(1, float(np.arange(256.0).sum()), 8192, 1 << 15),
          (0, float(np.arange(256.0).sum()), 8192, 1 << 15)]
COUNTERS = ("sm_bytes_sent", "sm_fallback_tcp_sends", "tcp_bytes_sent")


def _delta(fn):
    before = {k: spc.read(k) for k in COUNTERS}
    out = fn()
    return out, {k: spc.read(k) - before[k] for k in COUNTERS}


def test_sm_by_default_on_one_boot(port_vars):
    """The sm var's default (1): the rings carry the data; the wire
    carries only the modex (no data connection is ever dialed)."""
    assert tvar.get("sm") == 1
    res, d = _delta(lambda: run_tcp(2, _exchange))
    assert res == EXPECT
    assert d["sm_bytes_sent"] > 2 * 4 * (1 << 15) and d["sm_fallback_tcp_sends"] == 0
    assert d["tcp_bytes_sent"] < 1024  # two modex frames each way


def test_mismatched_boot_id_degrades_loudly(port_vars):
    res, d = _delta(lambda: run_tcp(2, _exchange, {1: {"sm_boot_id": "feedfacef00d"}}))
    assert res == EXPECT
    assert d["sm_bytes_sent"] == 0
    assert d["sm_fallback_tcp_sends"] >= 2 * 4  # every data send, both ways


def test_sm_off_peer_rides_tcp_as_intended(port_vars):
    """One side sm=0 advertises no segment: no ring in either direction,
    every message once, and (as in the namesake) no fallback counted."""
    res, d = _delta(lambda: run_tcp(2, _exchange, {1: {"sm": False}}))
    assert res == EXPECT
    assert d["sm_bytes_sent"] == 0 and d["sm_fallback_tcp_sends"] == 0
    jfb = jspc.read("sm_fallback_tcp_sends")

    def jexchange(p):
        other = 1 - p.rank
        p.send(np.arange(4), other, tag=1)
        got = p.recv(other, tag=1, timeout=RANK_TIMEOUT)
        p.barrier()
        return got.tolist()

    assert run_tcp(2, jexchange, {1: {"sm": False}}, kinds=[JTcpProc] * 2) == [[0, 1, 2, 3]] * 2
    assert jspc.read("sm_fallback_tcp_sends") == jfb


def test_tcp_priority_above_sm_forces_tcp(port_vars):
    tvar.set_var("sm_priority", 10)
    tvar.set_var("tcp_priority", 20)

    def prog(p):
        out = _exchange(p)
        return out, p._sm_seg is not None

    res, d = _delta(lambda: run_tcp(2, prog))
    assert [r[0] for r in res] == EXPECT and all(r[1] for r in res)  # rings exist
    assert d["sm_bytes_sent"] == 0 and d["sm_fallback_tcp_sends"] == 0


def test_nonblocking_sends_over_the_ring(port_vars):
    """A small isend is born complete in one slot; a frame the free slots
    cover streams inline; one larger than the ring parks a continuation
    that streams once the consumer drains — order kept throughout."""
    tvar.set_var("sm_max_frag", 4096)
    tvar.set_var("sm_ring_bytes", 4 * 4096)
    sizes = [4, 1500, 40_000, 8, 3000]  # int64 elements

    def prog(p):
        if p.rank == 1:
            before = {k: spc.read(k) for k in ("sm_eager_sends", "sm_frag_sends",
                                                "tcp_isend_deferred")}
            reqs = [p.isend(torch.full((n,), k, dtype=torch.int64), 0, tag=9)
                    for k, n in enumerate(sizes)]
            for r in reqs:
                r.wait(RANK_TIMEOUT)
            p.barrier()
            return {k: spc.read(k) - v for k, v in before.items()}
        got = [p.recv(1, tag=9, timeout=RANK_TIMEOUT) for _ in sizes]
        p.barrier()
        return [(int(g[0]), g.numel()) for g in got]

    got, counts = run_tcp(2, prog)
    assert got == [(k, n) for k, n in enumerate(sizes)]
    assert counts["sm_eager_sends"] >= 1 and counts["sm_frag_sends"] >= 2
    assert counts["tcp_isend_deferred"] >= 1  # the 320 KB frame parked


def test_device_tensor_refused_before_any_slot(port_vars):
    def prog(p):
        if p.rank == 0:
            meta = torch.empty(8, device="meta")
            before = spc.read("sm_bytes_sent")
            raised = []
            for call in (lambda: p.send(meta, 1, tag=1),
                         lambda: p.isend({"x": [meta]}, 1, tag=1)):
                with pytest.raises(errors.TypeError_) as e:
                    call()
                raised.append(str(e.value))
            sent = spc.read("sm_bytes_sent") - before
            p.send(b"done", 1, tag=2)
            return raised, sent
        got = p.recv(0, tag=-1, timeout=RANK_TIMEOUT, return_status=True)
        return got[1].tag

    (raised, sent), tag = run_tcp(2, prog)
    assert all(".cpu()" in m for m in raised) and sent == 0
    assert tag == 2  # the first frame rank 1 saw was "done"


def test_segments_unlinked_at_close(port_vars):
    seen = []

    def prog(p):
        seen.append(p._sm_seg.path)
        assert os.path.exists(p._sm_seg.path)
        p.send(p.rank, (p.rank + 1) % 3, tag=1)
        p.recv((p.rank - 1) % 3, tag=1, timeout=RANK_TIMEOUT)
        p.barrier()
        return True

    assert run_tcp(3, prog) == [True] * 3
    assert len(seen) == 3
    for path in seen:
        assert not os.path.exists(path)
        assert not any(f.startswith(os.path.basename(path) + ".r")
                       for f in os.listdir(os.path.dirname(path)))
    assert tsm.orphaned_ring_files() == [] and tsm.live_poll_threads() == []


def test_nothing_created_with_sm_off(port_vars):
    before = set(tsm.orphaned_ring_files())
    tvar.set_var("sm", 0)

    def prog(p):
        p.barrier()
        return p._sm_seg is None and p.sm_segment_stats() is None \
            and p.boot_token_of(1) is None

    assert run_tcp(2, prog) == [True, True]
    assert run_tcp(2, prog, sm=False) == [True, True]
    assert set(tsm.orphaned_ring_files()) == before


def test_failed_construction_leaks_nothing(port_vars):
    before = set(tsm.orphaned_ring_files())
    with pytest.raises((errors.MpiError, errh.JobAbort)):
        TcpProc(1, 2, coordinator=("127.0.0.1", 1), timeout=0.5, sm=True)
    assert set(tsm.orphaned_ring_files()) == before
    assert tsm.live_poll_threads() == []


def test_alloc_rma_region_waits_for_osc_direct():
    """The region ``osc/direct.py`` waited for: allocated in the
    segment's namespace (``<segment>.w<idx>``), in the namesake's header
    layout (a JAX-package mapping reads its geometry), and unlinked by
    the segment's close when no window released it."""
    seg = tsm.SmSegment(0, 2, on_frame=lambda *a: None)
    try:
        region = seg.alloc_rma_region(4096)
        assert region.name == seg.name + ".w0"
        assert os.path.exists(region.path)
        peer = jsm.RmaMapping(region.path, 1)
        assert (peer.owner_rank, peer.nprocs, peer.data_len,
                peer.data_off) == (0, 2, 4096, 4096)
        peer.close()
    finally:
        seg.close()
    assert not os.path.exists(region.path)



def test_ring_compatibility_with_the_jax_package():
    """Ranks 0 and 2 are the port's, 1 and 3 the JAX package's, on one
    boot id with sm on: every data frame rides a ring of the other
    package's making, and the results agree to the bit."""
    n = 70_000  # int64: 560 KB > host_coll_large_msg (256 KB) -> ring

    def prog(p):
        port = isinstance(p, TcpProc)
        r = p.rank
        ops = tops if port else jops
        ints = np.arange(n, dtype=np.int64) * (r + 1) - 7 * r
        flts = np.random.default_rng(r).standard_normal(n).astype(np.float32)
        p.barrier()
        a = p.allreduce(torch.from_numpy(ints) if port else ints, ops.SUM)
        b = p.allreduce(torch.from_numpy(flts) if port else flts, ops.SUM)
        blocks = [np.array([r * 10 + d, -d], np.int64) for d in range(4)]
        c = p.alltoall([torch.from_numpy(x) for x in blocks] if port else blocks)
        p.barrier()
        return (np.asarray(a).tobytes(), np.asarray(b).tobytes(),
                [np.asarray(x).tolist() for x in c], type(a).__name__)

    t0, j0 = spc.read("sm_bytes_sent"), jspc.read("sm_bytes_sent")
    tf0, jf0 = spc.read("sm_fallback_tcp_sends"), jspc.read("sm_fallback_tcp_sends")
    res = run_tcp(4, prog, kinds=[TcpProc, JTcpProc, TcpProc, JTcpProc],
                  sm=True, sm_boot_id="sharedboot01")
    ints = sum(np.arange(n, dtype=np.int64) * (r + 1) - 7 * r for r in range(4))
    assert all(r[0] == ints.tobytes() for r in res)
    assert len({r[1] for r in res}) == 1  # f32: the same bits on all four
    ref = sum(np.random.default_rng(r).standard_normal(n).astype(np.float32)
              for r in range(4))
    np.testing.assert_allclose(np.frombuffer(res[0][1], np.float32), ref,
                               rtol=1e-5, atol=1e-5)
    for r in range(4):
        assert res[r][2] == [[s * 10 + r, -r] for s in range(4)]
    assert [r[3] for r in res] == ["Tensor", "ndarray", "Tensor", "ndarray"]
    # both packages produced into rings, and nothing fell back to TCP
    assert spc.read("sm_bytes_sent") - t0 > 2 * n * 8
    assert jspc.read("sm_bytes_sent") - j0 > 2 * n * 8
    assert spc.read("sm_fallback_tcp_sends") == tf0
    assert jspc.read("sm_fallback_tcp_sends") == jf0


@pytest.mark.parametrize("victim,how", [(1, "kill"), (2, "kill"),
                                        (2, "device")],
                         ids=["jax-killed", "port-killed", "port-device"])
def test_ft_ring_compatibility_with_the_jax_package(victim, how):
    """The mixed ft universe of ``test_torch_tcp.py`` with sm on and one
    boot id: data rides rings of the other package's making, a stopped
    consumer classifies as peer death, the goodbyes of the survivors'
    closes ride the rings, and the survivors agree, shrink and reduce to
    the bit."""
    from test_torch_ulfm import check_mixed_ft, mixed_ft_program, run_mixed_ft

    res = run_mixed_ft([TcpProc, JTcpProc, TcpProc, JTcpProc],
                       mixed_ft_program(victim, how), sm=True,
                       sm_boot_id="sharedboot01")
    check_mixed_ft(res, victim, how)
    assert tsm.orphaned_ring_files() == jsm.orphaned_ring_files() == []


def test_ft_rejoiner_rides_tcp_and_its_card_is_scrubbed(port_vars):
    """The sm plane's ft paths around a respawn, on both packages: rank 2
    is severed (its consumer stops: survivors classify and unmap their
    rings into it), a replacement rejoins from the survivors' book over
    TCP (no segment), and the survivors scrub its card (no locality
    token, the pair pinned to TCP, han's topology invalidated) before a
    full-size allreduce."""
    import threading as th

    from test_torch_ulfm import JAX, PORT, run_tcp_ft

    for reg in (tvar, jvar):
        reg.set_var("ft_detector_period", 0.05)
        reg.set_var("ft_detector_timeout", 1.0)

    def run(P):
        book, ready, box = {}, th.Event(), []

        def prog(p):
            p.set_errhandler(P.errh.ERRORS_RETURN)
            if p.rank == 0:
                book["b"] = list(p.address_book)
            p.barrier()
            p.allreduce(np.ones(4), P.ops.SUM)  # warm the rings
            if p.rank == 2:
                P.ulfm.expect_failure(p.ft_state, 2)
                p.sever()
                return "severed"
            assert p.ft_state.wait_failed(2, timeout=10.0)
            deadline = time.monotonic() + 5.0
            while p._sm_senders.get(2, "unset") is not None \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            torn = p._sm_senders.get(2, "unset") is None
            p.failure_ack()
            sh = p.shrink()
            sh.barrier()
            if p.rank == 0:
                ready.set()
            assert P.recovery.await_rejoin(p, 2, timeout=20.0)
            scrubbed = (p.boot_token_of(2), p._sm_senders.get(2),
                        p.boot_token_of(1) is not None)
            total = float(np.asarray(
                p.allreduce(np.float64(p.rank + 1), P.ops.SUM)))
            return torn, scrubbed, total

        def second_life():
            assert ready.wait(30.0)
            p2 = P.TcpProc(2, 3, rejoin_book=book["b"], timeout=15.0,
                           ft=True)
            try:
                return (p2._sm_seg is None,
                        float(np.asarray(p2.allreduce(np.float64(3.0),
                                                      P.ops.SUM))))
            finally:
                p2.close()

        watcher = th.Thread(target=lambda: box.append(
            P.recovery.spawn_replacement(second_life, rank=2)), daemon=True)
        watcher.start()
        res = run_tcp_ft(P, 3, prog, sm=True, timeout=60.0,
                         kwargs_by_rank={r: {"sm_boot_id": "rejoinboot"}
                                         for r in range(3)})
        watcher.join(5.0)
        return res, box[0].result(timeout=30.0)

    ref, got = run(JAX), run(PORT)
    assert got == ref
    assert got == ([(True, (None, None, True), 6.0)] * 2 + ["severed"],
                   (True, 6.0))
    assert tsm.orphaned_ring_files() == jsm.orphaned_ring_files() == []
