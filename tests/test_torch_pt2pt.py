"""The port's matching engine, requests and thread universe
(``pt2pt/matching``, ``requests``, ``universe``) against the JAX package's.

- Matching: one seeded script of arrivals and wildcard receives
  (``ANY_SOURCE``/``ANY_TAG``) from 4 sources through the port's engine
  (the native one, by default) and the namesake's Python engine gives the
  same match sequence; at 4 thread ranks, messages whose arrival order
  is fixed by token passing match rank 0's wildcard receives in the same
  order in both universes.
- Universe: eager and rendezvous sizes, buffer reuse (a tensor changed
  after ``send`` returns is not seen), probe/improbe/mrecv, persistent
  requests, ``sendrecv`` and the barrier, against the namesake where the
  result is comparable.
- A plain universe refuses the ULFM surface (``ft=True`` is asked for).

Every universe a test opens is closed (``LocalUniverse.close``), so no
queue is left for a later file on the same worker.
"""

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu.pt2pt import matching as jmatching
from zhpe_ompi_tpu.pt2pt import requests as jrequests
from zhpe_ompi_tpu.pt2pt import universe as juniverse
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt import matching as tmatching
from zhpe_ompi_tpu_torch.pt2pt import requests as trequests
from zhpe_ompi_tpu_torch.pt2pt import universe as tuniverse

ANY = -1


@pytest.fixture(scope="module", autouse=True)
def _no_queue_left_behind():
    """The JAX package's universes built here hold no message or receive
    when this file is done (its quiescence check reads every live one),
    and none of the port's stays live."""
    import gc

    before = [juniverse._queue_depth(k) for k in ("posted", "unexpected")]
    yield
    gc.collect()
    after = [juniverse._queue_depth(k) for k in ("posted", "unexpected")]
    assert all(a <= b for a, b in zip(after, before)), (after, before)
    assert [tuniverse._queue_depth(k) for k in ("posted", "unexpected")] == [0, 0]


def _engine_script(seed):
    rng = np.random.default_rng(seed)
    events, seqs = [], {}
    for _ in range(80):
        if rng.random() < 0.55:
            src = int(rng.integers(0, 4))
            seqs[src] = seqs.get(src, 0) + 1
            events.append(("in", src, int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                           seqs[src]))
        else:
            src = ANY if rng.random() < 0.5 else int(rng.integers(0, 4))
            tag = ANY if rng.random() < 0.5 else int(rng.integers(0, 3))
            events.append(("post", src, tag, int(rng.integers(0, 2))))
    return events


def _run_engine(mod, events):
    eng = mod.make_matching_engine() if mod is tmatching else mod.MatchingEngine()
    got = []
    for i, ev in enumerate(events):
        if ev[0] == "in":
            _, src, tag, cid, seq = ev
            eng.incoming(mod.Envelope(src, tag, cid, seq), f"m{src}.{seq}")
        else:
            _, src, tag, cid = ev
            eng.post_recv(src, tag, cid,
                          lambda env, p, i=i: got.append((i, env.src, env.tag, p)))
    probes = [eng.probe(s, t, c) for s in (ANY, 0, 3) for t in (ANY, 1) for c in (0, 1)]
    return got, [None if p is None else (p.src, p.tag, p.seq) for p in probes], eng.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_match_order_matches_namesake(seed):
    events = _engine_script(seed)
    assert _run_engine(tmatching, events) == _run_engine(jmatching, events)


def test_make_matching_engine_is_the_python_engine(monkeypatch):
    """With the native kernels switched off (``ZOMPI_NATIVE=0``), a new
    endpoint gets the Python engine; by default it gets the native one
    (``tests/test_torch_native.py``)."""
    from zhpe_ompi_tpu_torch import native as tnative

    monkeypatch.setenv("ZOMPI_NATIVE", "0")
    tnative.reset()
    try:
        assert type(tmatching.make_matching_engine()) is \
            tmatching.MatchingEngine
    finally:
        monkeypatch.undo()
        tnative.reset()


def _ordered_wildcards(mod, payload):
    """4 thread ranks: ranks 1..3 send in turn (a token fixes the order in
    which their messages reach rank 0's mailbox), then rank 0 posts
    wildcard receives and records what each matched."""
    uni = mod.LocalUniverse(4)

    def prog(ctx):
        r = ctx.rank
        if r == 0:
            ctx.recv(source=3, tag=99, cid=1, timeout=10.0)  # all sent
            out = []
            for src, tag in [(ANY, ANY), (ANY, 2), (2, ANY), (ANY, 1), (ANY, ANY),
                             (3, ANY), (ANY, ANY), (ANY, ANY), (ANY, ANY)]:
                v, st = ctx.recv(source=src, tag=tag, timeout=10.0, return_status=True)
                out.append((st.source, st.tag, [int(x) for x in np.asarray(v)]))
            return out
        if r > 1:
            ctx.recv(source=r - 1, tag=98, cid=1, timeout=10.0)
        for k, tag in enumerate((1, 2, 1)):
            ctx.send(payload(r * 10 + k), 0, tag=tag)
        ctx.send(b"", 0 if r == 3 else r + 1, tag=99 if r == 3 else 98, cid=1)
        return None

    try:
        return uni.run(prog, timeout=60.0)[0]
    finally:
        if hasattr(uni, "close"):
            uni.close()


def test_wildcard_match_order_at_four_thread_ranks():
    ref = _ordered_wildcards(juniverse, lambda v: np.array([v, v + 1]))
    port = _ordered_wildcards(tuniverse, lambda v: np.array([v, v + 1]))
    port_t = _ordered_wildcards(tuniverse, lambda v: torch.tensor([v, v + 1]))
    assert port == ref == port_t
    assert len(ref) == 9


def _eager_and_rendezvous(mod, make):
    uni = mod.LocalUniverse(2)

    def prog(ctx):
        if ctx.rank == 0:
            small, big = make(8), make(40000)  # 64 B and 320 KB int64
            ctx.send(small, 1, tag=1)
            req = ctx.isend(big, 1, tag=2)
            small[:] = -1  # buffer reuse after send returns: invisible
            req.wait(10.0)
            big[:] = -1
            ctx.barrier()
            return None
        a = ctx.recv(0, tag=1, timeout=10.0)
        b = ctx.recv(0, tag=2, timeout=10.0)
        ctx.barrier()
        return [int(np.asarray(a).sum()), int(np.asarray(b).sum()), type(a).__name__]

    try:
        return uni.run(prog, timeout=60.0)[1]
    finally:
        if hasattr(uni, "close"):
            uni.close()


def test_eager_rendezvous_and_buffer_reuse():
    old = tvar.get("pt2pt_eager_limit")
    assert old == 64 * 1024
    ref = _eager_and_rendezvous(juniverse, lambda n: np.arange(n, dtype=np.int64))
    port = _eager_and_rendezvous(tuniverse, lambda n: np.arange(n, dtype=np.int64))
    port_t = _eager_and_rendezvous(tuniverse, lambda n: torch.arange(n, dtype=torch.int64))
    assert ref[:2] == port[:2] == port_t[:2] == [28, 799980000]
    assert port[2] == "ndarray" and port_t[2] == "Tensor"


def _probe_and_persistent(mod):
    uni = mod.LocalUniverse(2)
    a, b = uni.contexts
    try:
        out = [a.probe(1, 5)]
        b.send(np.arange(3), 0, tag=5)
        env = a.probe(1, 5)
        out.append((env.src, env.tag))
        msg = a.improbe(1, ANY)
        out.append(a.probe(1, 5))
        out.append(list(a.mrecv(msg)))
        with pytest.raises(Exception):
            a.mrecv(msg)
        preq = b.send_init(np.array([7]), 0, tag=6)
        rreq = a.recv_init(1, 6)
        for _ in range(2):
            preq.start()
            rreq.start()
            out.append(list(rreq.wait(5.0)))
            preq.wait(5.0)
            out.append((rreq.status.source, rreq.status.tag))
        out.append(uni.run(lambda c: c.sendrecv(c.rank, 1 - c.rank, source=1 - c.rank),
                           timeout=30.0))
        return out
    finally:
        if hasattr(uni, "close"):
            uni.close()


def test_probe_improbe_persistent_sendrecv():
    assert _probe_and_persistent(tuniverse) == _probe_and_persistent(juniverse)


def test_cuda_like_tensor_stays_on_its_device():
    """The thread plane passes a tensor on any device through (a clone on
    that device, no host copy): a ``meta`` tensor stands in for CUDA here."""
    uni = tuniverse.LocalUniverse(2)
    try:
        t = torch.empty(4, device="meta")
        uni.contexts[0].send(t, 1, tag=1)
        got = uni.contexts[1].recv(0, tag=1, timeout=5.0)
        assert got.device.type == "meta" and got is not t
    finally:
        uni.close()


def test_requests_match_namesake():
    def trace(mod):
        out = []
        r = mod.Request()
        out.append(r.test())
        with pytest.raises(Exception, match="timed out"):
            r.wait(0.01)
        r.complete(np.arange(4, dtype=np.int32), source=2, tag=3)
        out.append((r.wait(), r.status.source, r.status.tag, r.status.count_bytes))
        out.append(r.complete(1))
        g = mod.GeneralizedRequest.start(
            query_fn=lambda ex, st: setattr(st, "tag", ex), extra_state=9)
        g.complete("v")
        out.append((g.wait(), g.status.tag))
        done = mod.SendRequest.completed()
        out.append((mod.wait_all([done, mod.SendRequest.completed()]),
                    mod.test_all([done]), mod.wait_any([done])))
        st = mod.Status(count_bytes=12)

        class Dt:
            size = 4

        out.append(mod.get_count(st, Dt()))
        return [repr(x) for x in out]

    assert trace(trequests) == trace(jrequests)


def test_ft_and_ulfm_wait_for_ft_ulfm():
    # ft/ulfm.py is ported: an ft universe carries its failure state and
    # heartbeat board; a plain one refuses the ULFM surface as the
    # namesake's does (UnsupportedError asking for ft=True)
    ft_uni = tuniverse.LocalUniverse(2, ft=True)
    try:
        assert ft_uni.contexts[0].ft_state is ft_uni.ft_state is not None
        assert ft_uni.ft_board is not None
    finally:
        ft_uni.close()
    uni = tuniverse.LocalUniverse(2)
    try:
        ctx = uni.contexts[0]
        assert ctx.ft_state is None and uni.ft_state is None
        for call in (ctx.failure_ack, ctx.failure_get_acked, ctx.agree,
                     ctx.shrink, lambda: ctx.revoke(1),
                     uni.start_failure_detector, lambda: uni.respawn_rank(1)):
            with pytest.raises(errors.UnsupportedError, match="ft=True"):
                call()
        assert ctx.boot_token_of(1) == ctx.boot_token_of(0)
        assert ctx.numa_token_of(1) == "0"
    finally:
        uni.close()
    assert uni not in tuniverse._live_universes


def test_queue_depth_counts_posted_and_unexpected():
    uni = tuniverse.LocalUniverse(2)
    try:
        before = (tuniverse._queue_depth("posted"), tuniverse._queue_depth("unexpected"))
        req = uni.contexts[1].irecv(0, tag=1)
        uni.contexts[0].send(b"x", 1, tag=2)
        uni.contexts[1].progress()
        assert tuniverse._queue_depth("posted") == before[0] + 1
        assert tuniverse._queue_depth("unexpected", exempt_acked_failed=True) == before[1] + 1
        uni.contexts[0].send(b"y", 1, tag=1)
        assert req.wait(5.0) == b"y"
        assert uni.contexts[1].recv(0, tag=2, timeout=5.0) == b"x"
        assert (tuniverse._queue_depth("posted"), tuniverse._queue_depth("unexpected")) == before
    finally:
        uni.close()
