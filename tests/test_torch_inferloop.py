"""The port's serving loop (``models/inferloop.py``) against the JAX
package's.

- ``TestTicketQueue`` and ``TestQueueDepthPolicy``: the namesake's cases
  on each package (``P`` is the package's namespace), and one backlog
  sequence through both packages' ``QueueDepthPolicy.decide`` giving the
  same decisions.
- ``TestServeLoop`` and ``TestMidServeKillDrill`` on a ``LocalUniverse``
  of each package: the same requests give the same values, steps and
  counter deltas (a rank killed with a batch in flight: the survivors
  requeue it, recover, and the respawned full-size fleet serves every
  ticket).
- A small flagship serve (d_model 64, 2 layers, f32, ``device="cpu"``):
  the port's ``FtInferLoop`` on 4 thread ranks serves 8 requests, each
  row's mean next-token cross-entropy and last-position argmax computed
  by the rank that holds it and gathered over the host plane; the JAX
  package's ``forward`` scores the same sequences on the same numpy
  parameters.  Tolerance 1e-4 absolute on the mean cross-entropy (f32
  on both sides; the two packages' f32 sums differ in order only); the
  argmaxes are equal.
- The closed-loop elastic serve under the port's daemon, with real
  processes: a ``LoadController`` scrapes the published backlog through
  the ``metrics`` RPC, its ``QueueDepthPolicy`` votes to grow, and the
  loop adopts the resize at a step boundary.

The autouse hygiene fixture is ``test_torch_dvm_tree``'s: no serving
thread, parked ticket, daemon or publisher may be left.
"""

import time
import types

import numpy as np
import pytest
import torch

from test_torch_dvm_tree import JAX, PORT, script, wait_for
from test_torch_dvm_tree import _port_runtime_hygiene  # noqa: F401 - autouse
from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.core import errhandler as jerrh
from zhpe_ompi_tpu.ft import recovery as jrecovery
from zhpe_ompi_tpu.ft import ulfm as julfm
from zhpe_ompi_tpu.models import inferloop as jil
from zhpe_ompi_tpu.pt2pt import universe as juni
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errhandler as terrh
from zhpe_ompi_tpu_torch.ft import recovery as trecovery
from zhpe_ompi_tpu_torch.ft import ulfm as tulfm
from zhpe_ompi_tpu_torch.models import inferloop as til
from zhpe_ompi_tpu_torch.pt2pt import universe as tuni

for _P, _il, _uni, _ops, _rec, _ulfm, _errh in (
        (JAX, jil, juni, jops, jrecovery, julfm, jerrh),
        (PORT, til, tuni, tops, trecovery, tulfm, terrh)):
    _P.il, _P.uni, _P.ops, _P.recovery, _P.ulfm, _P.errh = \
        _il, _uni, _ops, _rec, _ulfm, _errh
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])


def _universe(P, n):
    uni = P.uni.LocalUniverse(n, ft=True)
    return uni


def _run(P, n, prog, timeout=60.0, uni=None):
    uni = uni or _universe(P, n)
    try:
        return uni.run(prog, timeout=timeout)
    finally:
        if P is PORT:
            uni.close()


def _deltas(P, before, names):
    return {n: P.spc.read(n) - before.get(n, 0) for n in names}


# ----------------------------------------------------- request plane --


@BOTH
def test_submit_take_serve_lifecycle(P):
    q = P.il.RequestQueue()
    s0 = P.spc.read("infer_requests_submitted")
    t1, t2, t3 = (q.submit(i) for i in range(3))
    assert P.spc.read("infer_requests_submitted") - s0 == 3
    assert q.depth() == 3
    batch = q.take(2)
    assert [t.payload for t in batch] == [0, 1]
    assert all(t.status == "in-flight" for t in batch)
    q.served(batch, ["a", "b"])
    assert t1.result(1.0) == "a" and t2.result(1.0) == "b"
    assert t1.status == "served"
    q.served(q.take(8), ["c"])
    assert t3.result(1.0) == "c" and q._parked() == []


@BOTH
def test_requeue_preserves_order_and_counts(P):
    q = P.il.RequestQueue()
    r0 = P.spc.read("infer_requeues")
    tickets = [q.submit(i) for i in range(4)]
    q.requeue(q.take(2))
    assert P.spc.read("infer_requeues") - r0 == 2
    assert [t.payload for t in q.take(4)] == [0, 1, 2, 3]
    assert tickets[0].requeues == 1 and tickets[0].status == "in-flight"
    q.abort()


@BOTH
def test_abort_evicts_loudly_and_timeouts_are_typed(P):
    q = P.il.RequestQueue()
    t = q.submit("x")
    with pytest.raises(P.errors.InternalError, match="not served"):
        t.result(0.05)
    q.abort()
    with pytest.raises(P.errors.MpiError):
        t.result(1.0)
    assert t.status == "evicted"
    with pytest.raises(P.errors.UnsupportedError):
        q.submit("y")
    assert P.il.parked_tickets() == []


# ----------------------------------------------------- resize policy --


BACKLOG = [10, 10, 10, 10, 10, 10, 2, 10, 10, 0, 0, 0, 0, "junk", None,
           12.0, "9", 0, 0]


def _policy_run(P, **kw):
    p = P.il.QueueDepthPolicy(**kw)
    live, out = 2, []
    for b in BACKLOG:
        target = p.decide(b, live)
        out.append(target)
        if target is not None:
            live = target
    return out


@pytest.mark.parametrize("kw", [
    dict(high=4, low=1, patience=2, cooldown=2, min_size=1, max_size=4),
    dict(high=8, low=2, patience=2, cooldown=0, min_size=2, max_size=6),
    dict(high=3, low=-1, patience=1, cooldown=3, max_size=4),
    dict(high=4, low=1, patience=1, cooldown=0, max_size=8, step=2)])
def test_queue_depth_policy_matches_namesake(kw):
    got = _policy_run(PORT, **kw)
    assert got == _policy_run(JAX, **kw)
    assert any(t is not None for t in got)


def test_policy_reads_the_mca_defaults():
    saved = {n: PORT.var.get(n) for n in ("infer_resize_high",
                                          "infer_resize_patience",
                                          "infer_resize_cooldown")}
    try:
        PORT.var.set_var("infer_resize_high", 1)
        PORT.var.set_var("infer_resize_patience", 1)
        PORT.var.set_var("infer_resize_cooldown", 0)
        assert til.QueueDepthPolicy(max_size=8).decide(2, 2) == 3
    finally:
        for n, v in saved.items():
            PORT.var.set_var(n, v)


# ------------------------------------------- serving (thread plane) ---


def _sum_infer(P):
    def infer(ep, state, batch):
        return state, [float(ep.allreduce(np.float64(x), P.ops.SUM))
                       for x in batch]
    return infer


SERVE_COUNTERS = ("infer_requests_submitted", "infer_requests_served",
                  "infer_requeues", "infer_resizes")


def _serve_collectively(P):
    before = P.spc.snapshot()

    def prog(ctx):
        loop = P.il.FtInferLoop(ctx, infer_fn=_sum_infer(P), state=None,
                                batch_max=2)
        if ctx.rank == 0:
            ts = [loop.queue.submit(i) for i in range(5)]
            loop.start()
            vals = [t.result(20.0) for t in ts]
            loop.stop()
            return vals, loop.served, [t.status for t in ts]
        loop.serve()
        return None

    res = _run(P, 4, prog)
    return res[0], _deltas(P, before, SERVE_COUNTERS)


def test_continuous_batching_serves_as_the_namesake():
    port, jax = _serve_collectively(PORT), _serve_collectively(JAX)
    assert port == jax
    vals, served, statuses = port[0]
    assert vals == [0.0, 4.0, 8.0, 12.0, 16.0] and served == 5
    assert statuses == ["served"] * 5
    assert port[1]["infer_requests_served"] == 5


@BOTH
def test_stop_evicts_queued_requests_loudly(P):
    def prog(ctx):
        loop = P.il.FtInferLoop(ctx, infer_fn=_sum_infer(P), state=None)
        if ctx.rank == 0:
            loop.start()
            assert loop.queue.submit(1).result(20.0) == 2.0
            loop._stop.set()
            time.sleep(0.1)
            try:
                late = loop.queue.submit(2)
            except P.errors.UnsupportedError:
                late = None
            loop.stop()
            return late.status if late is not None else "refused"
        loop.serve()
        return None

    assert _run(P, 2, prog)[0] in ("evicted", "refused")


@BOTH
def test_needs_ft(P):
    with pytest.raises(P.errors.UnsupportedError, match="ft=True"):
        P.il.FtInferLoop(types.SimpleNamespace(ft_state=None),
                         infer_fn=_sum_infer(P), state=None)


def _kill_drill(P):
    n, victim, kill_step = 4, 2, 2
    uni = _universe(P, n)
    handles = {}
    before = P.spc.snapshot()

    def make_loop(ctx, first_life):
        ctx.set_errhandler(P.errh.ERRORS_RETURN)
        steps = [0]

        def infer_fn(ep, st, batch):
            if first_life and ctx.rank == victim:
                steps[0] += 1
                if steps[0] == kill_step:
                    P.ulfm.expect_failure(ctx.ft_state, victim)
                    raise P.ulfm.RankKilled(victim)
            return _sum_infer(P)(ep, st, batch)

        def respawner(victims):
            handles.update(P.recovery.respawn_ranks(uni, victims,
                                                    second_life))

        return P.il.FtInferLoop(ctx, infer_fn=infer_fn, state=None,
                                batch_max=1, respawner=respawner,
                                rejoin_timeout=30.0)

    def second_life(new_ctx):
        return make_loop(new_ctx, first_life=False).serve()

    def prog(ctx):
        loop = make_loop(ctx, first_life=True)
        if ctx.rank == 0:
            ts = [loop.queue.submit(i) for i in range(8)]
            loop.start()
            vals = [t.result(60.0) for t in ts]
            loop.stop()
            return (vals, loop.recoveries, sum(t.requeues > 0 for t in ts),
                    loop.live.size, [t.status for t in ts])
        loop.serve()
        return loop.recoveries

    res = _run(P, n, prog, timeout=120.0, uni=uni)
    second = handles[victim].result(timeout=30.0)
    return (res[0], res[victim], second, sorted(handles),
            sorted(uni.ft_state.failed()),
            _deltas(P, before, ("infer_requests_served", "infer_requeues")))


def test_kill_mid_serve_requests_complete_or_requeue():
    port, jax = _kill_drill(PORT), _kill_drill(JAX)
    assert port == jax
    (vals, recoveries, requeued, live_size, statuses), first, second, \
        handles, failed, deltas = port
    assert vals == [float(i * 4) for i in range(8)]
    assert statuses == ["served"] * 8
    assert recoveries >= 1 and requeued >= 1 and live_size == 4
    assert first is None and second == "stopped" and handles == [2]
    assert failed == [] and deltas["infer_requeues"] >= 1
    assert deltas["infer_requests_served"] == 8


# --------------------------------------- a small flagship serve (CPU) --


SMALL = dict(vocab=256, d_model=64, n_heads=4, d_ff=128, n_layers=2, seq=32)
CE_TOL = 1e-4


def _score(tfm, params, tokens, cfg, forward):
    """Each row's mean next-token cross-entropy (f32) and last-position
    argmax from ``forward``'s f32 logits."""
    logits = torch.as_tensor(np.array(forward(params, tokens, cfg)),
                             dtype=torch.float32)
    tok = torch.as_tensor(np.asarray(tokens)).long()
    ce = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tok[:, 1:].reshape(-1),
        reduction="none").view(tok.shape[0], -1).mean(1)
    return [(float(c), int(a)) for c, a in zip(ce, logits[:, -1].argmax(-1))]


def test_small_flagship_serve_matches_jax_forward():
    import jax
    import jax.numpy as jnp

    from zhpe_ompi_tpu.models import transformer as jt
    from zhpe_ompi_tpu_torch.models import transformer as tt

    jcfg = jt.Config(**SMALL, dtype=jnp.float32, flash=False, fused_ln=False)
    tcfg = tt.Config(**SMALL, dtype=torch.float32)
    np_params = {k: np.asarray(v) for k, v in
                 jt.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(12)
    seqs = rng.integers(0, SMALL["vocab"], (8, SMALL["seq"]), dtype=np.int64)
    want = _score(jt, np_params, jnp.asarray(seqs), jcfg, jt.forward)
    params = tt.params_from_numpy(np_params, tcfg, device="cpu")

    def infer_fn(ep, state, batch):
        rows = batch[ep.rank::ep.size]
        mine = (_score(tt, state, torch.stack(rows), tcfg, tt.forward)
                if rows else [])
        gathered = ep.allgather(mine)
        return state, [gathered[i % ep.size][i // ep.size]
                       for i in range(len(batch))]

    def prog(ctx):
        loop = til.FtInferLoop(ctx, infer_fn=infer_fn, state=params,
                               batch_max=6)
        if ctx.rank == 0:
            ts = [loop.queue.submit(torch.from_numpy(s)) for s in seqs]
            loop.start()
            got = [t.result(60.0) for t in ts]
            loop.stop()
            return got, loop.steps
        loop.serve()
        return None

    got, steps = _run(PORT, 4, prog, timeout=120.0)[0]
    assert steps >= 2  # batch_max 6: two batches, one with an idle rank
    for (ce, arg), (wce, warg) in zip(got, want):
        assert abs(ce - wce) <= CE_TOL, (ce, wce)
        assert arg == warg


# --------------------------- the closed observability loop (daemon) --


_INFER_ELASTIC_PROG = """
import os
import time

import torch

import zhpe_ompi_tpu_torch as zmpi
from zhpe_ompi_tpu_torch.ft import recovery
from zhpe_ompi_tpu_torch.models.inferloop import FtInferLoop

BURST = int(os.environ.get("TEST_INFER_BURST", "12"))
STEP_S = float(os.environ.get("TEST_INFER_STEP_S", "0.15"))


def infer_fn(ep, st, batch):
    time.sleep(STEP_S)  # a deliberately slow model: the backlog holds
    return st, [float(ep.allreduce(torch.tensor(float(x)), zmpi.SUM)) * 0 + x
                for x in batch]


ep = zmpi.host_init()
ses = recovery.ElasticSession(ep)
loop = FtInferLoop(ep, infer_fn=infer_fn, state=None, elastic=ses,
                   batch_max=1)
if ep.rank == 0:
    tickets = [loop.queue.submit(i) for i in range(BURST)]
    loop.start()
    vals = [t.result(120.0) for t in tickets]
    deadline = time.monotonic() + 60.0
    while loop.resizes < 1 and time.monotonic() < deadline:
        time.sleep(0.2)
    loop.stop()
    ok = vals == [float(i) for i in range(BURST)]
    print(f"INFER-OK served={loop.served} ok={ok} "
          f"resizes={loop.resizes} live={loop.live.size}", flush=True)
else:
    act = loop.serve()
    print(f"EXIT rank={ep.rank} act={act}", flush=True)
ses.close()
zmpi.host_finalize()
"""


def test_load_controller_grows_fleet_from_published_backlog(tmp_path,
                                                            monkeypatch):
    from test_torch_dvm_tree import FT_MCA, bg_launch, finish
    from zhpe_ompi_tpu_torch.runtime import dvm as tdvm

    monkeypatch.setenv("TEST_INFER_BURST", "12")
    prog = script(tmp_path, _INFER_ELASTIC_PROG, "infer_elastic.py")
    r0 = PORT.spc.read("dvm_resizes")
    d = tdvm.Dvm()
    try:
        h = bg_launch(d.address, 2, [prog], ft=True, max_size=4,
                      metrics=True, timeout=180.0,
                      mca=FT_MCA + [("spc_publish_interval_ms", "300")])
        ctl = tdvm.DvmClient(d.address)
        try:
            wait_for(lambda: ctl.stat()["jobs"], 60.0,
                     lambda: h["err"].getvalue())
            job_id = next(iter(ctl.stat()["jobs"]))
            controller = til.LoadController(
                ctl, job_id, policy=til.QueueDepthPolicy(
                    high=3, low=-1, patience=1, cooldown=3, max_size=4),
                resize_timeout=90.0)
            deadline = time.monotonic() + 90.0
            while not controller.applied and time.monotonic() < deadline:
                controller.tick()
                time.sleep(0.25)
        finally:
            ctl.close()
            res = finish(h, 200.0)
        text = h["out"].getvalue()
        assert res == {"rc": 0}, (text, h["err"].getvalue())
        assert controller.applied and controller.applied[0].get("grown")
        assert "resizes=1" in text or "resizes=2" in text, text
        assert "ok=True" in text, text
        assert PORT.spc.read("dvm_resizes") - r0 >= 1
    finally:
        d.stop()
