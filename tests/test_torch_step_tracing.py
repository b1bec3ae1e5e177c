"""The training step's own phase timer and collective counts, and the
profiler ranges of the port's kernel wrappers and collectives.

- ``make_train_step_optax(timings={})`` on a one-rank gloo mesh (dp 1, tp
  1, 2 layers): the five phases, ``local`` as the sum of the first four,
  and the collectives counted at the dispatch point
  (``Communicator._coll_call_inner``): 22 calls (4 a layer through the f/g
  pair, 12 in ``_sync_grads``, 2 for the loss), as many as a wrapper of the
  same communicators counts, with the payload bytes the wrapper sums.
  Without ``timings`` no ``coll/monitoring`` window stays armed.
- ``coll/monitoring``'s window mode: refcounted arming, tallies by
  communicator whatever the calling thread, ``zmpi.coll.<op>`` ranges
  while armed or profiled.
- A phase's ztrace ``PHASE`` span and its ``zmpi.step.<phase>`` profiler
  range agree on the Unix clock within 1 ms (``wall_of`` and the trace's
  ``trace_start_ns``).
- ``zmpi.kernel.<wrapper>`` ranges on the kernel wrappers, opened only
  while a profiler records.
- On the card (``cuda``-marked, skipped without one): a step with
  ``timings`` calls no ``torch.cuda.synchronize``.  This file imports
  torch and the port only, never jax, so that test runs on a GPU machine
  without JAX::

      python -m pytest --noconftest -p no:cacheprovider -m cuda \\
          tests/test_torch_step_tracing.py
"""

import os
import tempfile
import threading

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from zhpe_ompi_tpu_torch.coll import monitoring
from zhpe_ompi_tpu_torch.comm import communicator as comm_mod
from zhpe_ompi_tpu_torch.models import transformer as tt
from zhpe_ompi_tpu_torch.ops import flash_attention as fa
from zhpe_ompi_tpu_torch.ops import fused_norm as fn
from zhpe_ompi_tpu_torch.parallel import hybrid
from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
from zhpe_ompi_tpu_torch.runtime import ztrace
from zhpe_ompi_tpu_torch.utils.payload import payload_nbytes

SMALL = dict(vocab=64, d_model=16, n_heads=2, d_ff=32, n_layers=2, seq=8)
BATCH = 4
PHASES = ("forward", "loss", "backward", "sync", "optimizer")
#: 4 a layer (the f/g pair), 12 in _sync_grads (8 over dp, 4 over tp), 2
#: for the loss
CALLS = 4 * SMALL["n_layers"] + 12 + 2


class Wrapped:
    """A communicator with its ``allreduce`` counted from outside, as a
    benchmark's wrapper counts it."""

    def __init__(self, comm, tally):
        self._comm = comm
        self._tally = tally

    def __getattr__(self, name):
        return getattr(self._comm, name)

    def allreduce(self, x, op=None, **kw):
        self._tally["calls"] += 1
        self._tally["bytes"] += payload_nbytes(x)
        return self._comm.allreduce(x, op, **kw)


@pytest.fixture
def mesh():
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            yield mesh_mod.make_mesh({"dp": 1, "tp": 1})
        finally:
            dist.destroy_process_group()


@pytest.fixture
def clean_windows():
    yield
    assert monitoring.armed_count() == 0 and not monitoring.active
    assert ztrace.armed_count() == 0 and not ztrace.active


def _params(device="cpu"):
    g = torch.Generator().manual_seed(0)
    L, D, F, V = SMALL["n_layers"], SMALL["d_model"], SMALL["d_ff"], SMALL["vocab"]

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.1).to(device)

    return {"embed": w(V, D), "wqkv": w(L, D, 3, D), "wo": w(L, D, D),
            "w1": w(L, D, F), "w2": w(L, F, D), "ln1": torch.ones(L, D, device=device),
            "ln2": torch.ones(L, D, device=device), "lnf": torch.ones(D, device=device)}


def _batch(device="cpu"):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, SMALL["vocab"], (BATCH, SMALL["seq"]), generator=g)
    tgt = torch.randint(0, SMALL["vocab"], (BATCH, SMALL["seq"]), generator=g)
    return tok.to(device), tgt.to(device)


def _comms(mesh, tally=None):
    dp = comm_mod.Communicator(mesh.get_group("dp"), name="trace_dp")
    tp = comm_mod.Communicator(mesh.get_group("tp"), name="trace_tp")
    if tally is not None:
        dp, tp = Wrapped(dp, tally), Wrapped(tp, tally)
    return dp, tp


def _steps(cfg, dp, tp, timings, n=1, device="cpu"):
    init, step, _ = tt.make_train_step_optax(cfg, dp, tp, timings=timings)
    params = _params(device)
    opt = init(params)
    tok, tgt = _batch(device)
    for _ in range(n):
        params, opt, loss = step(params, opt, tok, tgt)
    return params, loss


def test_step_times_five_phases_and_local_is_their_sum(mesh, clean_windows):
    timings = {}
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    _steps(cfg, *_comms(mesh), timings, n=2)
    for p in PHASES:
        assert timings[p] > 0, p
    assert timings["local"] == pytest.approx(
        sum(timings[p] for p in PHASES[:4]), rel=1e-12)


def test_step_counts_its_collectives_as_a_wrapper_does(mesh, clean_windows):
    timings, tally = {}, {"calls": 0, "bytes": 0}
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    _steps(cfg, *_comms(mesh, tally), timings, n=2)
    assert tally["calls"] == 2 * CALLS
    assert timings["coll_calls"] == tally["calls"]
    assert timings["coll_bytes"] == tally["bytes"]
    assert 0 < timings["coll_host_s"] < timings["local"]


def test_step_bytes_are_the_payloads(mesh, clean_windows):
    """One step's bytes from the shapes: every f32 gradient over dp, the
    tp-replicated ones again over tp, the loss twice, and four (B, S, D)
    activations a layer."""
    timings = {}
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    _steps(cfg, *_comms(mesh), timings)
    p = _params()
    grads = sum(v.numel() for v in p.values())
    replicated = sum(p[n].numel() for n in ("embed", "ln1", "ln2", "lnf"))
    acts = 4 * SMALL["n_layers"] * BATCH * SMALL["seq"] * SMALL["d_model"]
    assert timings["coll_calls"] == CALLS
    assert timings["coll_bytes"] == 4 * (grads + replicated + 2 + acts)


def test_untimed_step_arms_no_window(mesh, clean_windows, monkeypatch):
    armed = []
    real = monitoring.arm
    monkeypatch.setattr(monitoring, "arm", lambda *a, **k: armed.append(1) or real(*a, **k))
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    _steps(cfg, *_comms(mesh), None)
    assert not armed
    assert not monitoring.active and monitoring.armed_count() == 0


def test_step_matches_the_untimed_step(mesh, clean_windows):
    """Timing the step changes none of its arithmetic."""
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    dp, tp = _comms(mesh)
    want, wloss = _steps(cfg, dp, tp, None, n=2)
    got, gloss = _steps(cfg, dp, tp, {}, n=2)
    assert torch.equal(gloss, wloss)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_monitoring_windows_are_refcounted_and_per_communicator(mesh, clean_windows):
    """A window armed over some communicators counts their calls from any
    thread (autograd's device thread runs the backward's collectives) and
    no other communicator's."""
    dp, tp = _comms(mesh)
    x = torch.ones(8)
    outer = monitoring.arm()
    mine = monitoring.arm([dp])
    assert monitoring.active and monitoring.armed_count() == 2
    dp.allreduce(x)
    tp.allreduce(x)
    t = threading.Thread(target=dp.allreduce, args=(torch.ones(2),))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    monitoring.disarm(mine)
    assert monitoring.active
    dp.bcast(x)
    monitoring.disarm(outer)
    monitoring.disarm(outer)
    assert not monitoring.active and monitoring.armed_count() == 0
    dp.allreduce(x)
    assert {k: v[:2] for k, v in mine.ops.items()} == {"allreduce": [2, 40]}
    assert {k: v[:2] for k, v in outer.ops.items()} == {
        "allreduce": [3, 72], "bcast": [1, 32]}
    assert outer.calls == 4 and outer.nbytes == 104 and outer.host_s > 0


def _ranges(prof, prefix):
    return [e.name for e in prof.events() if e.name.startswith(prefix)]


def test_collective_ranges_open_while_armed_or_profiled(mesh, clean_windows, monkeypatch):
    dp, _ = _comms(mesh)
    opened = []
    real = ztrace.profiler_range
    monkeypatch.setattr(ztrace, "profiler_range",
                        lambda name: opened.append(name) or real(name))
    dp.allreduce(torch.ones(4))
    assert opened == []
    tally = monitoring.arm()
    dp.allreduce(torch.ones(4))
    monitoring.disarm(tally)
    assert opened == ["zmpi.coll.allreduce"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dp.bcast(torch.ones(4))
    assert _ranges(prof, "zmpi.coll.") == ["zmpi.coll.bcast"]
    assert tally.calls == 1


def test_phase_span_and_profiler_range_agree_on_the_unix_clock(mesh, clean_windows,
                                                               monkeypatch):
    """Each phase's range opens after its span's first edge and closes
    before its last, so once both are on the Unix clock the span holds the
    range, to within 1 ms on either side, however the host was scheduled
    in between."""
    # a recorder anchored now, as a job's recorder is at its start
    monkeypatch.setattr(ztrace, "_recorder", ztrace.SpanRecorder())
    cfg = tt.Config(**SMALL, dtype=torch.float32)
    dp, tp = _comms(mesh)
    ztrace.arm()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _steps(cfg, dp, tp, {})
        spans = {s["name"]: s for s in ztrace.window() if s["kind"] == ztrace.PHASE}
    finally:
        ztrace.disarm()
    assert set(spans) == {f"step.{p}" for p in PHASES}
    start_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("zmpi.step.")}
    assert set(ranges) == {f"zmpi.step.{p}" for p in PHASES}
    rec = ztrace.recorder()
    for p in PHASES:
        span, rng = spans[f"step.{p}"], ranges[f"zmpi.step.{p}"]
        assert span["rank"] == 0 and "device_ms" not in span
        t0_us = rec.wall_of(span["t0"]) * 1e6 - start_us
        t1_us = rec.wall_of(span["t1"]) * 1e6 - start_us
        assert t0_us - 1e3 < rng.start <= rng.end < t1_us + 1e3, (p, t0_us, rng.start,
                                                                 rng.end, t1_us)


def test_laps_on_the_host_clock():
    timings = {}
    laps = hybrid.Laps(timings, device="cpu")
    with laps.phase("a"):
        pass
    laps.lap("b")
    assert timings == {}
    spent = laps.close()
    assert set(spent) == {"a", "b"} and timings == spent
    assert laps.close() == {}
    off = hybrid.Laps(None)
    with off.phase("a"):
        off.lap("b")
    assert off.close() == {} and off.timings is None


def test_kernel_wrappers_open_ranges_only_while_profiled(monkeypatch):
    opened = []
    real = ztrace.profiler_range
    monkeypatch.setattr(ztrace, "profiler_range",
                        lambda name: opened.append(name) or real(name))
    x = torch.randn(2, 8, 2, 16, requires_grad=True)
    h = torch.randn(4, 32, requires_grad=True)
    g = torch.ones(32)

    def run():
        fa.flash_attention(x, x, x, force=True).sum().backward()
        fn.layer_norm(h, g, force=True).sum().backward()

    run()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    want = ["zmpi.kernel.flash_fwd", "zmpi.kernel.ln_fwd", "zmpi.kernel.ln_bwd"]
    assert sorted(opened) == sorted(want)
    assert sorted(_ranges(prof, "zmpi.kernel.")) == sorted(want)
    for wrapper in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fn.ln_fwd, fn.ln_bwd):
        assert wrapper.__wrapped__.__name__ == wrapper.__name__


@pytest.mark.cuda
def test_timed_step_on_the_card_calls_no_synchronize(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the step's phase events live on the card)")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            m = mesh_mod.make_mesh({"dp": 1, "tp": 1})
            dp, tp = _comms(m)
            cfg = tt.Config(**SMALL, dtype=torch.float32, flash=False, fused_ln=False)
            _steps(cfg, dp, tp, None, device="cuda")  # warm-up
            calls = []
            real = torch.cuda.synchronize
            monkeypatch.setattr(torch.cuda, "synchronize",
                                lambda *a, **k: calls.append(1) or real(*a, **k))
            timings = {}
            _steps(cfg, dp, tp, timings, n=2, device="cuda")
        finally:
            dist.destroy_process_group()
    assert calls == []
    for p in PHASES:
        assert timings[p] > 0, p
    assert timings["coll_calls"] == 2 * CALLS
