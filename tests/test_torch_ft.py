"""The port's pessimistic message logging (``ft/vprotocol.py``) and
bookmark quiescence (``ft/crcp.py``) held against the JAX package's: the
counterparts of ``tests/test_ft.py``'s ``TestVprotocol`` and ``TestCrcp``,
each program run on both packages with equal outcomes, plus the lazy
exports of ``ft/__init__.py``."""

import numpy as np
import pytest

import zhpe_ompi_tpu.ft as jft
import zhpe_ompi_tpu_torch.ft as tft
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.pt2pt import universe as juniverse
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.pt2pt import universe as tuniverse

N = 4
ANY_SOURCE = -1

_OPENED: list = []


def _port_universe(n):
    uni = tuniverse.LocalUniverse(n)
    _OPENED.append(uni)
    return uni


PKGS = [(jft, jerrors, juniverse.LocalUniverse),
        (tft, terrors, _port_universe)]


@pytest.fixture(autouse=True)
def _close_port_universes():
    yield
    for uni in _OPENED:
        uni.close()
    _OPENED.clear()


def same(run):
    ref = run(*PKGS[0])
    got = run(*PKGS[1])
    assert got == ref, (got, ref)
    return got


def ring_program(ctx):
    """The namesake's ring-and-gather program (enough wildcard
    nondeterminism to make replay meaningful)."""
    acc = ctx.rank
    for lap in range(2):
        if ctx.rank == 0:
            ctx.send(acc, dest=1, tag=lap)
            acc = ctx.recv(source=N - 1, tag=lap)
        else:
            got = ctx.recv(source=ctx.rank - 1, tag=lap)
            acc = acc + got
            ctx.send(acc, dest=(ctx.rank + 1) % N, tag=lap)
    if ctx.rank == 0:
        for _ in range(N - 1):
            acc += ctx.recv(source=ANY_SOURCE, tag=99)
    else:
        ctx.send(ctx.rank * 100, dest=0, tag=99)
    return acc


def test_lazy_exports_match():
    assert tft.__all__ == jft.__all__
    for name in tft.__all__:
        assert getattr(tft, name).__name__ == getattr(jft, name).__name__


def test_logged_run_matches_plain():
    def run(ft, errors, universe):
        plain = universe(N).run(ring_program)
        logged = ft.UniverseLogger(universe(N)).run_logged(ring_program)
        return plain, logged

    plain, logged = same(run)
    assert logged == plain


def test_replay_reproduces_rank():
    def run(ft, errors, universe):
        logger = ft.UniverseLogger(universe(N))
        live = logger.run_logged(ring_program)
        out = []
        for rank in range(N):
            ctx = logger.replay_context(rank)
            out.append((ring_program(ctx) == live[rank],
                        ctx.fully_replayed))
        return live, out

    _, out = same(run)
    assert out == [(True, True)] * N


def test_replay_detects_divergence():
    def run(ft, errors, universe):
        logger = ft.UniverseLogger(universe(2))

        def prog(ctx):
            if ctx.rank == 0:
                ctx.send(b"x", dest=1, tag=3)
                return 0
            return ctx.recv(source=0, tag=3)

        res = logger.run_logged(prog)
        bad = logger.replay_context(0)
        with pytest.raises(errors.InternalError, match="divergence"):
            bad.send(b"x", dest=1, tag=4)
        return res

    assert same(run) == [0, b"x"]


def test_event_counts():
    def run(ft, errors, universe):
        logger = ft.UniverseLogger(universe(N))
        logger.run_logged(ring_program)
        return [logger.event_counts(r) for r in range(N)]

    assert same(run)[0] == (2, 5)


def test_quiescent_after_balanced_traffic():
    def run(ft, errors, universe):
        coord = ft.BookmarkCoordinator(universe(N))

        def prog(ctx):
            b = coord.wrap(ctx)
            b.send(ctx.rank, dest=(ctx.rank + 1) % N, tag=0)
            b.recv(source=(ctx.rank - 1) % N, tag=0)
            return True

        coord._uni.run(prog)
        coord.require_quiescent()
        sent, recvd = coord.bookmarks()
        return coord.quiescent(), sent.tolist(), recvd.tolist()

    q, sent, recvd = same(run)
    assert q and np.sum(sent) == N and np.sum(recvd) == N


def test_in_flight_detected():
    def run(ft, errors, universe):
        uni = universe(2)
        coord = ft.BookmarkCoordinator(uni)

        def prog(ctx):
            b = coord.wrap(ctx)
            if ctx.rank == 0:
                b.send(b"dangling", dest=1, tag=7)
            return True

        uni.run(prog)
        with pytest.raises(errors.InternalError, match="0->1"):
            coord.require_quiescent()
        return coord.quiescent(), coord.in_flight().tolist()

    q, inflight = same(run)
    assert not q and inflight[0][1] == 1
