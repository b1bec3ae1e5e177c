"""The port's active-message RMA window (``osc/am.AmWindow``, ``AmService``,
``create_window``) over ``TcpProc`` ranks, held against the JAX package's.

Every universe here is 4 ``TcpProc`` ranks in threads with ``sm=False``
(the AM path alone; ``tests/test_torch_osc_direct.py`` holds the
direct-map plane), made by ``run_tcp_threads``:

- ``same(prog)`` runs one rank program on a JAX-package universe and on a
  port universe with seeded numpy inputs; the results compare equal,
  exactly (int64 and float32; float accumulates have one origin per
  element): fence epochs with put/get/accumulate/get_accumulate, counters
  by fetch_and_op and compare_and_swap, exclusive and shared passive
  target, PSCW, request-based RMA, dynamic windows with typed strided
  ``dyn_iput``/``dyn_iget``, ``dyn_amo`` and the distributed per-key locks
  (the shmem substrate), and the error contract (overrun and unknown
  window raise ``WinError`` through the reply; ``allocate_shared`` over a
  wire endpoint raises).
- A mixed job: ranks 0 and 2 are the port's, 1 and 3 the JAX package's,
  all on one AM window: every rank's puts and accumulates land in every
  other rank's window, whichever package serves it, and the counters
  agree with the same job run by the JAX package alone.
- bfloat16: the port refuses a bfloat16 origin at the origin, before any
  message leaves (dss has no bfloat16), and the window stays serviceable;
  the bits cross as int16 and equal the namesake's bfloat16 bits.
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.osc import am as jam
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.runtime import spc as jspc
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.osc import am as tam
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.runtime import spc

from _torch_dist_worker import run_tcp_threads
from test_torch_osc import _data, _equal

JAX = NS(name="jax", am=jam, ops=jops, errors=jerrors, Proc=JTcpProc, spc=jspc)
PORT = NS(name="port", am=tam, ops=tops, errors=terrors, Proc=TcpProc,
          spc=spc)
N = 4


def run(P, prog, kinds=None, n=N):
    kinds = kinds or [P.Proc] * n
    return run_tcp_threads(n, lambda p: prog(_ns(p), p), kinds=kinds,
                           sm=False)


def _ns(p):
    return PORT if isinstance(p, TcpProc) else JAX


def same(prog, n=N):
    jax_res = run(JAX, prog, n=n)
    port_res = run(PORT, prog, n=n)
    for a, b in zip(jax_res, port_res):
        _equal(a, b)
    return port_res


@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_fence_epochs_counters_and_request_rma(dtype):
    def prog(P, p):
        r, n = p.rank, p.size
        buf = np.zeros(8 * n, dtype)
        win = P.am.create_window(p, buf)
        assert isinstance(win, P.am.AmWindow)
        win.fence()
        win.put(_data(r, 8, dtype), (r + 1) % n, 8 * r)
        win.fence()
        got = win.get((r + 1) % n, 8 * r, 8)
        for i, op in enumerate([P.ops.MAX, P.ops.MIN, P.ops.SUM]):
            win.accumulate(_data(r + 10 * i, 8, dtype), (r + 2) % n, 8 * r,
                           op)
        win.fence()
        old = win.get_accumulate(_data(r + 77, 8, dtype), (r + 3) % n,
                                 8 * r, P.ops.SUM)
        win.fence()
        req = win.rget((r + 1) % n, 0, 8 * n)
        mine = req.wait()
        win.fence()
        final = buf.copy()
        win.free()
        return got, old, mine, final

    same(prog)


def test_counters_passive_target_and_pscw():
    def prog(P, p):
        r, n = p.rank, p.size
        buf = np.zeros(n + 2, np.int64)
        win = P.am.AmWindow.create(p, buf)
        win.fence()
        for _ in range(10):
            win.fetch_and_op(np.int64(1), 0, 0)
        win.compare_and_swap(np.int64(r + 1), np.int64(0), 0, 1)
        win.fence()
        for _ in range(5):
            win.lock(1, jam.LOCK_EXCLUSIVE)
            v = win.get(1, 2, 1)
            win.put(v + 1, 1, 2)
            win.unlock(1)
        win.lock(2, jam.LOCK_SHARED)
        seen = win.get(2, 0, n)
        win.unlock(2)
        win.fence()
        if r == 0:
            win.post(list(range(1, n)))
            win.wait_sync()
        else:
            win.start([0])
            win.put(np.array([r * 7], np.int64), 0, 2 + r % 2)
            win.raccumulate(np.array([1], np.int64), 0, n + 1, P.ops.SUM)
            win.complete()
        win.fence()
        out = win.get(r, 0, n + 2) if r == 0 else win.get(0, 0, 1)
        counted = int(win.get(1, 2, 1)[0])
        win.free()
        return seen.shape, out[:1], counted

    res = same(prog)
    assert res[0][1].tolist() == [40] and res[0][2] == 20


def test_dynamic_typed_strided_amos_and_distributed_locks():
    def prog(P, p):
        r, n = p.rank, p.size
        win = P.am.AmWindow.create_dynamic(p)
        region = np.zeros(32, np.int32)
        disp = win.attach(region)
        p.barrier()
        tgt = (r + 1) % n
        win.dyn_iput(np.arange(4, dtype=np.int32) + 100 * r, tgt, disp, tst=3)
        win.dyn_put(np.array([r, -r], np.int32), tgt, disp + 4 * 20)
        win.flush_all()
        p.barrier()
        strided = win.dyn_iget((r + 2) % n, disp, 4, np.int32, sst=3)
        raw = win.dyn_get((r + 3) % n, disp + 4 * 20, 8)
        olds = [int(win.dyn_amo(0, disp + 4 * 30, "add", np.int32, value=2))
                for _ in range(5)]
        win.dist_lock(0, 7)
        v = win.dyn_get(0, disp + 4 * 31, 4).view(np.int32)[0]
        win.dyn_put(np.array([v + 1], np.int32), 0, disp + 4 * 31)
        win.flush(0)
        win.dist_unlock(0, 7)
        p.barrier()
        final = region.copy() if r == 0 else None
        taken = win.dist_trylock(0, 9) if r == 0 else None
        if r == 0:
            win.dist_unlock(0, 9)
        win.flush_all()
        p.barrier()
        win.detach(disp)
        win.free()
        return strided, raw, min(olds) >= 0, final, taken

    res = same(prog)
    assert res[0][3][30] == 40 and res[0][3][31] == 4 and res[0][4] is True


def test_target_errors_travel_back_typed():
    def prog(P, p):
        win = P.am.AmWindow.create(p, np.zeros(4, np.int64))
        names = []
        peer = (p.rank + 1) % p.size
        for call in (lambda: win.get(peer, 3, 2),
                     lambda: win.get_accumulate(np.zeros(3, np.int64), peer,
                                                2, P.ops.SUM),
                     lambda: win.compare_and_swap(1, 0, peer, 9),
                     lambda: win._rpc(peer, ("get", 999, 0, 1)),
                     lambda: P.am.AmWindow.allocate_shared(p, 8)):
            try:
                call()
                names.append(None)
            except P.errors.MpiError as e:
                names.append(type(e).__name__)
        win.fence()
        win.free()
        return names

    res = same(prog)
    assert res[0] == ["WinError"] * 5


def test_mixed_job_shares_one_am_window():
    """Ranks 0 and 2 the port's, 1 and 3 the JAX package's, one window:
    each rank's service applies the other package's messages."""
    def prog(P, p):
        r, n = p.rank, p.size
        buf = np.zeros(4 * n + 1, np.int64)
        win = P.am.AmWindow.create(p, buf)
        win.fence()
        for t in range(n):
            win.put(np.arange(4, dtype=np.int64) + 10 * r + 100 * t, t, 4 * r)
            win.accumulate(np.array([r + 1], np.int64), t, 4 * n, P.ops.SUM)
        win.fence()
        ticket = int(win.fetch_and_op(np.int64(1), 3, 4 * n))
        win.fence()
        gets = [win.get(t, 0, 4 * n + 1) for t in range(n)]
        win.fence()
        win.free()
        return gets, ticket >= 10

    base = run(JAX, prog)
    a0, j0 = spc.read("osc_am_applied"), jspc.read("osc_am_applied")
    mixed = run(None, prog, kinds=[TcpProc, JTcpProc, TcpProc, JTcpProc])
    for a, b in zip(base, mixed):
        _equal(a, b)
    assert mixed[0][0][3][-1] == 10 + 4
    # both packages' services applied the other's puts
    assert spc.read("osc_am_applied") - a0 == 2 * 3
    assert jspc.read("osc_am_applied") - j0 == 2 * 3


def test_bfloat16_is_refused_at_the_origin_and_bits_cross_as_int16():
    bits = torch.tensor([1.0, -2.5, 3.25, 0.0078125],
                        dtype=torch.bfloat16)

    def prog(P, p):
        win = P.am.AmWindow.create(p, np.zeros(4, np.int16))
        win.fence()
        if P is PORT and p.rank == 0:
            sent = spc.read("tcp_bytes_sent")
            with pytest.raises(terrors.TypeError_, match="bfloat16"):
                win.put(bits, 1)
            assert spc.read("tcp_bytes_sent") == sent
            win.put(bits.view(torch.int16), 1)
        elif P is JAX and p.rank == 0:
            import ml_dtypes

            win.put(bits.float().numpy().astype(ml_dtypes.bfloat16)
                    .view(np.int16), 1)
        win.fence()
        got = win.get(1)
        win.fence()
        win.free()
        return got

    res = same(prog, n=2)
    assert res[0].tobytes() == bits.view(torch.int16).numpy().tobytes()
