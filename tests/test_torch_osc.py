"""The port's thread-plane RMA window (``osc/window.HostWindow``) and the
shared RMA plumbing (``osc/rma_util``), held against the JAX package's.

Every test runs one rank program through ``both(prog)``: a 4-rank thread
universe of the JAX package, then of the port, with ``P`` the package
namespace (``JAX`` or ``PORT``).  Inputs are made from a seed with numpy,
and the results compare equal, exactly (integer and float32 data; a float
accumulate has one origin per element, so no summation order differs):

- put/get under fence, accumulate with SUM/MAX/MIN/PROD/BXOR/REPLACE,
  get_accumulate, fetch_and_op and compare_and_swap;
- the unsigned widths torch cannot add (uint16/32/64): SUM wraps, MAX and
  MIN order as unsigned, as numpy's do in the namesake;
- passive target (exclusive read-modify-write under ``lock``, ``lock_all``),
  PSCW epochs, request-based RMA, dynamic windows (attach, byte
  ``dyn_put``/``dyn_get``) and ``allocate_shared``/``shared_query``;
- the error contract: overruns and lock misuse raise ``WinError`` in
  both packages;
- what the port adds: a CPU-tensor window (RMA lands in the tensor),
  tensor origins, ``get(out=tensor)``, and a tensor on another device
  (``meta`` standing in for CUDA) refused as window memory.
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.osc import rma_util as jrma
from zhpe_ompi_tpu.osc import window as jwindow
from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.osc import rma_util as trma
from zhpe_ompi_tpu_torch.osc import window as twindow
from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse

JAX = NS(name="jax", win=jwindow, ops=jops, errors=jerrors, Universe=JUniverse)
PORT = NS(name="port", win=twindow, ops=tops, errors=terrors,
          Universe=TUniverse)
N = 4
SEED = 1313


def both(prog, n=N):
    """``prog(P, ctx)`` on an n-rank thread universe of each package;
    returns (jax results, port results)."""
    out = []
    for P in (JAX, PORT):
        uni = P.Universe(n)
        try:
            out.append(uni.run(lambda ctx, P=P: prog(P, ctx), timeout=60.0))
        finally:
            getattr(uni, "close", lambda: None)()  # the port's must close
    return out


def same(prog, n=N):
    jax_res, port_res = both(prog, n)
    for a, b in zip(jax_res, port_res):
        _equal(a, b)
    return port_res


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), type(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _data(rank, n, dtype):
    rng = np.random.default_rng(SEED + rank)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), n,
                        dtype=dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_put_get_and_accumulate_ops_under_fence(dtype):
    def prog(P, ctx):
        r, n = ctx.rank, ctx.size
        buf = np.zeros(8 * n, dtype)
        win = P.win.HostWindow.create(ctx, buf)
        win.fence()
        # each rank owns one 8-element block of every target's window
        win.put(_data(r, 8, dtype), (r + 1) % n, 8 * r)
        win.fence()
        got = win.get((r + 1) % n, 8 * r, 8)
        ops = [P.ops.MAX, P.ops.MIN, P.ops.PROD, P.ops.REPLACE, P.ops.SUM]
        if np.dtype(dtype).kind == "i":
            ops.append(P.ops.BXOR)
        for i, op in enumerate(ops):
            win.accumulate(_data(r + 10 * i, 8, dtype), (r + 2) % n, 8 * r,
                           op)
        win.fence()
        old = win.get_accumulate(_data(r + 77, 8, dtype), (r + 3) % n,
                                 8 * r, P.ops.SUM)
        win.fence()
        final = buf.copy()
        win.free()
        return got, old, final

    same(prog)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_unsigned_accumulate_wraps_and_orders_as_unsigned(dtype):
    top = np.iinfo(dtype).max

    def prog(P, ctx):
        r = ctx.rank
        buf = np.array([top - 1, 5, top // 2, 7], dtype) if r == 0 \
            else np.zeros(4, dtype)
        win = P.win.HostWindow.create(ctx, buf)
        win.fence()
        if r == 1:
            win.accumulate(np.array([3], dtype), 0, 0, P.ops.SUM)  # wraps
            win.accumulate(np.array([top], dtype), 0, 1, P.ops.MIN)
            win.accumulate(np.array([top], dtype), 0, 2, P.ops.MAX)
            win.accumulate(np.array([6], dtype), 0, 3, P.ops.BAND)
        win.fence()
        out = buf.copy()
        win.free()
        return out

    res = same(prog, n=2)
    assert res[0].tolist() == [1, 5, top, 6]


def test_counters_cas_and_fetch_and_op():
    def prog(P, ctx):
        r = ctx.rank
        win = P.win.HostWindow.create(ctx, np.zeros(4, np.int64))
        win.fence()
        tickets = [int(win.fetch_and_op(np.int64(1), 0, 0))
                   for _ in range(25)]
        claimed = win.compare_and_swap(np.int64(r + 1), np.int64(0), 0, 1)
        win.fence()
        total = int(win.get(0, 0, 1)[0])
        owner = int(win.get(0, 1, 1)[0])
        win.free()
        return sorted(tickets)[0] >= 0, total, owner != 0, \
            int(claimed) == 0 or int(claimed) == owner

    res = same(prog)
    assert all(x[1] == 100 and x[2] and x[3] for x in res)


def test_passive_target_lock_all_and_request_rma():
    def prog(P, ctx):
        r, n = ctx.rank, ctx.size
        win = P.win.HostWindow.create(ctx, np.zeros(n, np.int64))
        win.fence()
        for _ in range(20):  # exclusive read-modify-write of one word
            win.lock(0, P.win.LOCK_EXCLUSIVE)
            v = win.get(0, 0, 1)
            win.put(v + 1, 0, 0)
            win.unlock(0)
        win.lock_all()
        req = win.rget((r + 1) % n, 0, n)
        win.rput(np.array([r * 3], np.int64), (r + 1) % n, 1 + (r % (n - 1)))
        win.raccumulate(np.array([2], np.int64), 0, n - 1, P.ops.SUM)
        win.flush_all()
        win.unlock_all()
        req.wait()
        win.fence()
        acc = win.rget_accumulate(np.array([0], np.int64), 0, 0,
                                  P.ops.SUM).wait()
        win.fence()
        out = win.get(0)
        win.free()
        return int(acc[0]), out

    res = same(prog)
    assert res[0][0] == 80


def test_pscw_epochs_and_dynamic_windows():
    def prog(P, ctx):
        r, n = ctx.rank, ctx.size
        buf = np.zeros(n, np.float32)
        win = P.win.HostWindow.create(ctx, buf)
        for epoch in range(2):
            if r == 0:
                win.post(list(range(1, n)))
                win.wait_sync()
            else:
                win.start([0])
                win.put(_data(r + epoch, 1, np.float32), 0, r)
                win.complete()
            ctx.barrier()
        exposed = buf.copy()
        win.free()
        dyn = P.win.HostWindow.create_dynamic(ctx)
        region = np.zeros(16, np.int32)
        disp = dyn.attach(region)
        ctx.barrier()
        dyn.dyn_put(np.arange(4, dtype=np.int32) + 10 * r, (r + 1) % n,
                    disp + 4 * 4 * (r % 2))
        ctx.barrier()
        raw = dyn.dyn_get((r + 2) % n, disp, 32)
        ctx.barrier()
        dyn.detach(disp)
        dyn.free()
        shared = P.win.HostWindow.allocate_shared(ctx, 4 * n, np.int32)
        shared.shared_query(r)[...] = r + 1
        ctx.barrier()
        peer = shared.shared_query((r + 1) % n).copy()
        shared.free()
        return exposed, region, raw, peer

    same(prog)


def test_error_contract():
    def prog(P, ctx):
        win = P.win.HostWindow.create(ctx, np.zeros(4, np.int32),
                                      info={"no_locks": "true"})
        names = []
        for call in (lambda: win.put(np.zeros(5, np.int32), 0),
                     lambda: win.get(0, 3, 2),
                     lambda: win.accumulate(np.zeros(2, np.int32), 0, 3),
                     lambda: win.compare_and_swap(1, 0, 0, 9),
                     lambda: win.lock(0),
                     lambda: win.unlock(0),
                     lambda: win.attach(np.zeros(2, np.int8)),
                     lambda: win.shared_query(0)):
            try:
                call()
                names.append(None)
            except P.errors.MpiError as e:
                names.append(type(e).__name__)
        win.free()
        return names

    res = same(prog, n=2)
    assert res[0] == ["WinError"] * 8


def test_port_tensor_windows_and_out_tensors():
    """What the port adds: a CPU tensor as window memory, tensor origins,
    ``get(out=)``; a tensor not on the CPU is refused as window memory."""
    uni = TUniverse(2)

    def prog(ctx):
        r = ctx.rank
        mem = torch.zeros(6, dtype=torch.float32)
        win = twindow.HostWindow.create(ctx, mem)
        win.fence()
        win.put(torch.arange(3, dtype=torch.float32) + 10 * r, 1 - r, 3 * r)
        win.accumulate(torch.ones(1), 1 - r, 0, tops.SUM)
        win.fence()
        out = torch.empty(6)
        assert win.get(r, out=out) is out
        win.free()
        with pytest.raises(terrors.WinError, match="host memory"):
            twindow.HostWindow.create(ctx, torch.zeros(2, device="meta"))
        with pytest.raises(terrors.TypeError_, match="bfloat16"):
            trma.host_array(torch.zeros(2, dtype=torch.bfloat16))
        return mem.tolist(), out.tolist()

    try:
        res = uni.run(prog)
    finally:
        uni.close()
    assert res[0][0] == res[0][1] == [1.0, 0.0, 0.0, 10.0, 11.0, 12.0]
    assert res[1][0] == res[1][1] == [1.0, 1.0, 2.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_MAX", "MPI_MIN",
                                    "MPI_PROD", "MPI_BAND", "MPI_BOR",
                                    "MPI_BXOR", "MPI_LAND", "MPI_REPLACE",
                                    "MPI_NO_OP"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64, np.int16, np.int64])
def test_apply_op_matches_the_namesakes_numpy_combine(opname, dtype):
    """``rma_util.apply_op`` (the port's torch combine on numpy operands)
    equals the namesake's numpy combine bit for bit, edges of every
    width included."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(SEED)
    edge = np.array([info.min, info.max, 0, 1, info.max - 1, info.min + 1],
                    dtype)
    a = np.concatenate([edge, rng.integers(info.min, info.max, 26,
                                           dtype=dtype, endpoint=True)])
    b = np.concatenate([edge[::-1], rng.integers(info.min, info.max, 26,
                                                 dtype=dtype, endpoint=True)])
    want = jops.lookup(opname)(a, b.copy())
    got = trma.apply_op(tops.lookup(opname), a, b.copy())
    assert np.asarray(want).astype(dtype).tobytes() == got.tobytes()
    assert got.dtype == np.dtype(dtype)


def test_fetch_op_mixin_is_shared():
    assert issubclass(twindow.HostWindow, trma.FetchOpMixin)
    assert jrma.completed_request(3).wait() == \
        trma.completed_request(3).wait() == 3
