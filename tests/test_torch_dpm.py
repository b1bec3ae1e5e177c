"""The port's dynamic process management (``comm/dpm.py`` on the thread
plane, ``comm/dpm_wire.py`` over ``TcpProc`` with the ``bridge_endpoint``/
``bridge_send`` seam), held against the JAX package's.

- Thread plane, ``same(prog)``: one program on each package's universe —
  ``spawn`` of 3 children with the inter-collective set across the bridge
  (bcast from either side, allreduce of the remote group, allgather,
  rooted reduce/gather/scatter, barrier), ``get_parent`` returning one
  communicator, and ``open_port``/``accept``/``connect`` between two
  universes with pt2pt both ways; the results compare equal.
- Wire plane, mixed: a port group of 2 ``connect``s to a JAX-package group
  of 3 that ``accept``s (and the reverse); bridged pt2pt and the inter
  collectives agree with the same run between two JAX-package groups.
- ``dpm_wire.spawn`` (``method="spawn"``, the namesake's default): a port
  group of 2 spawns 2 child processes, which read a float32 file the
  parents wrote through their own ``WireFile`` and return its sum; the
  bridge's frames count on ``tcp_lazy_connects``.  ``method="fork"``
  warns.
"""

import threading
from types import SimpleNamespace as NS

import numpy as np
import pytest

from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.coll import inter as jinter
from zhpe_ompi_tpu.comm import dpm as jdpm
from zhpe_ompi_tpu.comm import dpm_wire as jdw
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.coll import inter as tinter
from zhpe_ompi_tpu_torch.comm import dpm as tdpm
from zhpe_ompi_tpu_torch.comm import dpm_wire as tdw
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc
from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse

import _torch_dist_worker
from _torch_dist_worker import run_tcp_threads
from test_torch_osc import _equal

JAX = NS(name="jax", dpm=jdpm, dw=jdw, ops=jops, inter=jinter,
         Universe=JUniverse, Proc=JTcpProc)
PORT = NS(name="port", dpm=tdpm, dw=tdw, ops=tops, inter=tinter,
          Universe=TUniverse, Proc=TcpProc)


def _close(uni):
    getattr(uni, "close", lambda: None)()  # the port's universes close


def _plain(x):
    """Results as plain Python/numpy values: the port's pt2pt hands CPU
    tensors and its inter collectives Python scalars where the namesake
    hands numpy (ROADMAP C5); the values compare exactly."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray) and x.ndim == 0 or isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def spawn_program(P):
    uni = P.Universe(2)

    def child_main(ctx):
        parent = P.dpm.get_parent(ctx)
        assert parent is P.dpm.get_parent(ctx)
        got = parent.bcast(None, root=0)
        s = parent.allreduce((ctx.rank + 1) * 10, P.ops.SUM)
        g = parent.allgather(f"c{ctx.rank}")
        parent.reduce(ctx.rank + 100, P.ops.SUM, root=0)
        parent.barrier()
        return got, s, g

    def main(ctx):
        ic, handle = P.dpm.spawn(uni, ctx, child_main, n_children=3)
        root = P.inter.ROOT if ctx.rank == 0 else P.inter.PROC_NULL
        ic.bcast(np.arange(3, dtype=np.int64) if ctx.rank == 0 else None,
                 root=root)
        s = ic.allreduce(ctx.rank + 1, P.ops.SUM)
        g = ic.allgather(f"p{ctx.rank}")
        red = ic.reduce(None, P.ops.SUM, root=root)
        ic.barrier()
        kids = handle.join() if ctx.rank == 0 else None
        return s, g, red, kids, ic.remote_size

    try:
        return uni.run(main, timeout=60.0)
    finally:
        _close(uni)


def test_thread_plane_spawn_and_inter_collectives():
    ref, got = _plain(spawn_program(JAX)), _plain(spawn_program(PORT))
    _equal(ref, got)
    assert got[0][0] == 60 and got[0][4] == 3
    assert got[0][2] == 300 + 3


def connect_program(P):
    a, b = P.Universe(2), P.Universe(3)
    name = P.dpm.open_port()
    out = {}

    def side_a(ctx):
        ic = P.dpm.accept(name, a, ctx)
        ic.send(np.full(2, ctx.rank, np.int32), dest=ctx.rank, tag=4)
        got = ic.recv(source=ctx.rank, tag=5)
        return ic.remote_size, _plain(got)

    def side_b(ctx):
        ic = P.dpm.connect(name, b, ctx)
        if ctx.rank < 2:
            got = ic.recv(source=ctx.rank, tag=4)
            ic.send(np.full(3, 10 + ctx.rank, np.int32), dest=ctx.rank, tag=5)
            return ic.remote_size, _plain(got)
        return ic.remote_size, None

    ta = threading.Thread(target=lambda: out.__setitem__("a", a.run(side_a)))
    tb = threading.Thread(target=lambda: out.__setitem__("b", b.run(side_b)))
    try:
        ta.start()
        tb.start()
        ta.join(60.0)
        tb.join(60.0)
    finally:
        P.dpm.close_port(name)
        _close(a)
        _close(b)
    return out["a"], out["b"]


def test_thread_plane_ports_accept_connect():
    ref, got = _plain(connect_program(JAX)), _plain(connect_program(PORT))
    _equal(ref, got)
    assert got[0][1][0] == 3 and got[0][1][1].tolist() == [11, 11, 11]
    assert got[1][0][0] == 2 and got[1][0][1].tolist() == [0, 0]


def two_groups(kind_a, kind_b, na=2, nb=3):
    """Group A (``kind_a`` ranks) accepts on a port opened by A's rank 0
    of A's package; group B (``kind_b``) connects; both run the same
    bridged program.  Returns (A's results, B's results)."""
    A = PORT if kind_a is TcpProc else JAX
    port = A.dw.open_port()
    out = {}

    def side_a(p):
        P = PORT if isinstance(p, TcpProc) else JAX
        ic = P.dw.accept(port if p.rank == 0 else None, p)
        return bridged(P, p, ic, "a")

    def side_b(p):
        P = PORT if isinstance(p, TcpProc) else JAX
        ic = P.dw.connect(port.name, p)
        return bridged(P, p, ic, "b")

    ta = threading.Thread(target=lambda: out.__setitem__(
        "a", run_tcp_threads(na, side_a, kinds=[kind_a] * na, sm=False)))
    tb = threading.Thread(target=lambda: out.__setitem__(
        "b", run_tcp_threads(nb, side_b, kinds=[kind_b] * nb, sm=False)))
    try:
        ta.start()
        tb.start()
        ta.join(90.0)
        tb.join(90.0)
    finally:
        port.close()
    return out["a"], out["b"]


def bridged(P, p, ic, side):
    r = p.rank
    if side == "a":
        root = P.inter.ROOT if r == 1 else P.inter.PROC_NULL
        ic.bcast({"cfg": 42} if r == 1 else None, root=root)
        ic.send(np.arange(4, dtype=np.int64) * (r + 1), dest=r, tag=7)
        got = None
    else:
        got = ic.bcast(None, root=1)
        pt = ic.recv(source=r, tag=7) if r < 2 else None
        got = (got, None if pt is None else np.asarray(pt).tolist())
    their = ic.allreduce((r + 1) * (1 if side == "a" else 10), P.ops.SUM)
    theirs = ic.allgather(f"{side}{r}")
    ic.barrier()
    return got, their, theirs, ic.remote_size


@pytest.mark.parametrize("kinds", ["port_connects", "jax_connects"])
def test_wire_bridge_between_the_packages(kinds):
    ref = two_groups(JTcpProc, JTcpProc)
    a, b = (JTcpProc, TcpProc) if kinds == "port_connects" \
        else (TcpProc, JTcpProc)
    ref, got = _plain(ref), _plain(two_groups(a, b))
    _equal(ref, got)
    assert got[0][0][1] == 60 and got[1][0][1] == 3
    assert got[1][1][0] == [{"cfg": 42}, [0, 2, 4, 6]]


def test_wire_spawn_children_read_the_parents_file(tmp_path):
    path = str(tmp_path / "ce.bin")
    values = np.random.default_rng(13).standard_normal(64).astype(np.float32)
    values.tofile(path)

    def main(p):
        ic, handle = tdw.spawn(p, _torch_dist_worker.dpm_child,
                               n_children=2, timeout=120.0)
        root = tinter.ROOT if p.rank == 0 else tinter.PROC_NULL
        ic.bcast((path, values.size) if p.rank == 0 else None, root=root)
        reports = sorted(ic.recv(source=r, tag=11) for r in range(2)) \
            if p.rank == 0 else None
        total = ic.allreduce(0.0, tops.SUM)
        ic.barrier()
        if p.rank == 0:
            handle.join(120.0)
        return reports, float(total)

    res = run_tcp_threads(2, main, sm=False, timeout=180.0,
                          rank_timeout=120.0)
    want = float(values.astype(np.float64).sum())
    reports, total = res[0]
    assert [(r[0], r[1]) for r in reports] == [(0, 3), (1, 3)]
    # two float64 half sums against one: reassociation only
    assert abs(total - want) < 1e-12 and res[1][1] == total


def test_fork_method_warns():
    with pytest.warns(RuntimeWarning, match="spawn"):
        with pytest.raises(Exception):
            tdw.spawn(NS(rank=1), lambda *a: None, 1, method="fork")


def test_python_float_reductions_keep_double_precision():
    """The port's host reductions of Python floats ran in torch's float32
    default (0.1 + 0.2 came back 0.30000001192092896); the namesake
    reduces them in float64.  Intra- and inter-group, the port now gives
    the namesake's bits."""
    def prog(P, ctx):
        x = 0.1 * (ctx.rank + 1) + 1e-9
        return (ctx.allreduce(x, P.ops.SUM), ctx.reduce(x, P.ops.PROD),
                ctx.allreduce(complex(x, -x), P.ops.SUM))

    out = []
    for P in (JAX, PORT):
        uni = P.Universe(3)
        try:
            out.append(_plain(uni.run(lambda ctx, P=P: prog(P, ctx))))
        finally:
            _close(uni)
    assert out[0] == out[1]
    assert out[1][0][0] == 0.1 + 1e-9 + 0.2 + 1e-9 + (0.1 * 3 + 1e-9)
    assert isinstance(out[1][0][0], float)
