"""The port's MPI-IO for multi-process jobs (``io/wirefile.py``:
``WireFile``, ``SharedPointerFile``), held against the JAX package's, on 4
``TcpProc`` ranks in threads (sm off):

- ``same(prog)``: one rank program of WireFile calls on a JAX-package
  job, then a port job, each writing its own file; the files' bytes and
  everything read back compare equal, exactly (int32, float32): views
  interleaving the ranks (``create_resized`` of a vector), ``write_all``/
  ``read_all`` with one aggregator and with two (the vulcan shape,
  ``fcoll_wire_aggregators``), ``iwrite_all``/``iread_all``, explicit
  offsets and individual pointers, the shared pointer (``write_shared``,
  ``read_shared``, ``seek_shared``, ``tell_shared``), ``set_size`` and
  ``sync``.
- A mixed job (ranks 0 and 2 the port's, 1 and 3 the JAX package's)
  opens ONE file: its collective write equals the single-package job's
  bytes, and the ``sharedfp/lockedfile`` sidecar (``<path>.zshfp``,
  twenty ASCII digits) hands out disjoint shared-pointer ranges to both
  packages' appends.
- The port's buffers may be tensors; a ``BFLOAT16`` etype reads back as a
  bfloat16 tensor.
"""

import os
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import datatype as jdt
from zhpe_ompi_tpu.io import file as jfile
from zhpe_ompi_tpu.io import wirefile as jwf
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu.pt2pt.tcp import TcpProc as JTcpProc
from zhpe_ompi_tpu_torch import datatype as tdt
from zhpe_ompi_tpu_torch.io import file as tfile
from zhpe_ompi_tpu_torch.io import wirefile as twf
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

from _torch_dist_worker import run_tcp_threads
from test_torch_osc import _data, _equal

JAX = NS(name="jax", wf=jwf, file=jfile, dt=jdt, var=jvar, Proc=JTcpProc)
PORT = NS(name="port", wf=twf, file=tfile, dt=tdt, var=tvar, Proc=TcpProc)
N = 4
MIXED = [TcpProc, JTcpProc, TcpProc, JTcpProc]


def _ns(p):
    return PORT if isinstance(p, TcpProc) else JAX


def run(kinds, prog, path):
    return run_tcp_threads(len(kinds), lambda p: prog(_ns(p), p, path),
                           kinds=kinds, sm=False)


def same(prog, tmp_path):
    out = []
    for P in (JAX, PORT):
        path = str(tmp_path / f"{P.name}.bin")
        res = run([P.Proc] * N, prog, path)
        with open(path, "rb") as f:
            out.append((res, f.read()))
        assert not os.path.exists(path + ".zshfp")  # rank 0 unlinked it
    _equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    return out[1]


@pytest.fixture
def aggregators():
    yield lambda n: [P.var.set_var("fcoll_wire_aggregators", n)
                     for P in (JAX, PORT)]
    for P in (JAX, PORT):
        P.var.unset("fcoll_wire_aggregators")


def _interleaved(P):
    return P.dt.create_resized(P.dt.create_vector(1, 1, 1, P.dt.INT32_T),
                               0, 4 * N)


@pytest.mark.parametrize("naggr", [1, 2])
def test_collective_and_nonblocking_io(aggregators, tmp_path, naggr):
    aggregators(naggr)

    def prog(P, p, path):
        F = P.file
        r = p.rank
        with P.wf.WireFile(p, path, F.MODE_CREATE | F.MODE_RDWR) as f:
            f.set_view(4 * r, P.dt.INT32_T, _interleaved(P))
            f.write_all(_data(r, 10, np.int32))
            f.seek(0)
            back = f.read_all(10 - r)
            req = f.iwrite_all(_data(r + 20, 3, np.int32))
            n = req.wait()
            f.seek(2)
            late = f.iread_all(4).wait()
            f.sync()
            size = f.get_size()
        return back, n, late, size

    got, raw = same(prog, tmp_path)
    want = np.frombuffer(raw, np.int32)
    for r in range(N):
        assert got[r][0].tolist() == _data(r, 10, np.int32)[:10 - r].tolist()
        assert want[r::N][10 - r:13 - r].tolist() == \
            _data(r + 20, 3, np.int32).tolist()


def test_offsets_pointers_and_the_shared_pointer(tmp_path):
    def prog(P, p, path):
        F = P.file
        r = p.rank
        with P.wf.WireFile(p, path, F.MODE_CREATE | F.MODE_RDWR) as f:
            f.write_at(64 * r, _data(r, 16, np.float32).view(np.uint8))
            p.barrier()
            peer = f.read_at(64 * ((r + 1) % N), 64)
            f.set_view(0, P.dt.FLOAT)
            f.seek(16 * r)
            mine = f.read(8)
            f.seek_shared(80)
            p.barrier()
            # one shared append each, in rank order (the pointer is the
            # sidecar's; the order pins the bytes)
            for turn in range(N):
                if turn == r:
                    f.write_shared(np.full(2, r, np.float32))
                p.barrier()
            tell = f.tell_shared()
            f.seek_shared(80)
            p.barrier()
            shared = f.read_shared(2) if r == 0 else None
            p.barrier()
            f.set_size(4 * 90)
            size = f.get_size()
        return peer, mine, tell, shared, size

    got, raw = same(prog, tmp_path)
    assert got[0][2] == 88 and got[0][3].tolist() == [0.0, 0.0]
    assert len(raw) == 4 * 90


def test_mixed_job_shares_one_file_and_one_pointer(tmp_path):
    def prog(P, p, path):
        F = P.file
        r = p.rank
        with P.wf.WireFile(p, path, F.MODE_CREATE | F.MODE_RDWR) as f:
            f.set_view(4 * r, P.dt.INT32_T, _interleaved(P))
            f.write_all(_data(r, 6, np.int32))
            f.set_view(0, P.dt.INT32_T)
            f.seek_shared(4 * 6)
            sidecar = open(path + ".zshfp", "rb").read() if r == 0 else None
            p.barrier()
            for _ in range(5):
                f.write_shared(np.full(3, 1000 + r, np.int32))
            p.barrier()
            end = f.tell_shared()
        return sidecar, end

    ref_path = str(tmp_path / "ref.bin")
    ref = run([JTcpProc] * N, prog, ref_path)
    path = str(tmp_path / "mixed.bin")
    got = run(MIXED, prog, path)
    assert got[0][0] == ref[0][0] == b"%020d" % 24
    assert [g[1] for g in got] == [24 + 4 * 5 * 3] * N
    raw = np.fromfile(path, np.int32)
    refraw = np.fromfile(ref_path, np.int32)
    assert raw[:24].tolist() == refraw[:24].tolist()
    # every append landed whole, in a range no other append took
    records = raw[24:].reshape(-1, 3)
    assert sorted(records[:, 0].tolist()) == sorted(
        [1000 + r for r in range(N)] * 5)
    assert all(len(set(rec)) == 1 for rec in records.tolist())


def test_port_tensor_buffers_and_bfloat16(tmp_path):
    path = str(tmp_path / "t.bin")
    a = torch.from_numpy(_data(3, 8, np.float32))

    def prog(p):
        with twf.WireFile(p, path, tfile.MODE_CREATE | tfile.MODE_RDWR) as f:
            f.set_view(16 * p.rank, tdt.BFLOAT16)
            f.write_all(a.to(torch.bfloat16))
            f.seek(0)
            back = f.read_all(8)
        return back

    res = run_tcp_threads(2, prog, sm=False)
    for back in res:
        assert back.dtype == torch.bfloat16
        assert torch.equal(back, a.to(torch.bfloat16))
