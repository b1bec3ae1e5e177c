"""The port's single-controller MPI-IO (``io/file.py``: ``File``, the modes,
``delete``) and its sub-frameworks (``io/fs.py``, ``io/fcoll.py`` over the
ported ``io/fbtl.py``), held against the JAX package's.

``same(prog, tmp_path)`` runs one program of File calls on the JAX
package, then on the port, each in its own directory, with seeded numpy
buffers; the files' bytes and everything read back compare equal,
exactly:

- explicit-offset, individual-pointer and shared-pointer IO through views
  of derived filetypes (vector, resized, subarray), decoded by the port's
  ``datatype/convertor.byte_index_map``;
- collective ``write_all``/``read_all`` of four interleaved rank views,
  under each fcoll strategy (``two_phase``, ``dynamic`` at a small stripe,
  ``individual``);
- nonblocking ``iwrite_at``/``iread_at``/``iwrite_all``/``iread_all``;
- sizes (``set_size``, ``preallocate``, ``get_size``), ``MODE_APPEND``,
  ``MODE_DELETE_ON_CLOSE``, ``delete`` and the error contract (``EXCL`` on
  an existing file, a missing file, no access mode, a partial etype).

What the port adds: tensors as buffers (a bfloat16 one moves its bits),
and a ``BFLOAT16`` etype reads back as a CPU bfloat16 tensor with the
namesake's ``ml_dtypes.bfloat16`` bytes.
"""

import os
from types import SimpleNamespace as NS

import ml_dtypes
import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import datatype as jdt
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.io import fbtl as jfbtl
from zhpe_ompi_tpu.io import fcoll as jfcoll
from zhpe_ompi_tpu.io import file as jfile
from zhpe_ompi_tpu.io import fs as jfs
from zhpe_ompi_tpu.mca import var as jvar
from zhpe_ompi_tpu_torch import datatype as tdt
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.io import fbtl as tfbtl
from zhpe_ompi_tpu_torch.io import fcoll as tfcoll
from zhpe_ompi_tpu_torch.io import file as tfile
from zhpe_ompi_tpu_torch.io import fs as tfs
from zhpe_ompi_tpu_torch.mca import var as tvar

from test_torch_osc import _data, _equal

JAX = NS(name="jax", file=jfile, dt=jdt, errors=jerrors, fcoll=jfcoll,
         fs=jfs, var=jvar, fbtl=jfbtl)
PORT = NS(name="port", file=tfile, dt=tdt, errors=terrors, fcoll=tfcoll,
          fs=tfs, var=tvar, fbtl=tfbtl)
N = 4
COMM = NS(size=N)


def same(prog, tmp_path):
    out = []
    for P in (JAX, PORT):
        d = tmp_path / P.name
        d.mkdir()
        got = prog(P, str(d))
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        out.append((got, files))
    _equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    return out[1]


@pytest.fixture
def both_vars():
    saved = [(reg, {v.name: (v._value, v._source)
                    for v in reg.registry.all_vars()})
             for reg in (tvar, jvar)]
    yield
    for reg, snap in saved:
        for v in reg.registry.all_vars():
            if v.name in snap:
                v._value, v._source = snap[v.name]
        for name in ("fcoll", "fcoll_dynamic_stripe"):
            if name not in snap:
                reg.unset(name)


def _interleaved(P):
    """Rank r owns int32 slot r of every N-slot tile."""
    return P.dt.create_resized(P.dt.create_vector(1, 1, 1, P.dt.INT32_T),
                               0, 4 * N)


def test_views_offsets_and_pointers(tmp_path):
    def prog(P, d):
        F = P.file
        path = f"{d}/views.bin"
        out = []
        with F.File(COMM, path, F.MODE_CREATE | F.MODE_RDWR) as f:
            f.write_at(0, _data(0, 64, np.float32))
            vec = P.dt.create_vector(4, 2, 3, P.dt.FLOAT)
            f.set_view(8, P.dt.FLOAT, vec, rank=1)
            f.write_at(1, _data(1, 10, np.float32), rank=1)
            out.append(f.read_at(0, 12, rank=1))
            sub = P.dt.create_subarray([4, 6], [2, 3], [1, 2], P.dt.INT32_T)
            f.set_view(100, P.dt.INT32_T, sub, rank=2)
            f.write(_data(2, 6, np.int32), rank=2)
            f.seek(2, rank=2)
            out.append((f.tell(rank=2), f.read(4, rank=2)))
            f.write_shared(_data(3, 3, np.float32).view(np.uint8))
            f.write_shared(_data(4, 2, np.float32).view(np.uint8))
            out.append(f.read_at(0, 80))
            out.append(f.get_view(1)[0])
            out.append(f.get_size())
        return out

    same(prog, tmp_path)


@pytest.mark.parametrize("strategy", ["two_phase", "dynamic", "individual"])
def test_collective_io_under_each_fcoll(both_vars, tmp_path, strategy):
    for P in (JAX, PORT):
        P.var.set_var("fcoll", strategy)
        P.var.set_var("fcoll_dynamic_stripe", 48)

    def prog(P, d):
        F = P.file
        assert P.fcoll.select_fcoll().name == strategy
        path = f"{d}/all.bin"
        with F.File(COMM, path, F.MODE_CREATE | F.MODE_RDWR) as f:
            for r in range(N):
                f.set_view(4 * r, P.dt.INT32_T, _interleaved(P), rank=r)
            bufs = [_data(r, 12, np.int32) for r in range(N)]
            total = f.write_all(bufs)
            for r in range(N):
                f.seek(0, rank=r)
            back = f.read_all([12, 6, 3, 12])
            req = f.iwrite_all([_data(r + 9, 2, np.int32) for r in range(N)])
            n = req.wait()
            for r in range(N):
                f.seek(12, rank=r)
            late = f.iread_all([2] * N).wait()
        return total, back, n, late

    got, files = same(prog, tmp_path)
    assert got[0] == 4 * 12 and got[2] == 4 * 2
    for r, n in enumerate([12, 6, 3, 12]):
        assert got[1][r].tolist() == _data(r, 12, np.int32)[:n].tolist()


def test_nonblocking_sizes_and_modes(tmp_path):
    def prog(P, d):
        F = P.file
        out = []
        path = f"{d}/nb.bin"
        with F.File(COMM, path, F.MODE_CREATE | F.MODE_WRONLY) as f:
            # 64 bytes apart: each write has its own bytes (MPI leaves
            # overlapping nonblocking writes to the caller's race)
            reqs = [f.iwrite_at(64 * i, _data(i, 8, np.int64))
                    for i in range(3)]
            out.append([q.wait() for q in reqs])
            f.preallocate(512)
            out.append(f.get_size())
            f.set_size(200)
            out.append(f.get_size())
        with F.File(COMM, path, F.MODE_RDONLY) as f:
            f.set_view(0, P.dt.INT64_T)
            out.append(f.iread_at(4, 6).wait())
        with F.File(COMM, path, F.MODE_WRONLY | F.MODE_APPEND) as f:
            out.append(f.tell())
            f.write(np.arange(3, dtype=np.uint8))
        tmp = f"{d}/gone.bin"
        with F.File(COMM, tmp, F.MODE_CREATE | F.MODE_RDWR
                    | F.MODE_DELETE_ON_CLOSE) as f:
            f.write_at(0, np.ones(4, np.uint8))
        out.append(os.path.exists(tmp))
        doomed = f"{d}/doomed.bin"
        F.File(COMM, doomed, F.MODE_CREATE | F.MODE_WRONLY).close()
        F.delete(doomed)
        out.append(os.path.exists(doomed))
        return out

    got, files = same(prog, tmp_path)
    assert got[1:3] == [512, 200] and got[4] == 200
    assert list(files) == ["nb.bin"]


ORDERS = {"submitted": (0, 1, 2), "reversed": (2, 1, 0)}


def _force_completion_order(monkeypatch, P, order):
    """Retire package P's first ``len(order)`` nonblocking transfers on the
    caller's thread in ``order`` (indices in submission order), once the
    last of them is submitted, and every later one as it comes: the pool's
    scheduling made deterministic."""
    held = []

    def run(req, fn, args):
        try:
            req.complete(fn(*args))
        except BaseException as e:  # noqa: BLE001 - surfaces at wait
            req.fail(e)

    def submit(self, fn, *args):
        req = P.fbtl.FileRequest()
        held.append((req, fn, args))
        if len(held) == len(order):
            for i in order:
                run(*held[i])
        elif len(held) > len(order):
            run(*held[-1])
        return req

    monkeypatch.setattr(P.fbtl.AsyncFbtl, "submit", submit)


def _three_iwrites(stride):
    def prog(P, d):
        F = P.file
        with F.File(COMM, f"{d}/nb.bin", F.MODE_CREATE | F.MODE_WRONLY) as f:
            reqs = [f.iwrite_at(stride * i, _data(i, 8, np.int64))
                    for i in range(3)]
            return [q.wait() for q in reqs]
    return prog


@pytest.mark.parametrize("port_order", list(ORDERS))
@pytest.mark.parametrize("jax_order", list(ORDERS))
@pytest.mark.parametrize("stride", [8, 64], ids=["overlapping", "disjoint"])
def test_nonblocking_writes_under_forced_completion_orders(
        tmp_path, stride, jax_order, port_order):
    """Three ``iwrite_at`` of 64 bytes each, their completion order forced
    per package.  At 8 bytes apart they overlap, and the file's bytes are
    the last writer's: equal when both packages retire in the same order,
    different when they do not, so the bytes of the overlapping program
    follow the pool's scheduling (the caller's race, as MPI's non-atomic
    mode leaves it).  At 64 bytes apart they are equal under every pair of
    orders."""
    files = []
    for P, order in ((JAX, jax_order), (PORT, port_order)):
        d = tmp_path / P.name
        d.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            _force_completion_order(mp, P, ORDERS[order])
            assert _three_iwrites(stride)(P, str(d)) == [64, 64, 64]
        files.append((d / "nb.bin").read_bytes())
    assert len(files[0]) == len(files[1]) == 2 * stride + 64
    if stride == 64 or jax_order == port_order:
        assert files[0] == files[1]
    else:
        assert files[0] != files[1]


def test_error_contract(tmp_path):
    def prog(P, d):
        F = P.file
        names = []
        path = f"{d}/e.bin"
        F.File(COMM, path, F.MODE_CREATE | F.MODE_WRONLY).close()
        for call in (
                lambda: F.File(COMM, path, F.MODE_CREATE | F.MODE_EXCL
                               | F.MODE_WRONLY),
                lambda: F.File(COMM, f"{d}/missing.bin", F.MODE_RDONLY),
                lambda: F.File(COMM, path, F.MODE_CREATE),
                lambda: F.delete(f"{d}/missing.bin")):
            try:
                call()
                names.append(None)
            except P.errors.MpiError as e:
                names.append(type(e).__name__)
        with F.File(COMM, path, F.MODE_RDWR) as f:
            f.set_view(0, P.dt.INT32_T)
            for call in (lambda: f.write(np.ones(3, np.uint8)),
                         lambda: f.write_at(0, np.ones(1, np.int32), count=2),
                         lambda: f.write_all([np.ones(1, np.int32)])):
                try:
                    call()
                    names.append(None)
                except P.errors.MpiError as e:
                    names.append(type(e).__name__)
        f.close()
        try:
            f.read_at(0, 1)
        except P.errors.MpiError as e:
            names.append(type(e).__name__)
        return names

    got, _ = same(prog, tmp_path)
    assert got == ["ArgError"] * 4 + ["TypeError_", "TruncateError",
                                      "ArgError", "ArgError"]


def test_fs_and_fcoll_components_match():
    assert [c.name for c in tfs.fs_framework().components()] == \
        [c.name for c in jfs.fs_framework().components()]
    assert sorted(c.name for c in tfcoll.fcoll_framework().components()) == \
        sorted(c.name for c in jfcoll.fcoll_framework().components())
    offs = np.array([3, 4, 5, 9, 10, 20], np.int64)
    assert tfcoll.runs_of(offs) == jfcoll.runs_of(offs) == [
        (3, 3), (9, 2), (20, 1)]


def test_tensors_and_bfloat16_etype(tmp_path):
    a = _data(5, 16, np.float32)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    with jfile.File(COMM, jpath, jfile.MODE_CREATE | jfile.MODE_RDWR) as f:
        f.set_view(0, jdt.BFLOAT16)
        f.write_at(0, a.astype(ml_dtypes.bfloat16))
        jback = f.read_at(0, 16)
    with tfile.File(COMM, tpath, tfile.MODE_CREATE | tfile.MODE_RDWR) as f:
        f.set_view(0, tdt.BFLOAT16)
        f.write_at(0, torch.from_numpy(a).to(torch.bfloat16))
        tback = f.read_at(0, 16)
        f.set_view(0, tdt.FLOAT)
        f.write_at(8, torch.from_numpy(a[:2]))
    assert tback.dtype == torch.bfloat16
    assert tback.view(torch.int16).numpy().tobytes() == \
        jback.view(np.int16).tobytes()
    with open(tpath, "rb") as f:
        tbytes = f.read()
    with open(jpath, "rb") as f:
        jbytes = f.read()
    assert tbytes[:32] == jbytes[:32] and tbytes[32:40] == a[:2].tobytes()
