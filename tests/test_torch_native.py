"""The port's native host kernels (``zhpe_ompi_tpu_torch/native``) against
the JAX package's (``zhpe_ompi_tpu/native``) on the same numpy inputs.

- The library: built by ``g++`` into ``csrc/_build/`` under a name hashed
  from its source and flags, ABI version 3, the namesake's codes.
- The convertor's native pack, unpack and partial packs, byte for byte
  against the namesake's (and against the port's own index-map form),
  with CPU tensors as buffers (a bfloat16 tensor packs its bytes), and the
  short-buffer refusals of both packages.
- ``zompi_reduce`` for every op on every type code, library against
  library; the port's ``Op`` on host tensors against the namesake's on
  numpy and against the port's torch combine; NaN propagation; operands
  left unchanged.
- The matching engine: one seeded event sequence (wildcards, several
  cids, probes, extracts) through the port's native and Python engines and
  the namesake's two, with ``stats`` and ``stats_excluding``.
- The shared-mapping atomics (the namesake's cases, on the port's
  library).
- The switches (``ZOMPI_NATIVE=0``, ``native_kernels``) select the Python
  paths; a ``g++`` that fails raises; the native engine fires the MPI_T
  (peruse) events.
"""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu import native as jnative
from zhpe_ompi_tpu import ops as jops
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.datatype import convertor as jconv
from zhpe_ompi_tpu.datatype import derived as jderived
from zhpe_ompi_tpu.datatype import predefined as jpre
from zhpe_ompi_tpu.pt2pt import matching as jmatching
from zhpe_ompi_tpu_torch import _build
from zhpe_ompi_tpu_torch import native as tnative
from zhpe_ompi_tpu_torch import ops as tops
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.datatype import convertor as tconv
from zhpe_ompi_tpu_torch.datatype import derived as tderived
from zhpe_ompi_tpu_torch.datatype import predefined as tpre
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.pt2pt import matching as tmatching
from zhpe_ompi_tpu_torch.runtime import peruse as tperuse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def switches(monkeypatch):
    """Each case reads the switches afresh (``native.reset``); the default
    load decision is restored after."""
    monkeypatch.delenv("ZOMPI_NATIVE", raising=False)
    tnative.reset()
    yield monkeypatch
    monkeypatch.undo()
    tvar.unset("native_kernels")
    tnative.reset()


def test_library_builds_into_the_build_dir():
    lib = tnative.load()
    assert lib is not None and tnative.disabled_by is None
    assert lib.zompi_abi_version() == tnative.ABI_VERSION == 3
    path = tnative._so_path()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libzompi-")
    assert tnative.OP_CODES == jnative.OP_CODES
    assert tnative.TYPE_CODES == jnative.TYPE_CODES
    assert not [f for f in os.listdir(os.path.dirname(tnative.__file__))
                if f.endswith(".so")]


# ================================ convertor =================================

TYPES = {
    # 5 blocks of 3 doubles strided 7 elements apart (the namesake's)
    "vector": lambda d, p: d.create_vector(5, 3, 7, p.DOUBLE),
    "struct": lambda d, p: d.create_struct([2, 3], [0, 32],
                                           [p.INT32_T, p.DOUBLE]),
    "indexed": lambda d, p: d.create_indexed([1, 3, 2], [0, 4, 11], p.FLOAT),
    "hvector": lambda d, p: d.create_hvector(4, 2, 24, p.INT32_T),
}


def _types(name):
    return TYPES[name](jderived, jpre), TYPES[name](tderived, tpre)


def _source(jt, count, seed=0):
    n = jconv.span_bytes(jt, count)
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("count", [1, 6])
@pytest.mark.parametrize("name", list(TYPES))
def test_pack_and_unpack_match_the_namesake(name, count):
    jt, tt = _types(name)
    src = _source(jt, count)
    want = jconv.pack(src, jt, count)
    for buf in (src, torch.from_numpy(src.copy())):
        got = tconv.pack(buf, tt, count)
        assert got.dtype == np.uint8 and bytes(got) == bytes(want)
    # the index-map form (the switches' path) gives the same bytes
    idx = src[tconv.byte_index_map(tt, count)]
    assert bytes(idx) == bytes(want)
    jout = jconv.unpack(want, jt, count)
    tout = tconv.unpack(want, tt, count)
    assert bytes(tout) == bytes(jout)
    dest = torch.zeros(jconv.span_bytes(jt, count), dtype=torch.uint8)
    tconv.unpack(torch.from_numpy(want.copy()), tt, count, out=dest)
    assert bytes(dest.numpy()) == bytes(jout)


@pytest.mark.parametrize("chunk", [1, 37, 41, 4096])
@pytest.mark.parametrize("name", ["vector", "struct", "indexed"])
def test_partial_packs_match_the_namesake(name, chunk):
    jt, tt = _types(name)
    count = 6
    src = _source(jt, count, seed=1)
    full = jconv.pack(src, jt, count)
    tpos = jpos = 0
    while tpos < full.nbytes:
        tc, tpos = tconv.pack_partial(src, tt, count, tpos, chunk)
        jc, jpos = jconv.pack_partial(src, jt, count, jpos, chunk)
        assert (bytes(tc), tpos) == (bytes(jc), jpos)
    # out-of-order unpack: chunks delivered last first
    bounds = list(range(0, full.nbytes, chunk)) + [full.nbytes]
    tdest = np.zeros(jconv.span_bytes(jt, count), np.uint8)
    jdest = tdest.copy()
    for lo, hi in reversed(list(zip(bounds[:-1], bounds[1:]))):
        assert tconv.unpack_partial(full[lo:hi], tdest, tt, count, lo) == \
            jconv.unpack_partial(full[lo:hi], jdest, jt, count, lo) == hi
    assert bytes(tdest) == bytes(jdest)
    assert bytes(tconv.pack(tdest, tt, count)) == bytes(full)


def test_bfloat16_tensor_packs_its_bytes():
    """bfloat16 has no numpy dtype: the tensor is packed as its bytes,
    never through a float conversion (NaN payloads and -0.0 survive)."""
    x = torch.randn(7 * 5 * 4, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    x[3] = float("nan")
    x[5] = -0.0
    bits = x.view(torch.int16).numpy().copy()
    tt = tderived.create_vector(5, 3, 7, tpre.BFLOAT16)
    jt = jderived.create_vector(5, 3, 7, jpre.INT16_T)
    got = tconv.pack(x, tt, 4)
    assert bytes(got) == bytes(jconv.pack(bits, jt, 4))
    out = torch.zeros_like(x)
    tconv.unpack(got, tt, 4, out=out)
    mask = np.zeros(x.numel(), bool)
    mask[tconv.byte_index_map(tt, 4)[::2] // 2] = True
    assert np.array_equal(out.view(torch.int16).numpy()[mask], bits[mask])


REFUSALS = [
    ("pack_partial short source", "TruncateError",
     lambda c, t, n: c.pack_partial(np.zeros(8, np.uint8), t, 4, 0, 10**6)),
    ("pack_partial negative position", "ArgError",
     lambda c, t, n: c.pack_partial(np.zeros(n, np.uint8), t, 4, -1, 16)),
    ("unpack_partial short destination", "TruncateError",
     lambda c, t, n: c.unpack_partial(np.zeros(64, np.uint8),
                                      np.zeros(4, np.uint8), t, 4, 0)),
    ("unpack_partial negative position", "ArgError",
     lambda c, t, n: c.unpack_partial(np.zeros(64, np.uint8),
                                      np.zeros(n, np.uint8), t, 4, -1)),
    ("pack short source", "TruncateError",
     lambda c, t, n: c.pack(np.zeros(8, np.uint8), t, 4)),
    ("unpack short stream", "TruncateError",
     lambda c, t, n: c.unpack(np.zeros(8, np.uint8), t, 4)),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_short_buffers_are_refused_as_in_the_namesake(case):
    _, klass, call = case
    jt, tt = _types("vector")
    n = jconv.span_bytes(jt, 4)
    with pytest.raises(getattr(jerrors, klass)):
        call(jconv, jt, n)
    with pytest.raises(getattr(terrors, klass)):
        call(tconv, tt, n)


# ================================= reduce ==================================

ALL_TYPES = list(tnative.TYPE_CODES)


def _operands(dtype, n=5000, seed=3):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a, b = rng.normal(size=n).astype(dt), rng.normal(size=n).astype(dt)
        a[::97], b[::89] = np.nan, np.nan
        a[1::101] = 0.0
        return a, b
    info = np.iinfo(dt)
    lo, hi = max(int(info.min), -1000), min(int(info.max), 1000)
    a = rng.integers(lo, hi, n).astype(dt)
    b = rng.integers(lo, hi, n).astype(dt)
    a[::7] = 0
    a[1::11], b[2::13] = info.max, info.min
    return a, b


@pytest.mark.parametrize("dtype", ALL_TYPES)
def test_zompi_reduce_matches_the_namesakes_table(dtype):
    """Every op code on this type code: the port's library and the
    namesake's give the same bits and the same refusals (-1 for a bitwise
    op on a float type)."""
    jlib, tlib = jnative.load(), tnative.load()
    a, b = _operands(dtype)
    for op, code in tnative.OP_CODES.items():
        outs, rcs = [], []
        for lib in (jlib, tlib):
            out = b.copy()
            rcs.append(lib.zompi_reduce(
                code, tnative.TYPE_CODES[dtype],
                a.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), a.size))
            outs.append(out)
        assert rcs[0] == rcs[1], op
        assert rcs[1] == (-1 if np.dtype(dtype).kind == "f"
                          and op in ("MPI_BAND", "MPI_BOR", "MPI_BXOR") else 0)
        assert outs[0].tobytes() == outs[1].tobytes(), op


# the op x dtype table of the namesake's own native reduce test
OP_DTYPE = [(op, dt) for op in tnative.OP_CODES
            for dt in ("int32", "uint64", "float64")
            if not (dt == "float64" and op in ("MPI_BAND", "MPI_BOR",
                                               "MPI_BXOR"))]


@pytest.mark.parametrize("opname,dtype", OP_DTYPE)
def test_op_on_host_tensors_matches_the_namesake(opname, dtype):
    a, b = _operands(dtype)
    a0, b0 = a.copy(), b.copy()
    want = jops.lookup(opname)(a, b) if hasattr(jops, "lookup") else \
        getattr(jops, opname[4:])(a, b)
    op = tops.lookup(opname)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = op(ta, tb)  # >= 4096 contiguous host elements: the C table
    assert isinstance(got, torch.Tensor) and got.dtype == ta.dtype
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    try:  # the torch combine, where torch has the kernel (not uint64 add)
        plain = op._fn(ta, tb)
    except NotImplementedError:
        plain = None
    if plain is not None:
        assert np.array_equal(got.numpy(), plain.numpy(), equal_nan=True)
    # operands left as they were
    assert a.tobytes() == a0.tobytes() and b.tobytes() == b0.tobytes()


def test_max_and_min_propagate_nan_on_both_sides():
    nan = torch.full((5000,), float("nan"))
    zero = torch.zeros(5000)
    for op in (tops.MAX, tops.MIN):
        assert torch.isnan(op(nan, zero)).all()
        assert torch.isnan(op(zero, nan)).all()


def test_small_strided_or_card_shaped_operands_keep_the_torch_path():
    lib = tnative.load()
    calls = []
    real = lib.zompi_reduce

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def zompi_reduce(self, *args):
            calls.append(args[:2])
            return real(*args)

    saved = tnative.lib
    tnative.lib = Spy()
    try:
        a = torch.arange(8192, dtype=torch.float32)
        tops.SUM(a[:100], a[:100])              # small
        tops.SUM(a[::2], a[1::2])               # strided
        tops.SUM(a, a.to(torch.float64))        # mixed dtypes
        tops.SUM(a.to(torch.bfloat16), a.to(torch.bfloat16))  # no code
        assert calls == []
        tops.SUM(a, a)
        assert calls == [(0, 8)]
    finally:
        tnative.lib = saved


# ============================== matching engine ==============================


def _engine_events(seed, n=400):
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        src, tag = int(rng.integers(-1, 4)), int(rng.integers(-1, 3))
        cid = int(rng.integers(0, 3))
        events.append((kind, src, tag, cid, i))
    return events


def _drive(eng, mod, events):
    log, probes, extracts = [], [], []
    for kind, src, tag, cid, i in events:
        if kind == 0:
            eng.post_recv(src, tag, cid, lambda e, p, i=i: log.append(
                (i, e.src, e.tag, e.cid, e.seq, p)))
        elif kind == 1:
            eng.incoming(mod.Envelope(max(src, 0), max(tag, 0), cid, i),
                         f"m{i}")
        else:
            hit = eng.extract(src, tag, cid)
            extracts.append(None if hit is None else (
                hit[0].src, hit[0].tag, hit[0].seq, hit[1]))
        pr = eng.probe(src, tag, cid)
        probes.append(None if pr is None else (pr.src, pr.tag, pr.seq))
    excl = [eng.stats_excluding(s, c) for s, c in (
        ((0,), ()), ((1, 2), (0,)), ((), (1, 2)), ((-1,), ()),
        ((0, 1, 2, 3), (0, 1, 2)))]
    return log, probes, extracts, eng.stats(), excl


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_native_engine_matches_all_three_engines(seed):
    events = _engine_events(seed)
    runs = [
        _drive(tmatching.NativeMatchingEngine(), tmatching, events),
        _drive(tmatching.MatchingEngine(), tmatching, events),
        _drive(jmatching.MatchingEngine(), jmatching, events),
        _drive(jmatching.NativeMatchingEngine(), jmatching, events),
    ]
    assert runs[0][0], "the sequence matched nothing"
    for other in runs[1:]:
        assert other == runs[0]


def test_make_matching_engine_is_native_by_default(switches):
    assert type(tmatching.make_matching_engine()) is \
        tmatching.NativeMatchingEngine


def test_native_engine_fires_the_mpit_events():
    events = []
    subs = [(ev, tperuse.subscribe(ev, lambda ev=ev, **kw: events.append(
        (ev, kw["src"], kw["tag"]))))
        for ev in (tperuse.MSG_ARRIVED, tperuse.MSG_INSERT_IN_UNEX_Q,
                   tperuse.REQ_ACTIVATE, tperuse.MSG_REMOVE_FROM_UNEX_Q,
                   tperuse.REQ_MATCH_UNEX, tperuse.REQ_INSERT_IN_POSTED_Q,
                   tperuse.REQ_REMOVE_FROM_POSTED_Q,
                   tperuse.MSG_MATCH_POSTED_REQ)]
    try:
        eng = tmatching.NativeMatchingEngine()
        eng.incoming(tmatching.Envelope(3, 7, 0, 0), "p")
        assert events == [(tperuse.MSG_ARRIVED, 3, 7),
                          (tperuse.MSG_INSERT_IN_UNEX_Q, 3, 7)]
        events.clear()
        eng.post_recv(3, 7, 0, lambda e, p: None)
        assert [e[0] for e in events] == [
            tperuse.REQ_ACTIVATE, tperuse.MSG_REMOVE_FROM_UNEX_Q,
            tperuse.REQ_MATCH_UNEX]
        events.clear()
        eng.post_recv(1, 2, 0, lambda e, p: None)
        eng.incoming(tmatching.Envelope(1, 2, 0, 0), "x")
        assert [e[0] for e in events] == [
            tperuse.REQ_ACTIVATE, tperuse.REQ_INSERT_IN_POSTED_Q,
            tperuse.MSG_ARRIVED, tperuse.REQ_REMOVE_FROM_POSTED_Q,
            tperuse.MSG_MATCH_POSTED_REQ]
    finally:
        for ev, fn in subs:
            tperuse.unsubscribe(ev, fn)
    assert not tperuse.active


def test_native_engine_watermarks_the_unexpected_depth():
    from zhpe_ompi_tpu_torch.runtime import spc

    eng = tmatching.NativeMatchingEngine()
    before = spc.read("match_unexpected_max_depth")
    for i in range(before + 3):
        eng.incoming(tmatching.Envelope(0, 1, 9, i), i)
    assert spc.read("match_unexpected_max_depth") == before + 3
    for i in range(before + 3):
        eng.post_recv(0, 1, 9, lambda e, p: None)
    assert eng.stats() == {"posted": 0, "unexpected": 0}


# ================================== AMOs ===================================


def _amo(arr, code, kind, vi=0, ci=0, vf=0.0, cf=0.0):
    lib = tnative.load()
    oi, of = ctypes.c_int64(0), ctypes.c_double(0.0)
    rc = lib.zompi_shm_amo(ctypes.c_void_p(arr.ctypes.data), code, kind,
                           vi, ci, vf, cf, ctypes.byref(oi), ctypes.byref(of))
    assert rc == 0
    return oi.value, of.value


def _amo_int64():
    a = np.array([10], dtype=np.int64)
    assert _amo(a, 6, 0, vi=5)[0] == 10 and a[0] == 15           # add
    assert _amo(a, 6, 1, vi=100)[0] == 15 and a[0] == 100        # swap
    assert _amo(a, 6, 2, vi=7, ci=100)[0] == 100 and a[0] == 7   # cas hit
    assert _amo(a, 6, 2, vi=9, ci=100)[0] == 7 and a[0] == 7     # cas miss
    assert _amo(a, 6, 3, vi=4)[0] == 7 and a[0] == 4             # set
    assert _amo(a, 6, 4)[0] == 4                                 # fetch


def _amo_float32():
    a = np.array([1.5], dtype=np.float32)
    assert _amo(a, 8, 0, vf=2.25)[1] == 1.5 and float(a[0]) == 3.75
    assert _amo(a, 8, 2, vf=9.0, cf=3.75)[1] == 3.75 and float(a[0]) == 9.0


def _amo_narrow():
    for code, dt in [(0, np.int8), (1, np.uint8), (2, np.int16),
                     (3, np.uint16), (4, np.int32), (5, np.uint32),
                     (7, np.uint64)]:
        a = np.array([3], dtype=dt)
        assert _amo(a, code, 0, vi=4)[0] == 3 and int(a[0]) == 7


def _amo_concurrent():
    a = np.zeros(1, dtype=np.int64)

    def worker():
        for _ in range(2000):
            _amo(a, 6, 0, vi=1)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert a[0] == 2000 * 8


def _amo_bad_code():
    oi, of = ctypes.c_int64(0), ctypes.c_double(0.0)
    a = np.zeros(1, np.int64)
    assert tnative.load().zompi_shm_amo(
        ctypes.c_void_p(a.ctypes.data), 10, 0, 1, 0, 0.0, 0.0,
        ctypes.byref(oi), ctypes.byref(of)) == -1
    tnative.load().zompi_shm_fence()


AMO_CASES = {"int64": _amo_int64, "float32": _amo_float32,
             "narrow": _amo_narrow, "concurrent": _amo_concurrent,
             "bad_code": _amo_bad_code}


@pytest.mark.parametrize("case", list(AMO_CASES))
def test_shm_amo(case):
    AMO_CASES[case]()


# ================================ switches =================================


@pytest.mark.parametrize("switch", ["env", "var"])
def test_switches_select_the_python_paths(switches, switch):
    if switch == "env":
        switches.setenv("ZOMPI_NATIVE", "0")
    else:
        tvar.set_var("native_kernels", 0)
    assert tnative.load() is None and not tnative.available()
    assert tnative.disabled_by == {"env": "ZOMPI_NATIVE=0",
                                   "var": "MCA var native_kernels"}[switch]
    assert type(tmatching.make_matching_engine()) is tmatching.MatchingEngine
    with pytest.raises(RuntimeError, match="switched off"):
        tmatching.NativeMatchingEngine()
    jt, tt = _types("vector")
    src = _source(jt, 4)
    assert bytes(tconv.pack(src, tt, 4)) == bytes(jconv.pack(src, jt, 4))
    a = torch.arange(5000, dtype=torch.int32)
    assert torch.equal(tops.SUM(a, a), a * 2)
    # the C ABI shim has no switch: its path does not depend on them
    assert tnative.mpi_shim_path().startswith(_build.BUILD_DIR)


_NO_GXX = r"""
import os, sys
sys.path.insert(0, {repo!r})
from zhpe_ompi_tpu_torch import native
native.BUILD_DIR = {build!r}
for fn in (native.load, native.build_mpi_shim):
    try:
        fn()
    except RuntimeError as e:
        print("raised:", str(e).splitlines()[0])
    else:
        print("returned")
"""


def test_a_failed_gxx_raises(tmp_path):
    """No ``g++`` on ``PATH``: both builds raise (none returns None)."""
    env = dict(os.environ, PATH=str(tmp_path / "empty"))
    env.pop("ZOMPI_NATIVE", None)
    out = subprocess.run(
        [sys.executable, "-c", _NO_GXX.format(repo=REPO,
                                              build=str(tmp_path / "b"))],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "raised: zompi_native.cpp: g++ did not run: [Errno 2] No such file "
        "or directory: 'g++'",
        "raised: zompi_mpi.cpp: g++ did not run: [Errno 2] No such file "
        "or directory: 'g++'"]


def test_a_failed_compile_raises_with_the_compilers_output(switches,
                                                          tmp_path):
    bad = tmp_path / "zompi_native.cpp"
    bad.write_text("int zompi_abi_version( { return 3; }\n")
    switches.setattr(tnative, "_SRC", str(bad))
    switches.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ rc 1:\n.*error"):
        tnative.load()
    assert tnative.lib is None
