"""The port's wire format (``utils/dss``) and buffer checks
(``utils/memchecker``) against the JAX package's.

- ``pack`` and ``pack_frames`` give the same bytes for numpy values and for
  the equal CPU tensors (every dtype both have, contiguous or strided,
  nested in containers, at several ``oob_min``), and each package reads
  the other's frames.
- Decoding: an array record becomes a CPU tensor — a fresh one from
  ``unpack``, a view of the receive buffer from ``unpack_from`` (a later
  frame in its own buffer leaves it alone); a dtype torch lacks stays
  numpy, as in the namesake.
- Refusals: a tensor on another device (``meta`` here) and a bfloat16
  tensor raise ``TypeError_`` naming the explicit conversion; the
  namesake's bfloat16 bytes (dtype string ``'<V2'``) decode to the same
  void array in both packages.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from zhpe_ompi_tpu.utils import dss as jdss
from zhpe_ompi_tpu.utils import memchecker as jmem
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.mca import var as tvar
from zhpe_ompi_tpu_torch.utils import dss
from zhpe_ompi_tpu_torch.utils import memchecker as tmem

DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
          np.uint16, np.uint32, np.uint64, np.float16, np.float32,
          np.float64, np.complex64, np.complex128]


def _array(dtype, shape=(2, 3, 4), seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 50
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _frames(mod, *objs, oob_min=0):
    header, segs = mod.pack_frames(*objs, oob_min=oob_min)
    return header, [bytes(s) for s in segs]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_pack_bytes_match_numpy(dtype):
    a = _array(dtype)
    t = torch.from_numpy(a.copy())
    assert dss.pack(t) == jdss.pack(a) == dss.pack(a)
    for oob_min in (0, 64, 1 << 20):
        assert _frames(dss, t, oob_min=oob_min) == \
            _frames(jdss, a, oob_min=oob_min)


@pytest.mark.parametrize("case", ["strided", "scalar", "empty", "nested"])
def test_pack_frames_match_numpy_shapes(case):
    a = _array(np.float32, (4, 6))
    if case == "strided":
        np_obj, t_obj = a[:, ::2], torch.from_numpy(a)[:, ::2]
    elif case == "scalar":
        np_obj, t_obj = np.array(3.5, np.float32), torch.tensor(3.5)
    elif case == "empty":
        np_obj, t_obj = np.zeros((0, 3), np.int64), torch.zeros((0, 3), dtype=torch.int64)
    else:
        np_obj = [1, "x", (a, {"k": a[0]}), None, b"\x00" * 5000]
        t = torch.from_numpy(a)
        t_obj = [1, "x", (t, {"k": t[0]}), None, b"\x00" * 5000]
    assert dss.pack(t_obj) == jdss.pack(np_obj)
    for oob_min in (0, 16):
        assert _frames(dss, 7, t_obj, oob_min=oob_min) == \
            _frames(jdss, 7, np_obj, oob_min=oob_min)


def test_contiguous_tensor_rides_out_of_band_without_a_copy():
    t = torch.arange(1024, dtype=torch.float32)
    _, segs = dss.pack_frames(t)
    assert len(segs) == 1 and segs[0].nbytes == t.nbytes
    t[0] = 42.0  # the segment is a view of the tensor's own storage
    assert np.frombuffer(segs[0], np.float32)[0] == 42.0


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_cross_package_round_trip(dtype):
    a = _array(dtype, seed=1)
    out = dss.unpack(jdss.pack(a))[0]
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == a.shape
    np.testing.assert_array_equal(out.numpy(), a)
    back = jdss.unpack(dss.pack(out))[0]
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)


def test_unpack_from_views_the_buffer_and_unpack_copies():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    header, segs = dss.pack_frames("tag", t)
    frame = bytearray(header + b"".join(bytes(s) for s in segs))
    tag, got = dss.unpack_from(frame)
    assert tag == "tag" and torch.equal(got, t)
    got[0, 0] = -1  # a writable view over the frame buffer
    assert dss.unpack_from(frame)[1][0, 0] == -1
    # the next frame lives in its own buffer: the first view is untouched
    frame2 = bytearray(dss.pack("tag", t * 100))
    second = dss.unpack_from(frame2)[1]
    assert got[0, 0] == -1 and got[2, 3] == 11 and second[2, 3] == 1100
    # unpack always copies, and a read-only buffer degrades to a copy
    fresh = dss.unpack(bytes(frame))[1]
    fresh[0, 0] = 5
    assert dss.unpack_from(frame)[1][0, 0] == -1
    ro = dss.unpack_from(bytes(frame))[1]
    ro[1, 1] = 7
    assert dss.unpack_from(frame)[1][1, 1] == 5


def test_dtypes_torch_lacks_stay_numpy():
    for a in (np.array(["ab", "c"]), np.arange(3, dtype=">i4"),
              np.array(["2020-01-01"], dtype="datetime64[D]")):
        got = dss.unpack(jdss.pack(a))[0]
        ref = jdss.unpack(jdss.pack(a))[0]
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_non_cpu_and_bfloat16_tensors_are_refused():
    meta = torch.zeros(3, device="meta")
    for fn in (dss.pack, lambda o: dss.pack_frames(o), dss.refuse_tensor):
        with pytest.raises(errors.TypeError_, match=r"\.cpu\(\)"):
            fn(meta)
    with pytest.raises(errors.TypeError_, match=r"\.cpu\(\)"):
        dss.pack([1, {"w": meta}])
    bf = torch.tensor([1.5, 2.0], dtype=torch.bfloat16)
    with pytest.raises(errors.TypeError_, match="bfloat16"):
        dss.pack(bf)
    # the explicit conversions the message names go through
    assert torch.equal(dss.unpack(dss.pack(bf.float()))[0], torch.tensor([1.5, 2.0]))
    assert torch.equal(dss.unpack(dss.pack(bf.view(torch.int16)))[0].view(torch.bfloat16), bf)


def test_namesake_bfloat16_bytes_decode_as_void_in_both():
    b = np.array([1.5, 2.0, -3.0], ml_dtypes.bfloat16)
    wire = jdss.pack(b)
    assert b.dtype.str == "<V2"
    port, ref = dss.unpack(wire)[0], jdss.unpack(wire)[0]
    assert isinstance(port, np.ndarray) and port.dtype == ref.dtype == np.dtype("V2")
    assert port.tobytes() == ref.tobytes() == b.tobytes()
    # the bits survive: viewed back as bfloat16 they are the values sent
    assert torch.equal(torch.from_numpy(port.view(np.int16)).view(torch.bfloat16),
                       torch.tensor([1.5, 2.0, -3.0], dtype=torch.bfloat16))


def test_memchecker_checks_tensors_on_their_device():
    """The NaN check holds a tensor as the namesake holds the equal numpy
    array (both off by default; on, both raise ERR_BUFFER)."""
    from zhpe_ompi_tpu.mca import var as jvar

    bad = np.array([1.0, np.nan], np.float32)
    tmem.check_send_buffer(torch.from_numpy(bad), "isend")  # off: no raise
    olds = tvar.get("memchecker_enable"), jvar.get("memchecker_enable")
    tvar.set_var("memchecker_enable", True)
    jvar.set_var("memchecker_enable", True)
    try:
        for obj in (bad, torch.from_numpy(bad)):
            with pytest.raises(errors.MpiError, match="NaN") as e:
                tmem.check_send_buffer(obj, "isend")
            assert e.value.errclass == errors.ERR_BUFFER
        with pytest.raises(Exception, match="NaN"):
            jmem.check_send_buffer(bad, "isend")
        for ok in (torch.ones(3), torch.arange(3), np.ones(3), b"x", None):
            tmem.check_send_buffer(ok, "isend")
        with pytest.raises(errors.MpiError, match="non-contiguous"):
            tmem.check_recv_buffer(torch.ones(4, 4)[:, ::2], "recv")
        tmem.check_recv_buffer(torch.ones(4), "recv")
    finally:
        tvar.set_var("memchecker_enable", olds[0])
        jvar.set_var("memchecker_enable", olds[1])
