"""The port's derived datatypes, convertor and external32 against the JAX
package's.

Every constructor (contiguous, vector, hvector, indexed, hindexed,
indexed_block, hindexed_block, struct, subarray in C and Fortran order,
darray with BLOCK, CYCLIC(k) and NONE, resized, dup, and compositions) is
built by both packages from the same arguments (``_types``); then, for
each:

- the typemap (dtypes by name, displacements), size, extent, lb, the
  optimized segments, ``is_contiguous`` and the homogeneous dtype agree;
- ``pack``, ``unpack`` and the partial forms (``pack_partial`` in chunks,
  ``unpack_partial`` out of order) give the same bytes from the same
  random buffer, and ``byte_index_map``/``span_bytes``/``packed_size``
  agree;
- ``pack_external``/``unpack_external`` give the same big-endian bytes;
- ``device_pack``/``device_unpack`` (on CPU tensors here) equal the JAX
  package's on homogeneous types, bfloat16 included;
- the constructors' and the engines' errors are the same.

Byte and element movement only: the comparisons are exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zhpe_ompi_tpu import datatype as jdt
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.datatype import convertor as jconv
from zhpe_ompi_tpu.datatype import external32 as jext
from zhpe_ompi_tpu_torch import datatype as tdt
from zhpe_ompi_tpu_torch.core import errors as terrors
from zhpe_ompi_tpu_torch.datatype import convertor as tconv
from zhpe_ompi_tpu_torch.datatype import external32 as text

COUNT = 3


def _types(d):
    """name -> datatype, built with either package's ``datatype`` module."""
    vec = d.create_vector(3, 2, 4, d.FLOAT)
    return {
        "contiguous": d.create_contiguous(4, d.FLOAT),
        "vector": vec,
        "vector_contig": d.create_vector(3, 2, 2, d.FLOAT),
        "vector_zero_block": d.create_vector(2, 0, 1, d.INT),
        "hvector": d.create_hvector(3, 1, 12, d.DOUBLE),
        "indexed": d.create_indexed([2, 1], [0, 3], d.INT),
        "indexed_lb": d.create_indexed([1], [1], d.INT),
        "hindexed": d.create_hindexed([1, 2], [4, 16], d.SHORT),
        "indexed_block": d.create_indexed_block(2, [1, 5, 9], d.FLOAT),
        "hindexed_block": d.create_hindexed_block(2, [0, 24, 48], d.INT32_T),
        "struct": d.create_struct([1, 2], [0, 8], [d.INT, d.DOUBLE]),
        "struct_mixed": d.create_struct([1, 3, 1], [0, 2, 12], [d.SHORT, d.UINT8_T, d.FLOAT]),
        "subarray_c": d.create_subarray([4, 4], [2, 2], [1, 1], d.FLOAT),
        "subarray_f": d.create_subarray([3, 4, 2], [2, 2, 1], [1, 0, 1], d.INT, order="F"),
        "darray_block_2d": d.create_darray(4, 1, [4, 6], [d.DISTRIBUTE_BLOCK] * 2,
                                           [d.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], d.FLOAT),
        "darray_cyclic": d.create_darray(3, 2, [10], [d.DISTRIBUTE_CYCLIC], [2], [3], d.DOUBLE),
        "darray_mixed_f": d.create_darray(2, 1, [4, 5], [d.DISTRIBUTE_CYCLIC, d.DISTRIBUTE_NONE],
                                          [1, d.DISTRIBUTE_DFLT_DARG], [2, 1], d.INT,
                                          order="F"),
        "resized": d.create_resized(d.FLOAT, 0, 16),
        "resized_vector": d.create_resized(vec, 0, 64),
        "dup": d.dup(d.create_vector(2, 1, 3, d.SHORT)),
        "vector_of_struct": d.create_vector(2, 1, 2, d.create_struct([1, 1], [0, 4], [d.FLOAT, d.INT])),
        "contig_bf16": d.create_contiguous(3, d.BFLOAT16),
        "vector_bf16": d.create_vector(2, 2, 4, d.BFLOAT16),
        "pair": d.create_contiguous(2, d.FLOAT_INT),
        "complex": d.create_vector(2, 1, 2, d.C_FLOAT_COMPLEX),
    }


NAMES = list(_types(tdt))


def _np_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return "bfloat16" if dt == torch.bfloat16 else str(
            torch.empty(0, dtype=dt).numpy().dtype)
    return str(np.dtype(dt))


def _pair(name):
    jt, tt = _types(jdt)[name], _types(tdt)[name]
    return jt.commit() if hasattr(jt, "commit") else jt, \
        tt.commit() if hasattr(tt, "commit") else tt


@pytest.mark.parametrize("name", NAMES)
def test_typemap_size_extent_lb(name):
    jt, tt = _pair(name)
    assert [(_np_name(a), d) for a, d in tt.typemap()] == \
        [(_np_name(a), d) for a, d in jt.typemap()]
    assert (tt.size, tt.extent, tt.lb, tt.ub) == (jt.size, jt.extent, jt.lb, jt.ub)
    assert tt.segments() == jt.segments()
    assert tt.is_contiguous == jt.is_contiguous
    hj, ht = jt.homogeneous_dtype, tt.homogeneous_dtype
    assert (ht is None and hj is None) or _np_name(ht) == _np_name(hj)


def _buffer(jt, count):
    n = jconv.span_bytes(jt, count)
    return np.random.default_rng(len(jt.name)).integers(0, 256, n + 5).astype(np.uint8)


@pytest.mark.parametrize("name", NAMES)
def test_pack_unpack_bytes(name):
    jt, tt = _pair(name)
    assert tconv.packed_size(tt, COUNT) == jconv.packed_size(jt, COUNT)
    assert tconv.span_bytes(tt, COUNT) == jconv.span_bytes(jt, COUNT)
    buf = _buffer(jt, COUNT)
    np.testing.assert_array_equal(tconv.byte_index_map(tt, COUNT),
                                  jconv.byte_index_map(jt, COUNT))
    packed = tconv.pack(buf, tt, COUNT)
    np.testing.assert_array_equal(packed, jconv.pack(buf, jt, COUNT))
    # a CPU tensor is packed through a view of its bytes
    np.testing.assert_array_equal(tconv.pack(torch.from_numpy(buf), tt, COUNT), packed)
    np.testing.assert_array_equal(tconv.unpack(packed, tt, COUNT),
                                  jconv.unpack(packed, jt, COUNT))
    out_t, out_j = np.zeros_like(buf), np.zeros_like(buf)
    tconv.unpack(packed, tt, COUNT, out=out_t)
    jconv.unpack(packed, jt, COUNT, out=out_j)
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("name", NAMES)
def test_partial_pack_and_out_of_order_unpack(name):
    jt, tt = _pair(name)
    buf = _buffer(jt, COUNT)
    total = tconv.packed_size(tt, COUNT)
    chunks, pos = [], 0
    while pos < total:
        chunk, new = tconv.pack_partial(buf, tt, COUNT, pos, 7)
        jchunk, jnew = jconv.pack_partial(buf, jt, COUNT, pos, 7)
        np.testing.assert_array_equal(chunk, jchunk)
        assert new == jnew
        chunks.append((pos, chunk))
        pos = new
    out_t = np.zeros(tconv.span_bytes(tt, COUNT), np.uint8)
    out_j = np.zeros_like(out_t)
    for pos, chunk in reversed(chunks):
        assert tconv.unpack_partial(chunk, out_t, tt, COUNT, pos) == \
            jconv.unpack_partial(chunk, out_j, jt, COUNT, pos)
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("name", NAMES)
def test_external32_bytes(name):
    jt, tt = _pair(name)
    buf = _buffer(jt, 2)
    wire = text.pack_external(buf, tt, 2)
    np.testing.assert_array_equal(wire, jext.pack_external(buf, jt, 2))
    np.testing.assert_array_equal(text.unpack_external(wire, tt, 2),
                                  jext.unpack_external(wire, jt, 2))
    out = torch.zeros(len(buf), dtype=torch.uint8)
    text.unpack_external(wire, tt, 2, out=out)
    np.testing.assert_array_equal(out.numpy()[:len(buf) - 5],
                                  jext.unpack_external(wire, jt, 2))


HOMOGENEOUS = [n for n in NAMES if _types(tdt)[n].homogeneous_dtype is not None
               ] + ["basic_float"]


def _device_pair(name):
    if name == "basic_float":
        return jdt.FLOAT, tdt.FLOAT
    return _pair(name)


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_device_pack_and_unpack(name):
    jt, tt = _device_pair(name)
    np.testing.assert_array_equal(tconv.device_element_indices(tt, COUNT),
                                  jconv.device_element_indices(jt, COUNT))
    dtname = _np_name(tt.typemap()[0][0])
    item = tt.typemap()[0][0].itemsize
    n = jconv.span_bytes(jt, COUNT) // item + 3
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    if dtname == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    elif dtname.startswith("complex"):
        jx, tx = jnp.asarray(x + 1j * x[::-1], dtname), torch.from_numpy((x + 1j * x[::-1]).astype(dtname))
    else:
        jx, tx = jnp.asarray(x.astype(dtname)), torch.from_numpy(x.astype(dtname))
    packed = tconv.device_pack(tx, tt, COUNT)
    want = np.asarray(jconv.device_pack(jx, jt, COUNT))
    np.testing.assert_array_equal(packed.float().numpy() if dtname == "bfloat16" else packed.numpy(),
                                  want.astype(np.float32) if dtname == "bfloat16" else want)
    out = torch.zeros_like(tx)
    got = tconv.device_unpack(packed, tt, COUNT, out)
    assert got is out
    jwant = np.asarray(jconv.device_unpack(jnp.asarray(want), jt, COUNT, jnp.zeros_like(jx)))
    np.testing.assert_array_equal(got.float().numpy() if dtname == "bfloat16" else got.numpy(),
                                  jwant.astype(np.float32) if dtname == "bfloat16" else jwant)


def test_device_path_errors():
    with pytest.raises(terrors.TypeError_):
        tconv.device_pack(torch.zeros(8), tdt.create_struct([1, 1], [0, 8], [tdt.INT, tdt.DOUBLE]), 1)
    with pytest.raises(terrors.TypeError_):
        tconv.device_pack(torch.zeros(8, dtype=torch.float64), tdt.create_vector(2, 1, 2, tdt.FLOAT), 1)
    with pytest.raises(terrors.ArgError):
        tconv.device_unpack(torch.zeros(2), tdt.create_vector(2, 1, 2, tdt.FLOAT), 1,
                            torch.zeros(4, 2).t())


def _outcome(fn):
    try:
        fn()
        return "ok"
    except (jerrors.MpiError, terrors.MpiError) as e:
        return type(e).__name__


ERRORS = [
    lambda d: d.create_subarray([4], [3], [2], d.FLOAT),
    lambda d: d.create_subarray([4], [2], [0], d.FLOAT, order="X"),
    lambda d: d.create_contiguous(-1, d.FLOAT),
    lambda d: d.create_hvector(-1, 1, 4, d.FLOAT),
    lambda d: d.create_hindexed([1, 2], [0], d.FLOAT),
    lambda d: d.create_struct([1], [0, 4], [d.FLOAT]),
    lambda d: d.create_darray(4, 0, [4, 4], [d.DISTRIBUTE_BLOCK] * 2, [-1, -1], [2, 3], d.FLOAT),
    lambda d: d.create_darray(2, 0, [4], [d.DISTRIBUTE_NONE], [-1], [2], d.FLOAT),
    lambda d: d.create_darray(2, 0, [8], [d.DISTRIBUTE_BLOCK], [2], [2], d.FLOAT),
    lambda d: d.create_darray(1, 0, [4], [7], [-1], [1], d.FLOAT),
    lambda d: d.create_resized(d.FLOAT, 0, -4),
    lambda d: d.create_vector(2, 1, 2, d.create_struct([1, 1], [0, 8], [d.INT, d.DOUBLE])).element_indices(),
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_constructor_errors_match(i):
    got, want = _outcome(lambda: ERRORS[i](tdt)), _outcome(lambda: ERRORS[i](jdt))
    assert got == want and want != "ok"


ENGINE_ERRORS = [
    lambda c, d: c.pack(np.zeros(4, np.uint8), d.create_contiguous(4, d.FLOAT), 1),
    lambda c, d: c.pack(np.zeros(64, np.uint8), d.create_hvector(2, 1, -4, d.INT), 1),
    lambda c, d: c.pack(np.zeros((4, 4), np.uint8)[:, :2], d.create_contiguous(2, d.BYTE), 1),
    lambda c, d: c.unpack(np.zeros(2, np.uint8), d.create_contiguous(4, d.BYTE), 1),
    lambda c, d: c.unpack(np.zeros(4, np.uint8), d.create_vector(2, 1, 2, d.BYTE), 2,
                          out=np.zeros(2, np.uint8)),
    lambda c, d: c.pack_partial(np.zeros(8, np.uint8), d.create_contiguous(8, d.BYTE), 1, 9, 1),
    lambda c, d: c.unpack_partial(np.zeros(4, np.uint8), np.zeros(8, np.uint8),
                                  d.create_contiguous(8, d.BYTE), 1, 6),
    lambda c, d: c.unpack_partial(np.zeros(1, np.uint8), np.zeros(8, np.uint8),
                                  d.create_contiguous(8, d.BYTE), 1, -1),
]


@pytest.mark.parametrize("i", range(len(ENGINE_ERRORS)))
def test_engine_errors_match(i):
    got = _outcome(lambda: ENGINE_ERRORS[i](tconv, tdt))
    want = _outcome(lambda: ENGINE_ERRORS[i](jconv, jdt))
    assert got == want and want != "ok"


def test_host_convertor_refuses_a_device_tensor():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(terrors.ArgError, match="device_pack"):
        tconv.pack(meta, tdt.create_contiguous(4, tdt.BYTE), 1)
