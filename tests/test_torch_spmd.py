"""The PyTorch port's SPMD point-to-point plane against the JAX package's.

``zhpe_ompi_tpu_torch/pt2pt/spmd.py`` and the communicator's ``shift``,
``permute`` and ``ppermute`` on 3 and 4 gloo ranks (``_torch_dist_worker``
``spmd``), against ``zhpe_ompi_tpu.pt2pt.spmd`` under ``shard_map`` on a
sub-mesh of the same size:

- shifts by 1, −1 and 2, with and without wrap (the ends of a non-wrapping
  shift receive zeros);
- a pattern with one pair (every other rank receives zeros) and a general
  permute;
- strided and transposed (non-contiguous) buffers, bf16 and bool;
- a duplicate destination or source raises ``ArgError``;
- the gradient of a shift, of a non-wrapping shift and of a general
  permute is the cotangent sent along the inverse permutation (the
  transpose ``lax.ppermute`` has, which ``jax.vjp`` gives).

Every result is an exact copy of some rank's data, so the comparison is
exact.  At size 1 a shift is a copy and a non-wrapping one gives zeros,
issuing no backend call.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import torch
import torch.distributed as dist

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu import compat
from zhpe_ompi_tpu.pt2pt import spmd as jspmd

from _torch_dist_worker import run_ranks

SIZES = (3, 4)


def _pattern(n):
    """The general permute of the worker's gradient check."""
    if n % 2:
        return [(i, (2 * i + 1) % n) for i in range(n)]
    return [(i, n - 1 - i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_results(n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    comm = jz.Communicator(mesh, "x", name=f"port_spmd{n}")
    ranks = np.arange(n)
    xs = (np.arange(6, dtype=np.float32).reshape(2, 3)[None]
          + 10 * ranks[:, None, None]).astype(np.float32)
    wides = (np.arange(24, dtype=np.float32).reshape(4, 6)[None]
             + 100 * ranks[:, None, None]).astype(np.float32)
    cts = (np.arange(6, dtype=np.float32).reshape(2, 3)[None]
           * (ranks[:, None, None] + 1)).astype(np.float32)
    offs = (10 * ranks + 2).astype(np.float32)

    def body(x, wide, ct, off):
        x, wide, ct, off = x[0], wide[0], ct[0], off[0]
        res = {}
        for o in (1, -1, 2):
            res[f"shift{o}_wrap"] = comm.shift(x, o)
            res[f"shift{o}_nowrap"] = comm.shift(x, o, wrap=False)
        res["ppermute_partial"] = comm.ppermute(x, [(0, n - 1)])
        res["permute_reverse"] = comm.permute(x, [n - 1 - i for i in range(n)])
        res["strided"] = comm.shift(wide[:, 1::2], 1)
        res["transposed"] = comm.shift(wide.T, 1)
        res["bf16"] = comm.shift(x.astype(jnp.bfloat16), 1).astype(jnp.float32)
        res["bool"] = comm.shift(x > off, 1)
        for name, fn in (
                ("shift", lambda t: jspmd.shift(comm, t, 1)),
                ("shift_nowrap", lambda t: jspmd.shift(comm, t, 1, wrap=False)),
                ("ppermute", lambda t: jspmd.ppermute(comm, t, _pattern(n)))):
            _, vjp = jax.vjp(lambda g: fn(g + x), jnp.zeros_like(x))
            res[f"grad_{name}"] = vjp(ct)[0]
        return {k: v[None] for k, v in res.items()}

    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("x"),) * 4,
                                 out_specs=P("x"), check_vma=False))
    return {k: np.asarray(v) for k, v in f(xs, wides, cts, offs).items()}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    out = {}
    for n in SIZES:
        d = tmp_path_factory.mktemp(f"spmd{n}")
        results, outs = run_ranks("spmd", n, d)
        for rc, log in results:
            assert rc == 0, log
        out[n] = outs
    return out


_KEYS = (["shift1_wrap", "shift1_nowrap", "shift-1_wrap", "shift-1_nowrap",
          "shift2_wrap", "shift2_nowrap", "ppermute_partial", "permute_reverse",
          "strided", "transposed", "bf16", "bool",
          "grad_shift", "grad_shift_nowrap", "grad_ppermute"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("key", _KEYS)
def test_matches_jax_namesake(port_results, n, key):
    want = _jax_results(n)[key]
    for rank, out in enumerate(port_results[n]):
        assert out[key].shape == want[rank].shape, (key, rank)
        np.testing.assert_array_equal(out[key], want[rank],
                                      err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("n", SIZES)
def test_ends_and_unsent_ranks_receive_zeros(port_results, n):
    outs = port_results[n]
    assert not outs[0]["shift1_nowrap"].any()
    assert not outs[n - 1]["shift-1_nowrap"].any()
    for rank in range(n - 1):
        assert not outs[rank]["ppermute_partial"].any()
    np.testing.assert_array_equal(outs[n - 1]["ppermute_partial"],
                                  outs[n - 1]["shift-1_wrap"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["dup_dst", "dup_src"])
def test_duplicate_endpoint_raises_arg_error(port_results, n, kind):
    word = "destination" if kind == "dup_dst" else "source"
    for out in port_results[n]:
        assert f"duplicate {word}" in str(out[kind])


def test_size_one_shift_is_a_copy(tmp_path, monkeypatch):
    import zhpe_ompi_tpu_torch as zmpi

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        comm = zmpi.Communicator()
        x = torch.arange(6.0).reshape(2, 3)[:, ::2]
        calls = []
        monkeypatch.setattr(dist, "batch_isend_irecv",
                            lambda ops: calls.append(ops) or [])
        y = comm.shift(x, 1)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        assert not comm.shift(x, 1, wrap=False).any()
        assert torch.equal(comm.ppermute(x, [(0, 0)]), x)
        assert calls == []
    finally:
        dist.destroy_process_group()
