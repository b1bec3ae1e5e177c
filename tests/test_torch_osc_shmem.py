"""The port's device-plane RMA window and PGAS heap against the JAX package's.

Four gloo processes (``tests/_torch_dist_worker.py osc_shmem``, one spawn)
run, and the JAX package runs under ``shard_map`` on four of the suite's
CPU devices:

- ``DeviceWindow`` put (ring), get (right neighbour), accumulate (SUM and
  MAX) and fence, as ``tests/test_osc.py::TestDeviceWindow`` drives them;
  overruns raise ``WinError``, two origins at one target ``ArgError``, and
  the passive-target methods ``WinError`` naming the AM component, in both
  packages.
- Every program of ``shmem_cases`` on a ``DeviceHeap`` of each package:
  put shift, get neighbour, fetch-add ring, state across epochs, mixed-dtype
  arenas, the four device scoll (broadcast, fcollect, reduce_to_all,
  alltoall), the combining fetch-adds (all PEs on one counter, two groups
  with idle ranks, idle ranks fetching zero), barrier ordering, and the
  dryrun's third phase (``__graft_entry__.py``), whose expected values are
  also checked as the dryrun checks them.  Each heap's final contents on
  every PE and each epoch's fetched values are compared.
- What ``tests/test_shmem_device.py`` holds of selection and allocation:
  the spml picks ``device`` for a device communicator, ``--mca spml
  ^device`` leaves nothing (``InternalError``), the host rungs
  (``direct``, ``mmap``, ``am``) do not take a device communicator, offsets are deterministic first-fit, one arena per
  dtype, and bad PEs, colliding puts, size mismatches and bad AMO indices
  raise.

Values are small integers and halves in f32 or int32: the comparisons are
exact.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu.osc.spmd_window import DeviceWindow as JWindow
from zhpe_ompi_tpu.shmem.device import DeviceHeap as JHeap

from _torch_dist_worker import run_ranks, run_shmem_case, shmem_cases

N = 4


@functools.lru_cache(maxsize=None)
def _jax_comm():
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("x",))
    return jz.Communicator(mesh, "x", name="port_osc_shmem")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    results, outs = run_ranks("osc_shmem", N, tmp_path_factory.mktemp("osc"))
    for rc, log in results:
        assert rc == 0, log
    return outs


def _run(body, x):
    comm = _jax_comm()
    return np.asarray(jax.jit(lambda a: comm.run(body, a))(
        comm.device_put_sharded(jnp.asarray(x))))


@functools.lru_cache(maxsize=None)
def _jax_windows():
    ring = [(i + 1) % N for i in range(N)]
    x = np.arange(N, dtype=np.float32).reshape(N, 1)
    comm = _jax_comm()
    want = {}
    want["win_put"] = _run(lambda s: JWindow(comm, jnp.zeros(2, jnp.float32)).put(
        s.reshape(1), ring, [0] * N).shard.reshape(1, 2), x)
    want["win_get"] = _run(lambda s: JWindow(comm, s.reshape(1) * 10).get(
        ring, [0] * N, count=1).reshape(1, 1), x)

    def acc(s, op, val, off):
        win = JWindow(comm, jnp.full((3,), 100.0, jnp.float32))
        return win.accumulate(val(s), ring, [off] * N, op).shard.reshape(1, 3)

    want["win_acc_sum"] = _run(lambda s: acc(s, jz.ops.SUM, lambda t: t.reshape(1) + 1, 1), x)
    want["win_acc_max"] = _run(lambda s: acc(s, jz.ops.MAX, lambda t: t.reshape(1) * 60, 2), x)
    want["win_fence"] = _run(lambda s: JWindow(comm, jnp.full((3,), 100.0, jnp.float32))
                             .fence().shard.reshape(1, 3), x)
    return want


@pytest.mark.parametrize("key", ["win_put", "win_get", "win_acc_sum", "win_acc_max",
                                 "win_fence"])
def test_device_window_matches_jax(ranks, key):
    want = _jax_windows()[key]
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o[key].reshape(-1), want[r].reshape(-1),
                                      err_msg=f"{key} rank {r}")


def test_device_window_values(ranks):
    for r, o in enumerate(ranks):
        left = (r - 1) % N
        np.testing.assert_array_equal(o["win_put"], [left, 0.0])
        np.testing.assert_array_equal(o["win_put_untouched"], [0.0, 0.0])
        np.testing.assert_array_equal(o["win_get"], [((r + 1) % N) * 10.0])
        np.testing.assert_array_equal(o["win_acc_sum"], [100.0, 101.0 + left, 100.0])
        np.testing.assert_array_equal(o["win_acc_max"],
                                      [100.0, 100.0, max(100.0, 60.0 * left)])


def _jax_window_errors():
    ring = [(i + 1) % N for i in range(N)]
    comm = _jax_comm()
    calls = (lambda w, s: w.put(jnp.zeros(2), ring, [2] * N),
             lambda w, s: w.get(ring, [0] * N, count=4),
             lambda w, s: w.accumulate(jnp.zeros(3), ring, [1] * N),
             lambda w, s: w.put(s, [0] * N, [0] * N),
             lambda w, s: w.accumulate(s, [0] * N, [0] * N),
             lambda w, s: w.get([0] * N, [0] * N, count=1),
             lambda w, s: w.put(s, ring[:-1], [0] * N))
    names = []
    for call in calls:
        try:
            _run(lambda s: call(JWindow(comm, jnp.full((3,), 100.0)), s.reshape(1))
                 .shard.reshape(1, 3), np.zeros((N, 1), np.float32))
            names.append("none")
        except jerrors.MpiError as e:
            names.append(type(e).__name__)
    return names


def test_device_window_errors_match_jax(ranks):
    want = _jax_window_errors()
    assert want == ["WinError"] * 3 + ["ArgError"] * 4
    meths = ["lock", "lock_all", "unlock", "unlock_all", "flush", "flush_all",
             "flush_local"]
    for o in ranks:
        assert list(o["win_errors"]) == want + [f"{m}:True" for m in meths]


def test_spml_selection_and_exclusion(ranks):
    for o in ranks:
        assert str(o["spml_selected"]) == "device"
        assert list(o["shmem_pe"]) == ["DeviceHeap", "device"]
        assert str(o["spml_excluded"]) == "InternalError"
        assert str(o["spml_direct"]) == "[False, False, False]"


def test_symmetric_offsets_deterministic_and_arenas(ranks):
    for o in ranks:
        a, b, c, i = o["offsets"]
        assert a == 0 and b >= 4 and c == a and i == 0
        assert list(o["arenas"]) == ["torch.float32", "torch.int32"]
        assert list(o["arena_elems"]) == [(1 << 14) // 4] * 2
    assert len({tuple(o["offsets"]) for o in ranks}) == 1


def test_heap_errors(ranks):
    for o in ranks:
        assert list(o["heap_errors"]) == ["RankError", "ArgError", "CountError",
                                          "ArgError", "RankError", "ArgError"]
        assert int(o["epochs_counted"]) == 0


@functools.lru_cache(maxsize=None)
def _jax_heap(name):
    case = shmem_cases(N)[name]
    comm = _jax_comm()
    heap = JHeap(comm, heap_bytes=case[0])

    def value(pe, spec, sym):
        if spec[0] == "local":
            return pe.local(sym)
        return pe.my_pe().astype(jnp.float32) * spec[1] + jnp.asarray(spec[2], jnp.float32)

    def pe_of(spec):
        return (lambda r, m: (r + spec[1]) % m) if isinstance(spec, tuple) else spec

    def stack(got):
        if not got:
            return None
        return jnp.concatenate([g.reshape(-1).astype(jnp.float32) for g in got])[None]

    syms, outs = run_shmem_case(heap, case, value, pe_of,
                                lambda op: getattr(jz.ops, op), stack,
                                lambda: jnp.zeros((N, 1)))
    reads = [heap.read(s) for s in syms]
    heap.finalize()
    return reads, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("name", list(shmem_cases(N)))
def test_device_heap_program_matches_jax(ranks, name):
    reads, outs = _jax_heap(name)
    for r, o in enumerate(ranks):
        for j, want in enumerate(reads):
            got = o[f"heap/{name}/read{j}"]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} read{j} rank {r}")
        for j, want in enumerate(outs):
            np.testing.assert_array_equal(o[f"heap/{name}/out{j}"].reshape(want.shape),
                                          want, err_msg=f"{name} out{j} rank {r}")


def test_dryrun_phase3_expected_values(ranks):
    """The assertion of ``__graft_entry__.py``'s third phase at 4 PEs."""
    want0 = np.asarray([((r - 1) % N) + 1.0 for r in range(N)])
    for o in ranks:
        got = o["heap/dryrun_phase3/read0"]
        np.testing.assert_allclose(got[:, 0], want0)
        np.testing.assert_allclose(got[:, 1], (np.arange(N) - 1) % N)


def test_combining_fetch_add_linearizes_in_rank_order(ranks):
    """tests/test_shmem_device.py::TestCombiningAMO's expectations at 4 PEs."""
    o = ranks[0]
    old = o["heap/fadd_one_counter/out0"].reshape(N)
    np.testing.assert_array_equal(old, [100.0 + sum(q + 1 for q in range(r)) for r in range(N)])
    got = o["heap/fadd_one_counter/read0"].reshape(N)
    assert got[0] == 100.0 + sum(q + 1 for q in range(N))
    np.testing.assert_array_equal(got[1:], 100.0)
    groups = o["heap/add_two_groups_idle/read0"]
    assert groups[0, 1] == 1 + 2 and groups[2, 1] == 3
    assert groups[1, 1] == groups[3, 1] == 0 and not groups[:, 0].any()
    idle = o["heap/fadd_idle_fetch_zero/out0"].reshape(N)
    np.testing.assert_array_equal(idle, [100.0, 101.0, 0.0, 0.0])
