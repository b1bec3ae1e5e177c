"""The port's process topologies and neighbor collectives against the JAX
package's.

- Tables, in process: ``dims_create``; cartesian coordinates, ranks,
  shift tables and neighbor lists; graph and distributed-graph adjacency
  and their errors; ``reorder_greedy`` — every answer of the port equal to
  the JAX package's on the same arguments (``tests/test_topo.py``'s cases
  and more).
- Exchanges, at 4 and at 8 gloo ranks (``tests/_torch_dist_worker.py
  topo``, one spawn per size), against the JAX package under ``shard_map``
  on as many of the suite's CPU devices: every case of ``topo_cases``
  (``neighbor_allgather`` and ``neighbor_alltoall`` on periodic,
  non-periodic and 2-D cartesian grids, a graph ring, a directed star, a
  random distributed graph, the size-2 periodic grid whose duplicate edges
  pair by occurrence; and ``shift_exchange`` along each kind of dimension),
  and ``CartTopology.sub`` at 8.

Values are small integers in f32: the comparisons are exact.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu import topo as jtopo
from zhpe_ompi_tpu.core import errors as jerrors
from zhpe_ompi_tpu_torch import topo as ttopo
from zhpe_ompi_tpu_torch.core import errors as terrors

from _torch_dist_worker import build_topology, run_ranks, topo_cases

SIZES = (4, 8)


def _comm(n):
    return SimpleNamespace(size=n, name=f"table{n}")


def _outcome(fn):
    try:
        return ("ok", fn())
    except (jerrors.MpiError, terrors.MpiError) as e:
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("args", [(8, 3, None), (12, 2, None), (7, 2, None),
                                  (8, 2, [4, 0]), (6, 3, [0, 3, 0]), (36, 4, None),
                                  (8, 2, [3, 0]), (8, 2, [2, 2]), (0, 2, None),
                                  (16, 3, [0, -1, 0])])
def test_dims_create(args):
    n, ndims, dims = args
    assert _outcome(lambda: ttopo.dims_create(n, ndims, dims)) == \
        _outcome(lambda: jtopo.dims_create(n, ndims, dims))


CARTS = [((4, 2), (True, False)), ((8,), (True,)), ((8,), (False,)),
         ((2, 2, 2), (True, False, True)), ((2,), (True,))]


@pytest.mark.parametrize("dims,periods", CARTS)
def test_cart_tables(dims, periods):
    n = int(np.prod(dims))
    t = ttopo.CartTopology(_comm(n), dims, periods=periods)
    j = jtopo.CartTopology(_comm(n), dims, periods=periods)
    for r in range(n):
        assert t.coords(r) == j.coords(r)
        assert t.neighbor_ranks(r) == j.neighbor_ranks(r)
        assert t.rank_of(t.coords(r)) == r
    for d in range(len(dims)):
        for disp in (1, -1, 2):
            assert t.shift(d, disp) == j.shift(d, disp)
    for coords in ([-1] * len(dims), [dims[0]] + [0] * (len(dims) - 1)):
        assert _outcome(lambda: t.rank_of(coords)) == _outcome(lambda: j.rank_of(coords))
    assert t.degree == j.degree


def test_cart_errors():
    for dims, periods in (((3, 2), None), ((0, 8), None), ((8,), (True, True))):
        assert _outcome(lambda: ttopo.CartTopology(_comm(8), dims, periods))[0] == "raised"
        assert _outcome(lambda: ttopo.CartTopology(_comm(8), dims, periods))[1] == \
            _outcome(lambda: jtopo.CartTopology(_comm(8), dims, periods))[1]


def test_graph_tables():
    n = 8
    index, edges = [], []
    for r in range(n):
        edges += [(r - 1) % n, (r + 1) % n, (r + 3) % n]
        index.append(len(edges))
    t = ttopo.GraphTopology(_comm(n), index, edges)
    j = jtopo.GraphTopology(_comm(n), index, edges)
    for r in range(n):
        assert t.neighbors(r) == j.neighbors(r)
        assert t.in_neighbors(r) == j.in_neighbors(r)
        assert t.neighbors_count(r) == j.neighbors_count(r)
    assert t.degree == j.degree
    for bad in (([2] + [1] * (n - 1), [0, 1]), ([1] * n, [0, 1]),
                (list(range(1, n + 1)), [9] * n)):
        assert _outcome(lambda: ttopo.GraphTopology(_comm(n), *bad)) == \
            _outcome(lambda: jtopo.GraphTopology(_comm(n), *bad))
        assert _outcome(lambda: ttopo.GraphTopology(_comm(n), *bad))[0] == "raised"


def test_dist_graph_tables():
    n = 8
    edge_list = [(r, (r + 1) % n) for r in range(n)] + [(0, 5), (3, 5)]
    t = ttopo.DistGraphTopology.from_edges(_comm(n), edge_list)
    j = jtopo.DistGraphTopology.from_edges(_comm(n), edge_list)
    for r in range(n):
        assert t.neighbors_count(r) == j.neighbors_count(r)
        assert t.neighbors(r) == j.neighbors(r)
    assert t.degree == j.degree
    for bad in (([[1]] + [[]] * (n - 1), [[]] * n), ([[]] * n, [[9]] + [[]] * (n - 1))):
        assert _outcome(lambda: ttopo.DistGraphTopology(_comm(n), *bad)) == \
            _outcome(lambda: jtopo.DistGraphTopology(_comm(n), *bad))


def test_reorder_greedy():
    t = np.zeros((4, 4))
    t[0, 3], t[3, 1], t[1, 2] = 10.0, 5.0, 1.0
    rng = np.random.default_rng(9)
    for traffic in (t, rng.random((8, 8)), np.ones((1, 1)), rng.random((6, 6))):
        assert ttopo.reorder_greedy(traffic) == jtopo.reorder_greedy(traffic)
    assert _outcome(lambda: ttopo.reorder_greedy(np.ones((2, 3)))) == ("raised", "ArgError")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The outputs of one spawn per size, made on first use."""
    spawned = {}

    def get(n):
        if n not in spawned:
            results, outs = run_ranks("topo", n, tmp_path_factory.mktemp(f"topo{n}"))
            for rc, log in results:
                assert rc == 0, log
            spawned[n] = outs
        return spawned[n]

    return get


@functools.lru_cache(maxsize=None)
def _jax_cases(n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("world",))
    world = jz.Communicator(mesh, "world", name=f"port_topo{n}")
    want = {}
    for name, (spec, op, x) in topo_cases(n).items():
        t, c = build_topology(jtopo, world, spec)
        if op == "allgather":
            fn = lambda s, t=t: jtopo.neighbor_allgather(t, s)[None]  # noqa: E731
        elif op == "alltoall":
            fn = lambda s, t=t: jtopo.neighbor_alltoall(t, s[0])[None]  # noqa: E731
        else:
            fn = lambda s, t=t, op=op: t.shift_exchange(s, op[1], op[2])  # noqa: E731
        xs = c.device_put_sharded(jnp.asarray(x))
        want[name] = np.asarray(jax.jit(
            lambda a, c=c, fn=fn: c.run(fn, a, out_specs=P("world")))(xs))
    return want


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(topo_cases(8)))
def test_exchange_matches_jax(ranks, n, name):
    outs = ranks(n)
    want = _jax_cases(n)[name]
    per_rank = want.reshape((n,) + outs[0][name].shape)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[name], per_rank[r], err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("n", SIZES)
def test_cart_ring_allgather_values(ranks, n):
    for r, o in enumerate(ranks(n)):
        got = o["cart_ring_allgather"].reshape(2)
        np.testing.assert_array_equal(got, [(r - 1) % n, (r + 1) % n])
        edge = o["cart_nonperiodic_allgather"].reshape(2)
        assert (r > 0 or edge[0] == 0.0) and (r < n - 1 or edge[1] == 0.0)


def test_cart_sub_at_eight(ranks):
    outs = ranks(8)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("world",))
    world = jz.Communicator(mesh, "world", name="port_topo_sub")
    cart = jtopo.CartTopology(world, (4, 2), periods=(True, False))
    rows, rtopo = cart.sub([True, False])
    want = np.array([g.ranks for g in rows.partition])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["sub_partition"], want)
        size, sub_rank, dim, period = o["sub_topo"]
        assert (size, dim, period) == (4, rtopo.dims[0], rtopo.periods[0])
        group = [g for g in rows.partition if r in g.ranks][0]
        assert group.ranks[sub_rank] == r
        # periodic ring of the column: from the rank one row up
        left = group.ranks[(sub_rank - 1) % 4]
        np.testing.assert_array_equal(o["sub_shift"], [float(left)])
