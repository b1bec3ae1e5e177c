"""The port's expert and pipeline parallelism against the JAX package's.

- ``moe_ffn`` at ep 4 (the world of four gloo processes) and ep 2 (each
  half of it, from ``Communicator.split``), at capacity factors 1.25 and
  0.5 (the second drops tokens), against the JAX package's ``moe_ffn``
  under ``shard_map`` on as many of the suite's CPU devices and against
  ``moe_reference_dense``: outputs, the kept-token masks, and the
  gradients of ``sum(y * c)`` for a fixed cotangent c with respect to the
  tokens, the expert weights and the router (the port's router gradient is
  each rank's part; their sum is the JAX package's) against ``jax.grad``.
- ``pipeline_apply`` at pp 4 against the JAX package's under ``shard_map``
  and against the sequential loop over the four stages, and at pp 1.
- The port's form of ``__graft_entry__._dryrun_impl``'s second phase at 4
  ranks (``moe_ffn`` through ``Communicator.run`` at capacity factor ep,
  then a ``t @ w + 1`` pipeline), against that phase run in the JAX
  package.

Inputs come from ``tests/_torch_dist_worker.py`` (``moe_pipe_inputs``, a
fixed seed); one spawn of four ranks (``moe_pipe``) serves every case.
Tolerance: rtol 2e-5, atol 2e-6 (f32 products summed in another order);
the kept-token masks are equal.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu import compat
from zhpe_ompi_tpu.models import moe as jmoe
from zhpe_ompi_tpu.models import pipeline as jpipe
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.models import moe as tmoe
from zhpe_ompi_tpu_torch.models import pipeline as tpipe

from _torch_dist_worker import MOE_CAPACITY, moe_pipe_inputs, run_ranks

RTOL, ATOL = 2e-5, 2e-6
EP = {"moe": 4, "moe2": 2}
PSPEC = {"router": P(), "w_in": P("ep"), "w_out": P("ep")}


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("ep",))


def _dryrun_inputs():
    """__graft_entry__.py's phase-2 inputs at ep = 4."""
    ep, D, F, T_local = 4, 8, 16, 4
    prm = jmoe.init_moe_params(jax.random.PRNGKey(1), D, F, ep)
    r2 = np.random.default_rng(1)
    x_all = np.asarray(r2.normal(size=(ep * T_local, D)), np.float32)
    ws = np.asarray(r2.normal(size=(ep, D, D)) * 0.3, np.float32)
    xs = np.asarray(r2.normal(size=(4, 2, D)), np.float32)
    return {k: np.asarray(v) for k, v in prm.items()}, x_all, ws, xs


def _jax_dryrun():
    """The dryrun's phase 2 in the JAX package, on four CPU devices."""
    prm, x_all, ws, xs = _dryrun_inputs()
    mesh = _mesh(4)
    comm = jz.Communicator(mesh, "ep", name="port_dry_ep")
    pm = {k: jax.device_put(v, NamedSharding(mesh, PSPEC[k])) for k, v in prm.items()}
    y = comm.run(
        lambda p, xx: jmoe.moe_ffn(comm, p, xx, capacity_factor=4.0)[0],
        pm, jax.device_put(jnp.asarray(x_all), NamedSharding(mesh, P("ep"))),
        in_specs=(PSPEC, P("ep")), out_specs=P("ep"))
    pp = comm.run(
        lambda W, x: jpipe.pipeline_apply(comm, lambda w, t: t @ w[0] + 1.0, W, x),
        jax.device_put(jnp.asarray(ws), NamedSharding(mesh, P("ep"))), jnp.asarray(xs),
        in_specs=(P("ep"), P()), out_specs=P("ep"))
    return np.asarray(y), np.asarray(pp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    prm, x_all, ws, xs = _dryrun_inputs()
    d = tmp_path_factory.mktemp("moe_pipe")
    np.savez(d / "inputs.npz", dry_x=x_all, dry_ws=ws, dry_xs=xs,
             **{f"dry_{k}": v for k, v in prm.items()})
    results, outs = run_ranks("moe_pipe", 4, d)
    for rc, log in results:
        assert rc == 0, log
    return outs


@functools.lru_cache(maxsize=None)
def _jax_moe(tag, cf):
    """y, keep and the gradients of sum(y * cot) through the JAX package's
    moe_ffn under shard_map, and the dense reference's y."""
    inp = moe_pipe_inputs()
    n = EP[tag]
    mesh = _mesh(n)
    comm = jz.Communicator(mesh, "ep", name=f"port_{tag}_{cf}")
    prm = {k: jnp.asarray(inp[f"{tag}_{k}"]) for k in ("router", "w_in", "w_out")}
    x, cot = jnp.asarray(inp[f"{tag}_x"]), jnp.asarray(inp[f"{tag}_cot"])

    def f(p, xx):
        return compat.shard_map(
            lambda pp, xs: jmoe.moe_ffn(comm, pp, xs, capacity_factor=cf),
            mesh=mesh, in_specs=(PSPEC, P("ep")), out_specs=(P("ep"), P("ep")),
            check_vma=False)(p, xx)

    def loss(p, xx):
        y, keep = f(p, xx)
        return jnp.sum(y * cot), (y, keep)

    (_, (y, keep)), (gp, gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(prm, x)
    T = x.shape[0] // n
    cap = max(1, int(cf * T / n))
    dense = jax.jit(lambda p, xx: jmoe.moe_reference_dense(
        p, xx, n, cap, block_tokens=T))(prm, x)
    return (np.asarray(y), np.asarray(keep), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx), np.asarray(dense))


def _by_group(outs, tag):
    """Each group's ranks' outputs in group-rank order."""
    if tag == "moe":
        return [outs]
    return [outs[:2], outs[2:]]


@pytest.mark.parametrize("cf", MOE_CAPACITY)
@pytest.mark.parametrize("tag", ["moe", "moe2"])
def test_moe_ffn_matches_jax_and_dense(ranks, tag, cf):
    y, keep, _, _, dense = _jax_moe(tag, cf)
    key = f"{tag}@{cf}"
    for group in _by_group(ranks, tag):
        got_y = np.concatenate([o[f"{key}/y"] for o in group])
        got_keep = np.concatenate([o[f"{key}/keep"] for o in group])
        np.testing.assert_array_equal(got_keep, keep)
        np.testing.assert_allclose(got_y, y, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_y, dense, rtol=RTOL, atol=ATOL)
    if cf < 1:
        assert not keep.all(), "the small capacity factor must drop tokens"


@pytest.mark.parametrize("cf", MOE_CAPACITY)
@pytest.mark.parametrize("tag", ["moe", "moe2"])
def test_moe_ffn_gradients_match_jax_grad(ranks, tag, cf):
    _, _, gp, gx, _ = _jax_moe(tag, cf)
    key = f"{tag}@{cf}"
    for group in _by_group(ranks, tag):
        np.testing.assert_allclose(
            np.concatenate([o[f"{key}/dx"] for o in group]), gx, rtol=RTOL, atol=ATOL)
        for k in ("w_in", "w_out"):
            np.testing.assert_allclose(
                np.concatenate([o[f"{key}/d{k}"] for o in group]), gp[k],
                rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(
            sum(o[f"{key}/drouter"] for o in group), gp["router"],
            rtol=RTOL, atol=ATOL)


def _sequential(ws, xs):
    out = []
    for x in xs:
        t = x
        for w in ws:
            t = t @ w + 1.0
        out.append(t)
    return np.stack(out)


def test_pipeline_pp4_matches_jax_and_sequential(ranks):
    inp = moe_pipe_inputs()
    ws, xs = inp["pp_w"], inp["pp_x"]
    mesh = _mesh(4)
    comm = jz.Communicator(mesh, "ep", name="port_pp4")
    want = np.asarray(comm.run(
        lambda W, x: jpipe.pipeline_apply(comm, lambda w, t: t @ w[0] + 1.0, W, x),
        jnp.asarray(ws), jnp.asarray(xs), in_specs=(P("ep"), P()),
        out_specs=P("ep"))).reshape((4,) + xs.shape)
    for r, o in enumerate(ranks):
        np.testing.assert_allclose(o["pp4"], want[r], rtol=RTOL, atol=ATOL)
    # outputs are significant on the last stage only; the others are zero
    np.testing.assert_allclose(ranks[3]["pp4"], _sequential(ws, xs), rtol=RTOL, atol=ATOL)
    for o in ranks[:3]:
        assert not o["pp4"].any()


def test_pipeline_pp1_is_the_stage_over_each_microbatch(ranks):
    inp = moe_pipe_inputs()
    ws, xs = inp["pp_w"], inp["pp_x"]
    for r, o in enumerate(ranks):
        mesh = _mesh(1)
        comm = jz.Communicator(mesh, "ep", name=f"port_pp1_{r}")
        want = np.asarray(comm.run(
            lambda W, x: jpipe.pipeline_apply(comm, lambda w, t: t @ w[0] + 1.0, W, x),
            jnp.asarray(ws[r:r + 1]), jnp.asarray(xs), in_specs=(P("ep"), P()),
            out_specs=P()))
        np.testing.assert_allclose(o["pp1"], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o["pp1"], _sequential(ws[r:r + 1], xs),
                                   rtol=RTOL, atol=ATOL)


def test_dryrun_phase2_at_four_ranks(ranks):
    y, pp = _jax_dryrun()
    for o in ranks:
        np.testing.assert_allclose(o["dry_moe"], y, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o["dry_pp"], pp, rtol=RTOL, atol=ATOL)
        assert np.isfinite(o["dry_moe"]).all() and np.isfinite(o["dry_pp"]).all()


def test_moe_reference_dense_matches_jax():
    inp = moe_pipe_inputs()
    prm = {k: inp[f"moe_{k}"] for k in ("router", "w_in", "w_out")}
    x = inp["moe_x"]
    for cap in (1, 3):
        want = np.asarray(jmoe.moe_reference_dense(
            {k: jnp.asarray(v) for k, v in prm.items()}, jnp.asarray(x), 4, cap,
            block_tokens=16))
        got = tmoe.moe_reference_dense(
            tmoe.moe_params_from_numpy(prm, device="cpu"), torch.from_numpy(x), 4,
            cap, block_tokens=16).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_params_from_numpy_slices_the_expert():
    inp = moe_pipe_inputs()
    prm = {k: inp[f"moe_{k}"] for k in ("router", "w_in", "w_out")}
    got = tmoe.moe_params_from_numpy(prm, device="cpu", ep_rank=2)
    assert tuple(got["w_in"].shape) == (1, 8, 16)
    np.testing.assert_array_equal(got["w_out"][0].numpy(), prm["w_out"][2])
    np.testing.assert_array_equal(got["router"].numpy(), prm["router"])
    with pytest.raises(errors.ArgError):
        tmoe.moe_params_from_numpy(prm, device="cpu", ep_rank=4)


def _host_moe_inputs():
    """moe_host_ffn's case: 4 thread ranks, D 64, d_ff 128, 32 f32 tokens
    per rank, a fixed seed."""
    rng = np.random.default_rng(808)
    n, D, F, T = 4, 64, 128, 32
    return {
        "router": (rng.standard_normal((D, n)) * D ** -0.5).astype(np.float32),
        "w_in": (rng.standard_normal((n, D, F)) * D ** -0.5).astype(np.float32),
        "w_out": (rng.standard_normal((n, F, D)) * F ** -0.5).astype(np.float32),
        "x": rng.standard_normal((n * T, D)).astype(np.float32),
    }, n, T


def test_moe_host_ffn_waits_for_host_collectives():
    """``moe_host_ffn`` over the port's host plane (a 4-rank thread
    universe, both transposes through ``RankContext.alltoall``) against the
    namesake's ``moe_host_ffn`` on its own ``LocalUniverse`` and against
    ``moe_reference_dense``, at capacity factors 1.25 and 0.5 (the second
    drops tokens).  The name dates from when the port waited for
    ``coll/host.py``."""
    from zhpe_ompi_tpu.pt2pt.universe import LocalUniverse as JUniverse
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse as TUniverse

    inp, n, T = _host_moe_inputs()
    x = inp["x"]
    for cf in MOE_CAPACITY:
        tuni = TUniverse(n)
        try:
            port = tuni.run(lambda ctx: tmoe.moe_host_ffn(
                ctx, tmoe.moe_params_from_numpy(inp, device="cpu", ep_rank=ctx.rank),
                torch.from_numpy(x[ctx.rank * T:(ctx.rank + 1) * T]),
                capacity_factor=cf), timeout=60.0)
        finally:
            tuni.close()
        juni = JUniverse(n)

        def jprog(ctx):
            r = ctx.rank
            prm = {"router": jnp.asarray(inp["router"]),
                   "w_in": jnp.asarray(inp["w_in"][r:r + 1]),
                   "w_out": jnp.asarray(inp["w_out"][r:r + 1])}
            y, keep = jmoe.moe_host_ffn(ctx, prm, jnp.asarray(x[r * T:(r + 1) * T]),
                                        capacity_factor=cf)
            return np.asarray(y), np.asarray(keep)

        ref = juni.run(jprog, timeout=60.0)
        y = np.concatenate([p[0].numpy() for p in port])
        keep = np.concatenate([p[1].numpy() for p in port])
        assert keep.tolist() == np.concatenate([r[1] for r in ref]).tolist()
        np.testing.assert_allclose(y, np.concatenate([r[0] for r in ref]),
                                   rtol=RTOL, atol=ATOL)
        cap = max(1, int(cf * T / n))
        dense = tmoe.moe_reference_dense(tmoe.moe_params_from_numpy(inp, device="cpu"),
                                         torch.from_numpy(x), n, cap, block_tokens=T)
        np.testing.assert_allclose(y, dense.numpy(), rtol=RTOL, atol=ATOL)
        assert 0 < keep.sum() <= n * n * cap


def test_moe_host_ffn_timings_and_han_route():
    """The ``timings`` split covers the call, and ``coll_han_enable=on``
    routes both transposes through the han seam: on a thread universe
    (one locality group) that is the loud fallback to the flat alltoall,
    counted once per transpose and rank, and ``y`` is the same."""
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse
    from zhpe_ompi_tpu_torch.runtime import spc

    inp, n, T = _host_moe_inputs()
    uni = LocalUniverse(n)

    def prog(ctx):
        t = {}
        y, _ = tmoe.moe_host_ffn(
            ctx, tmoe.moe_params_from_numpy(inp, device="cpu", ep_rank=ctx.rank),
            torch.from_numpy(inp["x"][:T]), timings=t)
        return t, y

    try:
        res = uni.run(prog, timeout=60.0)
        for t, y in res:
            assert y.shape == (T, 64)
            assert set(t) == {"route", "d2h", "alltoall", "h2d", "expert", "combine"}
            assert all(v >= 0.0 for v in t.values())
        old = mca_var.get("coll_han_enable")
        mca_var.set_var("coll_han_enable", "on")
        fb0 = spc.read("han_flat_fallbacks")
        try:
            forced = uni.run(prog, timeout=60.0)
        finally:
            mca_var.set_var("coll_han_enable", old)
        assert spc.read("han_flat_fallbacks") - fb0 == 2 * n
        for (_, y), (_, y_on) in zip(res, forced):
            assert torch.equal(y, y_on)
    finally:
        uni.close()


def test_pipeline_single_stage_without_a_process_group():
    class One:
        size, rank = 1, 0

    xs = torch.arange(6.0).reshape(3, 2)
    out = tpipe.pipeline_apply(One(), lambda w, t: t * w, torch.tensor(2.0), xs)
    np.testing.assert_array_equal(out.numpy(), xs.numpy() * 2)
