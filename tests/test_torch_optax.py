"""The port's Adam training step against the JAX package's.

``make_train_step_optax`` of the port (a ``torch.optim.Adam(lr=1e-2)``
factory) against the JAX package's ``make_train_step_optax`` with
``optax.adam(1e-2)``, from the parameters
``zhpe_ompi_tpu.models.transformer.init_params`` makes (as numpy) and the
same tokens, in float32 on the reference paths (``flash=False,
fused_ln=False``): one step, and a second step on the threaded optimizer
state.

- tp = dp = 1: the port through a one-rank gloo ``dp_comm`` against the
  JAX step on a one-device mesh.
- dp2 x tp2 over four gloo processes (``tests/_torch_dist_worker.py
  optax``) against the JAX single-device Adam run (``jax.value_and_grad``
  and ``optax.adam``), as ``tests/test_model.py::TestOptaxStep`` holds the
  JAX package's own sharded step.

Configuration, key and batch are ``tests/test_model.py::TestOptaxStep``'s
(vocab 64, d_model 16, 2 heads, d_ff 32, 2 layers, seq 8, batch 4), and
so is the tolerance: rtol 3e-5 and atol 3e-6 on every parameter, rtol
2e-5 and atol 1e-6 on the loss.  optax adds eps after sqrt(nu_hat) and
torch after sqrt(v)/sqrt(1 - b2^t): the same update in exact arithmetic,
not in bits, and the gradients differ by f32 summation order.  Adam's
first step moves a parameter by lr * g / (|g| + eps), which is steep where
|g| is near eps = 1e-8: at a wider configuration (d_model 64, 2 layers,
seq 32) two of 16,384 ``w2`` elements with |g| ~ 2e-8 differed by 1.1e-4
after one step, from gradients that agree within 9e-10.
"""

import functools
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.models import transformer as tt

from _torch_dist_worker import run_ranks

# tests/test_model.py::TestOptaxStep's configuration, key and batch
SMALL = dict(vocab=64, d_model=16, n_heads=2, d_ff=32, n_layers=2, seq=8)
BATCH = 4
LR = 1e-2
P_RTOL, P_ATOL = 3e-5, 3e-6
L_RTOL, L_ATOL = 2e-5, 1e-6


def _inputs():
    cfg = jt.Config(**SMALL, dtype=jnp.float32, flash=False, fused_ln=False)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    targets = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    return cfg, params, tokens, targets


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """Two single-device Adam steps (value_and_grad + optax.adam): the
    parameters and loss after each, and the initial parameters as numpy."""
    cfg, params, tokens, targets = _inputs()
    opt = optax.adam(LR)
    state = opt.init(params)
    p, out = params, {}
    for i in (1, 2):
        loss, grads = jax.value_and_grad(
            lambda q: jt.loss_fn(q, jnp.asarray(tokens), jnp.asarray(targets), cfg))(p)
        upd, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, upd)
        out[i] = ({k: np.asarray(v) for k, v in p.items()}, float(loss))
    return {k: np.asarray(v) for k, v in params.items()}, tokens, targets, out


@functools.lru_cache(maxsize=None)
def _jax_optax_step():
    """The JAX package's make_train_step_optax on a one-device mesh, two
    steps."""
    cfg, params, tokens, targets = _inputs()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    dp_comm = jz.Communicator(mesh, "dp", name="port_optax_dp")
    init, step, _ = jt.make_train_step_optax(cfg, mesh, dp_comm, None,
                                             optimizer=optax.adam(LR))
    p = {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}
    state = init(p)
    out = {}
    for i in (1, 2):
        p, state, loss = step(p, state, jnp.asarray(tokens), jnp.asarray(targets))
        out[i] = ({k: np.asarray(v) for k, v in p.items()}, float(loss))
    return out


@pytest.fixture
def one_rank_comm():
    import zhpe_ompi_tpu_torch as zmpi

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            yield zmpi.Communicator(name="dp")
        finally:
            dist.destroy_process_group()


def _port_cfg():
    return tt.Config(**SMALL, dtype=torch.float32, flash=False, fused_ln=False)


def _assert_close(got: dict, loss: float, want: dict, wloss: float, tag: str):
    np.testing.assert_allclose(loss, wloss, rtol=L_RTOL, atol=L_ATOL, err_msg=tag)
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=f"{tag} {name}")


@pytest.mark.parametrize("n_step", [1, 2])
def test_adam_steps_match_jax_make_train_step_optax(one_rank_comm, n_step):
    np_params, tokens, targets, _ = _jax_reference()
    want, wloss = _jax_optax_step()[n_step]
    cfg = _port_cfg()
    init, step, specs = tt.make_train_step_optax(
        cfg, one_rank_comm, optimizer=lambda ps: torch.optim.Adam(ps, lr=LR))
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    opt = init(params)
    for _ in range(n_step):
        out, opt2, loss = step(params, opt, tokens, targets)
        # the step updates the same tensors and optimizer in place
        assert out is params and opt2 is opt
    got = {k: v.numpy() for k, v in params.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    _assert_close(got, float(loss), want, wloss, f"step {n_step}")
    assert specs == {"embed": None, "wqkv": 3, "wo": 1, "w1": 2, "w2": 1,
                     "ln1": None, "ln2": None, "lnf": None}


def test_default_optimizer_is_adam_with_optax_defaults(one_rank_comm):
    np_params, tokens, targets, _ = _jax_reference()
    cfg = _port_cfg()
    init, _, _ = tt.make_train_step_optax(cfg, one_rank_comm)
    opt = init(tt.params_from_numpy(np_params, cfg, device="cpu"))
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"]) == (1e-3, (0.9, 0.999), 1e-8)
    assert group["weight_decay"] == 0


def test_step_refuses_params_the_optimizer_does_not_own(one_rank_comm):
    np_params, tokens, targets, _ = _jax_reference()
    cfg = _port_cfg()
    init, step, _ = tt.make_train_step_optax(cfg, one_rank_comm)
    opt = init(tt.params_from_numpy(np_params, cfg, device="cpu"))
    others = tt.params_from_numpy(np_params, cfg, device="cpu")
    with pytest.raises(errors.ArgError, match="init_opt_state"):
        step(others, opt, tokens, targets)


@pytest.mark.parametrize("kw", [{"dcn_proc": object()}, {"dcn_weight": 0.5},
                                {"dcn_sharded": True}],
                         ids=["dcn_proc", "dcn_weight", "dcn_sharded"])
def test_dcn_path_waits_for_hybrid(one_rank_comm, kw):
    with pytest.raises(errors.UnsupportedError, match="parallel/hybrid.py"):
        tt.make_train_step_optax(_port_cfg(), one_rank_comm, **kw)


def test_jax_optax_step_is_the_single_device_adam_run():
    """The JAX reference the gloo case is held to is the JAX package's own
    one-device step (as tests/test_model.py holds its sharded one)."""
    _, _, _, ref = _jax_reference()
    for i in (1, 2):
        want, wloss = _jax_optax_step()[i]
        _assert_close(ref[i][0], ref[i][1], want, wloss, f"step {i}")


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    np_params, tokens, targets, ref = _jax_reference()
    d = tmp_path_factory.mktemp("optax")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets, lr=LR,
             **{f"p_{k}": v for k, v in np_params.items()}, **SMALL)
    results, outs = run_ranks("optax", 4, d)
    for rc, log in results:
        assert rc == 0, log
    return outs, ref


@pytest.mark.parametrize("n_step", [1, 2])
def test_dp2_tp2_adam_over_gloo_equals_single_device_jax(dp2_tp2, n_step):
    outs, ref = dp2_tp2
    want, wloss = ref[n_step]
    by_pos = {tuple(o["dp_tp"]): o for o in outs}
    assert sorted(by_pos) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        np.testing.assert_allclose(float(o[f"s{n_step}_loss"]), wloss,
                                   rtol=L_RTOL, atol=L_ATOL)
    for name, arr in want.items():
        axis = tt._TP_AXIS.get(name)
        for dp_rank in range(2):
            shards = [by_pos[(dp_rank, t)][f"s{n_step}_{name}"] for t in range(2)]
            if axis is None:
                # replicated over tp: the same bits on both tp ranks
                np.testing.assert_array_equal(shards[0], shards[1], err_msg=name)
                got = shards[0]
            else:
                got = np.concatenate(shards, axis=axis)
            np.testing.assert_allclose(got, arr, rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=f"{name} dp rank {dp_rank}")
