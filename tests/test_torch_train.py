"""The PyTorch port's training step against the JAX package's.

One ``make_train_step`` step of the port, from the parameters
``zhpe_ompi_tpu.models.transformer.init_params`` makes (as numpy) and the
same tokens, against the JAX single-device step: ``jax.value_and_grad`` of
``loss_fn`` and the SGD update ``p - lr * g`` (as ``tests/test_model.py``
builds it).  Small config (vocab 256, d_model 128, 4 heads, d_ff 256, 2
layers, seq 64, batch 2), float32.

- tp = dp = 1 on the kernel path (``flash=True, fused_ln=True``,
  ``ce_chunk=64``: the JAX package's Pallas kernels interpreted and its
  chunked-CE custom vjp; the port's kernels' plain versions and its
  chunked-CE backward) and on the reference path (``False``, unchunked),
  through a one-rank gloo ``Communicator`` as ``dp_comm``.
- dp2 x tp2 over four gloo processes (``tests/_torch_dist_worker.py``
  ``train``): each rank steps its tp shards on its dp slice of the batch,
  and the reassembled parameters equal the JAX single-device step; the
  tp-replicated parameters are the same bits on both tp ranks.

Tolerance: rtol 2e-4, atol 2e-6 on the loss and on every updated
parameter.  Both sides compute in f32 and differ by summation order (and
the tp split of the products); the update moves a parameter by lr * g with
lr = 1e-2, so an f32 difference in g of order 1e-5 moves it by ~1e-7.
"""

import functools
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu_torch.models import transformer as tt

from _torch_dist_worker import run_ranks

SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=64)
BATCH = 2
LR = 1e-2
RTOL, ATOL = 2e-4, 2e-6
PATHS = [pytest.param(True, 64, id="kernel-chunked"),
         pytest.param(False, None, id="reference")]


@functools.lru_cache(maxsize=None)
def _jax_step(path, ce_chunk):
    """The JAX single-device step, and the inputs it took as numpy (made
    once per path: the interpreted Pallas kernels take seconds)."""
    cfg = jt.Config(**SMALL, dtype=jnp.float32, flash=path, fused_ln=path,
                    ce_chunk=ce_chunk)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    targets = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    loss, grads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets), cfg)
    )(params)
    want = {k: np.asarray(params[k] - LR * grads[k]) for k in params}
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return np_params, tokens, targets, float(loss), want


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


@pytest.mark.parametrize("path,ce_chunk", PATHS)
def test_one_step_matches_jax_single_device(one_rank_comm, path, ce_chunk):
    np_params, tokens, targets, jloss, want = _jax_step(path, ce_chunk)
    cfg = tt.Config(**SMALL, dtype=torch.float32, flash=path, fused_ln=path,
                    ce_chunk=ce_chunk)
    step, specs = tt.make_train_step(cfg, one_rank_comm, lr=LR)
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    new_params, loss = step(params, tokens, targets)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL, atol=ATOL)
    assert set(new_params) == set(want)
    for name, arr in want.items():
        got = new_params[name]
        assert got.dtype == torch.float32 and tuple(got.shape) == arr.shape
        np.testing.assert_allclose(got.numpy(), arr, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        # the step returns new tensors and leaves its inputs as they were
        assert torch.equal(params[name], before[name])
    assert specs == {"embed": None, "wqkv": 3, "wo": 1, "w1": 2, "w2": 1,
                     "ln1": None, "ln2": None, "lnf": None}


def test_dp2_tp2_step_over_gloo_equals_single_device_jax(tmp_path):
    np_params, tokens, targets, jloss, want = _jax_step(True, 64)
    np.savez(tmp_path / "inputs.npz", tokens=tokens, targets=targets,
             ce_chunk=64, lr=LR,
             **{f"p_{k}": v for k, v in np_params.items()}, **SMALL)
    results, outs = run_ranks("train", 4, tmp_path)
    for rc, log in results:
        assert rc == 0, log
    by_pos = {tuple(o["dp_tp"][:2]): o for o in outs}
    assert sorted(by_pos) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(tuple(o["dp_tp"][2:]) == (2, 2) for o in outs)
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), jloss, rtol=RTOL, atol=ATOL)
    for name, arr in want.items():
        axis = tt._TP_AXIS.get(name)
        for dp_rank in range(2):
            shards = [by_pos[(dp_rank, t)][f"p_{name}"] for t in range(2)]
            if axis is None:
                # replicated over tp: the same bits on both tp ranks
                np.testing.assert_array_equal(shards[0], shards[1], err_msg=name)
                got = shards[0]
            else:
                got = np.concatenate(shards, axis=axis)
            np.testing.assert_allclose(got, arr, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} dp rank {dp_rank}")

