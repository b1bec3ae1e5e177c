"""The PyTorch port's sequence-parallel training step against the JAX
package's single-device step.

One ``make_train_step`` step of the port with ``sp_comm`` (ring attention
and the sp-mean of ``_sync_grads``), over gloo processes
(``_torch_dist_worker`` ``sp_train``; world rank = row-major index of the
("dp", "tp", "sp") mesh, as ``make_train_step``'s docstring sets out),
against ``jax.value_and_grad`` of the JAX package's ``loss_fn`` on one
device and the SGD update ``p - lr * g``, from the same numpy parameters
and tokens.  Small config (vocab 256, d_model 128, 4 heads, d_ff 256, 2
layers, seq 64, batch 2), f32, ``ce_chunk=64``; the port runs its kernel
path (the layernorm kernel's plain version; attention is the ring under
``sp_comm``), the JAX step its reference path.

- dp2 x tp2 x sp2 over 8 ranks, contiguous ring: each rank takes its dp
  row, its tp shards and its sequence half;
- sp4 over 4 ranks, zigzag ring: tokens and targets zigzag-permuted as
  ``tests/test_parallelism.py::test_sp_train_loss_matches_dense`` permutes
  them (rank i holds global chunks i and 7 − i);
- dp2 x tp2 x sp2 again with ``remat``: the backward recomputes each
  layer, its tp allreduces and sp shifts included, on every rank in the
  same order.

Every rank's loss, and every updated parameter (tp shards reassembled),
equals the JAX step within rtol 2e-4, atol 2e-6 (``test_torch_train.py``'s
tolerance: both sides in f32, differing in summation order, the ring's
block order and the tp split); tp-replicated parameters are the same bits
on both tp ranks.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu_torch.models import transformer as tt

from _torch_dist_worker import run_ranks

SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=64)
BATCH = 2
LR = 1e-2
CE_CHUNK = 64
RTOL, ATOL = 2e-4, 2e-6


@functools.lru_cache(maxsize=None)
def _jax_step():
    cfg = jt.Config(**SMALL, dtype=jnp.float32, flash=False, fused_ln=False,
                    ce_chunk=CE_CHUNK)
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


@pytest.mark.parametrize("layout,zigzag,remat", [
    ((2, 2, 2), False, False), ((1, 1, 4), True, False), ((2, 2, 2), False, True)],
    ids=["dp2-tp2-sp2-contiguous", "sp4-zigzag", "dp2-tp2-sp2-contiguous-remat"])
def test_sp_step_over_gloo_equals_single_device_jax(tmp_path, layout, zigzag,
                                                    remat):
    np_params, tokens, targets, jloss, want = _jax_step()
    np.savez(tmp_path / "inputs.npz", tokens=tokens, targets=targets,
             ce_chunk=CE_CHUNK, lr=LR, layout=np.array(layout), zigzag=zigzag,
             remat=remat,
             **{f"p_{k}": v for k, v in np_params.items()}, **SMALL)
    dp, tp, sp = layout
    results, outs = run_ranks("sp_train", dp * tp * sp, tmp_path, timeout=240)
    for rc, log in results:
        assert rc == 0, log
    by_pos = {tuple(o["at"]): o for o in outs}
    assert len(by_pos) == dp * tp * sp
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), jloss, rtol=RTOL, atol=ATOL)
    for name, arr in want.items():
        axis = tt._TP_AXIS.get(name)
        for d in range(dp):
            for s in range(sp):
                shards = [by_pos[(d, t, s)][f"p_{name}"] for t in range(tp)]
                if axis is None:
                    # replicated over tp: the same bits on every tp rank
                    for other in shards[1:]:
                        np.testing.assert_array_equal(shards[0], other,
                                                      err_msg=name)
                    got = shards[0]
                else:
                    got = np.concatenate(shards, axis=axis)
                np.testing.assert_allclose(got, arr, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} at dp {d} sp {s}")
