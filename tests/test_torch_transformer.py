"""The PyTorch port's flagship transformer forward against the JAX package's.

Parameters come from ``zhpe_ompi_tpu.models.transformer.init_params`` (as
numpy), go through ``params_from_numpy``, and the port's ``forward`` and
``loss_fn`` (with and without ``ce_chunk``) are held against the JAX
ones on the same tokens, at a small config: vocab 256, d_model 128, 4
heads, d_ff 256, 2 layers, seq 64.  d_model % 128 == 0, so the JAX Pallas
layernorm engages under ``fused_ln=True``.

Paths compared: the kernel path (JAX ``flash=True, fused_ln=True`` with
the Pallas kernels interpreted; the port's kernels' plain versions), the
reference path (``False``) and the default (``None``: references on the
CPU in both).  A tp=2 forward on two gloo processes, through
``Communicator`` -> ``comm_select`` -> ``coll/nccl`` and ``g_allreduce``,
equals the JAX single-device forward.

Tolerances: float32 runs differ by summation order only (1e-5 on logits
of order 1 and on the loss).  bfloat16 activations round at other places
in the two libraries across two layers, so logits get 3e-2 and the loss
(a mean over 128 tokens) 2e-3.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu_torch.models import transformer as tt

from _torch_dist_worker import run_ranks

SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=64)
BATCH = 2
PATHS = [pytest.param(True, id="kernel"), pytest.param(False, id="reference"),
         pytest.param(None, id="default")]
DTYPES = [pytest.param(jnp.float32, torch.float32, id="f32"),
          pytest.param(jnp.bfloat16, torch.bfloat16, id="bf16")]


def _setup(jdt, tdt, path, ce_chunk=None):
    jcfg = jt.Config(**SMALL, dtype=jdt, flash=path, fused_ln=path,
                     ce_chunk=ce_chunk)
    tcfg = tt.Config(**SMALL, dtype=tdt, flash=path, fused_ln=path,
                     ce_chunk=ce_chunk)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    targets = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    return jcfg, tcfg, params, np_params, tokens, targets


def _tols(jdt):
    return (1e-5, 1e-5) if jdt == jnp.float32 else (3e-2, 2e-3)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_forward_and_loss_match_jax(jdt, tdt, path):
    jcfg, tcfg, params, np_params, tokens, targets = _setup(jdt, tdt, path)
    tparams = tt.params_from_numpy(np_params, tcfg, device="cpu")
    logit_tol, loss_tol = _tols(jdt)
    want = np.asarray(jt.forward(params, jnp.asarray(tokens), jcfg))
    got = tt.forward(tparams, tokens, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=logit_tol)
    jloss = float(jt.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets), jcfg))
    tloss = float(tt.loss_fn(tparams, tokens, targets, tcfg))
    assert abs(tloss - jloss) <= loss_tol


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_chunked_loss_matches_jax(jdt, tdt):
    jcfg, tcfg, params, np_params, tokens, targets = _setup(
        jdt, tdt, False, ce_chunk=64)
    tparams = tt.params_from_numpy(np_params, tcfg, device="cpu")
    jloss = float(jt.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets), jcfg))
    tloss = float(tt.loss_fn(tparams, tokens, targets, tcfg))
    assert abs(tloss - jloss) <= _tols(jdt)[1]


def test_chunked_and_unchunked_loss_agree_in_the_port():
    _, tcfg, _, np_params, tokens, targets = _setup(
        jnp.float32, torch.float32, False)
    tparams = tt.params_from_numpy(np_params, tcfg, device="cpu")
    from dataclasses import replace

    whole = float(tt.loss_fn(tparams, tokens, targets, tcfg))
    chunked = float(tt.loss_fn(tparams, tokens, targets,
                               replace(tcfg, ce_chunk=32)))
    assert abs(whole - chunked) <= 1e-5


def test_params_from_numpy_keeps_layout_and_slices_tp_shards():
    _, tcfg, _, np_params, _, _ = _setup(jnp.float32, torch.float32, None)
    full = tt.params_from_numpy(np_params, tcfg, device="cpu")
    for name, arr in np_params.items():
        assert tuple(full[name].shape) == arr.shape
        assert full[name].dtype == torch.float32
    shard = tt.params_from_numpy(np_params, tcfg, device="cpu", tp_rank=1, tp=2)
    np.testing.assert_array_equal(shard["wqkv"].numpy(), np_params["wqkv"][..., 64:])
    np.testing.assert_array_equal(shard["wo"].numpy(), np_params["wo"][:, 64:])
    np.testing.assert_array_equal(shard["w1"].numpy(), np_params["w1"][..., 128:])
    np.testing.assert_array_equal(shard["w2"].numpy(), np_params["w2"][:, 128:])
    np.testing.assert_array_equal(shard["embed"].numpy(), np_params["embed"])


CE_CASES = [pytest.param(64, jnp.float32, torch.float32, id="chunked-f32"),
            pytest.param(64, jnp.bfloat16, torch.bfloat16, id="chunked-bf16"),
            pytest.param(None, jnp.float32, torch.float32, id="unchunked-f32")]


@pytest.mark.parametrize("chunk,jdt,tdt", CE_CASES)
def test_ce_gradients_match_jax_grad(chunk, jdt, tdt):
    """Gradients of token_ce w.r.t. the hidden states and the embedding
    (the chunked custom backward, or autograd through the reference)
    against jax.grad of the JAX package's token_ce on the same inputs.
    f32: summation order only (1e-6 on gradients of order 1e-2 at most).
    bf16: both packages compute the chunked backward in f32 and round dx
    and demb once, one bf16 ulp of the largest gradient (2^-7 relative)."""
    from zhpe_ompi_tpu.ops import fused_ce as jce
    from zhpe_ompi_tpu_torch.ops import fused_ce as tce

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((256, 32))).astype(np.float32)
    targets = rng.integers(0, 256, (2, 16))
    jdx, jdemb = jax.grad(
        lambda a, b: jce.token_ce(a, b, jnp.asarray(targets), chunk),
        argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(emb, jdt))
    xt = torch.tensor(x, dtype=tdt, requires_grad=True)
    et = torch.tensor(emb, dtype=tdt, requires_grad=True)
    tce.token_ce(xt, et, torch.tensor(targets), chunk).backward()
    for got, want in ((xt.grad, jdx), (et.grad, jdemb)):
        want = np.asarray(want, np.float32)
        assert got.dtype == tdt
        tol = 1e-6 if jdt == jnp.float32 else 2.0 ** -7 * float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_tp2_forward_over_gloo_equals_single_device_jax(tmp_path):
    jcfg, _, params, np_params, tokens, targets = _setup(
        jnp.float32, torch.float32, True)
    want = np.asarray(jt.forward(params, jnp.asarray(tokens), jcfg))
    jloss = float(jt.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets), jcfg))
    np.savez(tmp_path / "inputs.npz", tokens=tokens, targets=targets,
             **{f"p_{k}": v for k, v in np_params.items()}, **SMALL)
    results, outs = run_ranks("transformer", 2, tmp_path)
    for rc, log in results:
        assert rc == 0, log
    for o in outs:
        # f32 summation order only, but in a coarser split than the tp=1
        # case: the tp allreduce adds two 64-term partial products where
        # JAX takes one 128-term dot, and each following layernorm scales
        # that rounding by its rstd (the residual stream starts from
        # 0.02-scale embeddings, so rstd is large): 3e-5 on logits of
        # order 0.2
        np.testing.assert_allclose(o["logits"], want, rtol=0, atol=3e-5)
        assert abs(float(o["loss"]) - jloss) <= 1e-5
