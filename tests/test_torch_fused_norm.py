"""The PyTorch port's layernorm, forward and backward, against the JAX
package's.

The same numpy inputs go through ``zhpe_ompi_tpu.ops.fused_norm`` (the
Pallas kernels in interpret mode, and ``ln_reference``) and through
``zhpe_ompi_tpu_torch.ops.fused_norm`` on the CPU (the kernels' plain
versions, and ``ln_reference``).  The CUDA kernels themselves are held
against their plain versions in ``tests/test_torch_cuda_kernels.py``.

Tolerances: float32 differs only by summation order (1e-5 absolute on
outputs of order 1); bfloat16 outputs are computed in f32 by both packages
and rounded once, so they may differ by one bf16 ulp (2^-7 relative to the
largest |y| or |dx|).  The f32 statistics differ by summation order only
(1e-5).  dg is an f32 sum over the rows in another order: 1e-5 relative to
the largest |dg|.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhpe_ompi_tpu.ops import fused_norm as jfn
from zhpe_ompi_tpu_torch.ops import fused_norm as tfn

DTYPES = [
    pytest.param(jnp.float32, torch.float32, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, id="bf16"),
]


def _inputs(shape=(4, 16, 128), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, g


def _tol(jdt, y):
    if jdt == jnp.float32:
        return 1e-5
    return 2.0 ** -7 * float(np.abs(y).max())


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_reference_matches_jax_reference(jdt, tdt):
    x, g = _inputs()
    want = _np(jfn.ln_reference(jnp.asarray(x, jdt), jnp.asarray(g)))
    got = _np(tfn.ln_reference(torch.tensor(x, dtype=tdt), torch.tensor(g)))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(jdt, want))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_kernel_path_matches_pallas_interpret(jdt, tdt):
    """force=True: the port's kernel path (its plain version on the CPU)
    against the JAX package's Pallas kernel, interpreted."""
    x, g = _inputs()
    want = _np(jfn.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g),
                              block_rows=32, interpret=True, force=True))
    got = _np(tfn.layer_norm(torch.tensor(x, dtype=tdt), torch.tensor(g),
                             force=True))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(jdt, want))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_statistics_match_pallas_ln_fwd(jdt, tdt):
    x, g = _inputs((64, 128))
    jy, jm, jr = jfn._ln_fwd(jnp.asarray(x, jdt), jnp.asarray(g), 32, True)
    y, m, r = tfn.ln_fwd(torch.tensor(x, dtype=tdt), torch.tensor(g))
    assert m.shape == r.shape == (64,)
    assert m.dtype == r.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr)[:, 0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=_tol(jdt, _np(jy)))


def test_plain_version_takes_any_width():
    """The kernel takes any D (the JAX dispatcher fell back on d % 128);
    its plain version must agree with the reference there too."""
    x, g = _inputs((5, 7, 100))
    got = tfn.layer_norm(torch.tensor(x), torch.tensor(g), force=True)
    want = jfn.ln_reference(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cpu_default_is_the_reference():
    x, g = _inputs()
    xt, gt = torch.tensor(x), torch.tensor(g)
    assert torch.equal(tfn.layer_norm(xt, gt), tfn.ln_reference(xt, gt))


def _dg_tol(dg):
    return 1e-5 * float(np.abs(dg).max())


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_plain_bwd_matches_pallas_ln_bwd(jdt, tdt):
    """ln_bwd (its plain version on the CPU) against the Pallas backward
    kernel, interpreted, on the same x, g, dy and forward statistics."""
    x, g = _inputs((64, 128))
    dy = np.random.default_rng(1).standard_normal((64, 128)).astype(np.float32)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    _, jm, jr = jfn._ln_fwd(jx, jnp.asarray(g), 32, True)
    jdx, jdg = jfn._ln_bwd(jx, jnp.asarray(g), jdy, jm, jr, 32, True)
    dx, dg = tfn.ln_bwd(torch.tensor(x, dtype=tdt), torch.tensor(g),
                        torch.tensor(dy, dtype=tdt),
                        torch.tensor(np.asarray(jm)[:, 0]),
                        torch.tensor(np.asarray(jr)[:, 0]))
    assert dx.dtype == tdt and dg.dtype == torch.float32 and dg.shape == (128,)
    want_dg = np.asarray(jdg)[0]
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=0,
                               atol=_tol(jdt, _np(jdx)))
    np.testing.assert_allclose(dg.numpy(), want_dg, rtol=0, atol=_dg_tol(want_dg))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_kernel_path_gradients_match_jax_grad(jdt, tdt):
    """Autograd through the port's layer_norm(force=True) against jax.grad
    through the JAX package's forced (interpreted) Pallas path, for the
    loss sum(y * w) with a random w."""
    x, g = _inputs()
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(a, b):
        y = jfn.layer_norm(a, b, block_rows=32, interpret=True, force=True)
        return (y.astype(jnp.float32) * w).sum()

    jdx, jdg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                               jnp.asarray(g))
    xt = torch.tensor(x, dtype=tdt, requires_grad=True)
    gt = torch.tensor(g, requires_grad=True)
    (tfn.layer_norm(xt, gt, force=True).float() * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(jdx), rtol=0,
                               atol=_tol(jdt, _np(jdx)))
    want_dg = np.asarray(jdg)
    np.testing.assert_allclose(gt.grad.numpy(), want_dg, rtol=0,
                               atol=_dg_tol(want_dg))


def test_wrapper_rejects_a_device_without_kernel():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfn.ln_fwd(x, torch.empty(8, device="meta"))
    m = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfn.ln_bwd(x, torch.empty(8, device="meta"), x, m, m)

