"""The PyTorch port's hand-written CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU mode).  This file imports torch and the port only,
never jax, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: layernorm — kernel and plain version compute f32 statistics and
round y to bf16 once, so y may differ by one bf16 ulp (2^-7 of the largest
|y|); the f32 statistics by summation order (1e-4).  Flash attention — the
kernel rounds the probabilities to bf16 for its P V product and both round O
to bf16: two bf16 ulps of the largest |O| (2^-6 relative); lse is f32 from
bf16 products summed in another order (1e-3).

Backward kernels.  Layernorm backward: dx is computed in f32 by both and
rounded once, one ulp of the largest |dx| in bf16 (2^-7 relative) and f32
summation order in f32 (1e-5 relative); dg is an f32 sum over the rows in
another order (1e-4 relative to the largest |dg|).  Flash backward: the
kernels round p and ds to bf16 for their products (the plain version keeps
them f32) and all three round their result to bf16: two bf16 ulps of the
largest |dq|, |dk|, |dv| (2^-6 relative).  delta = rowsum(dO * O): f32
sums of the same bf16 products in another order (1e-4 relative).
"""

import numpy as np
import pytest
import torch

from zhpe_ompi_tpu_torch.ops import flash_attention as tfa
from zhpe_ompi_tpu_torch.ops import fused_norm as tfn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8192, 1024), torch.bfloat16), ((1000, 1000), torch.bfloat16),
    ((77, 1001), torch.bfloat16), ((333, 640), torch.float32)])
def test_layernorm_kernel_matches_plain_version(cuda, shape, dtype):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(shape) * 2 + 0.5, device=cuda).to(dtype)
    g = torch.tensor(1 + 0.1 * rng.standard_normal(shape[1]), device=cuda,
                     dtype=torch.float32)
    before = tfn.ln_fwd.launches
    y, m, r = tfn.ln_fwd(x, g)
    torch.cuda.synchronize()
    assert tfn.ln_fwd.launches == before + 1
    yp, mp, rp = tfn.ln_fwd_plain(x, g)
    assert _max_err(y, yp) <= 2.0 ** -7 * float(yp.float().abs().max())
    assert _max_err(m, mp) <= 1e-4
    assert float(((r - rp) / rp).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_layernorm_wrapper_raises_on_bad_input(cuda):
    x = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        tfn.ln_fwd(x, torch.ones(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tfn.ln_fwd(x.t(), torch.ones(8, device=cuda))


# The flash kernels' edges: a long sequence, causal and not (the rings'
# mbarrier phases wrap many times), and an S that is not a multiple of the
# kernels' 128-row and 128-key blocks.
FLASH_EDGES = [((1, 4096, 2, 64), True), ((1, 4096, 2, 64), False), ((2, 192, 3, 64), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((16, 512, 16, 64), True), ((2, 300, 3, 64), False),
    ((1, 129, 2, 32), True), ((1, 200, 2, 128), True), ((3, 70, 2, 16), False),
    *FLASH_EDGES])
def test_flash_kernel_matches_plain_version(cuda, shape, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, causal)
    assert _max_err(out, out_p) <= 2.0 ** -6 * float(out_p.float().abs().max())
    assert _max_err(lse, lse_p) <= 1e-3


@pytest.mark.cuda
def test_flash_kernel_reads_strided_qkv_views(cuda):
    """q, k, v as the model makes them: views into one (B, S, 3, H) tensor."""
    qkv = torch.randn(2, 256, 3, 4 * 64, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(2, 256, 4, 64) for i in range(3))
    out, _ = tfa.flash_fwd(q, k, v, True)
    out_p, _ = tfa.flash_fwd_plain(q, k, v, True)
    assert _max_err(out, out_p) <= 2.0 ** -6 * float(out_p.float().abs().max())


@pytest.mark.cuda
def test_flash_wrapper_raises_on_bad_input(cuda):
    q = torch.zeros(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_fwd(q, q, q)


def _ln_bwd_inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(shape) * 2 + 0.5, device=device).to(dtype)
    dy = torch.tensor(rng.standard_normal(shape), device=device).to(dtype)
    g = torch.tensor(1 + 0.1 * rng.standard_normal(shape[1]), device=device,
                     dtype=torch.float32)
    _, m, r = tfn.ln_fwd_plain(x, g)
    return x, g, dy, m, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8192, 1024), torch.bfloat16), ((1000, 1000), torch.bfloat16),
    ((77, 1001), torch.bfloat16), ((333, 640), torch.float32)])
def test_layernorm_bwd_kernel_matches_plain_version(cuda, shape, dtype):
    x, g, dy, m, r = _ln_bwd_inputs(shape, dtype, cuda)
    before = tfn.ln_bwd.launches
    dx, dg = tfn.ln_bwd(x, g, dy, m, r)
    torch.cuda.synchronize()
    assert tfn.ln_bwd.launches == before + 1
    dxp, dgp = tfn.ln_bwd_plain(x, g, dy, m, r)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert dx.dtype == dtype and dg.dtype == torch.float32
    assert _max_err(dx, dxp) <= rel * float(dxp.float().abs().max())
    assert _max_err(dg, dgp) <= 1e-4 * float(dgp.abs().max())


@pytest.mark.cuda
def test_layernorm_bwd_kernel_is_deterministic(cuda):
    """dg is summed in a fixed order (no atomics): the same bits twice."""
    x, g, dy, m, r = _ln_bwd_inputs((4096, 1024), torch.bfloat16, cuda, seed=1)
    dx1, dg1 = tfn.ln_bwd(x, g, dy, m, r)
    dx2, dg2 = tfn.ln_bwd(x, g, dy, m, r)
    assert torch.equal(dg1, dg2) and torch.equal(dx1, dx2)


@pytest.mark.cuda
def test_layernorm_bwd_wrapper_raises_on_bad_input(cuda):
    x = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(64, device=cuda)
    m = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="dy must be"):
        tfn.ln_bwd(x, g, x.float(), m, m)
    with pytest.raises(ValueError, match="mean must be"):
        tfn.ln_bwd(x, g, x, m[:4], m)


def _flash_bwd_inputs(shape, causal, device, strided=False, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        b, s, h, d = shape
        qkv = torch.randn(b, s, 3, h * d, generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].reshape(shape) for i in range(3))
    else:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
    do = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    out, lse = tfa.flash_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,strided", [
    ((16, 512, 16, 64), True, False), ((2, 300, 3, 64), False, False),
    ((2, 300, 3, 64), True, False), ((1, 129, 2, 32), True, False),
    ((1, 200, 2, 128), True, False), ((3, 70, 2, 16), False, False),
    ((2, 256, 4, 64), True, True), *((sh, c, False) for sh, c in FLASH_EDGES)])
def test_flash_bwd_kernels_match_plain_version(cuda, shape, causal, strided):
    q, k, v, out, lse, do = _flash_bwd_inputs(shape, causal, cuda, strided)
    dq0, dkv0 = tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches
    got = tfa.flash_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (dq0 + 1, dkv0 + 1)
    want = tfa.flash_bwd_plain(q, k, v, out, lse, do, causal)
    for t, w in zip(got, want):
        assert t.dtype == torch.bfloat16 and t.shape == q.shape
        assert _max_err(t, w) <= 2.0 ** -6 * float(w.float().abs().max())


@pytest.mark.cuda
def test_flash_bwd_dkv_kernel_is_deterministic(cuda):
    """dk and dv are summed in a fixed order (no atomics): the same bits
    twice."""
    q, k, v, out, lse, do = _flash_bwd_inputs((4, 512, 8, 64), True, cuda, seed=3)
    _, delta = tfa.flash_bwd_dq(q, k, v, out, lse, do, True)
    dk1, dv1 = tfa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
def test_flash_bwd_dq_kernel_is_deterministic(cuda):
    """dq and delta are summed in a fixed order (no atomics): the same bits
    twice."""
    q, k, v, out, lse, do = _flash_bwd_inputs((4, 512, 8, 64), True, cuda, seed=4)
    dq1, delta1 = tfa.flash_bwd_dq(q, k, v, out, lse, do, True)
    dq2, delta2 = tfa.flash_bwd_dq(q, k, v, out, lse, do, True)
    assert torch.equal(dq1, dq2) and torch.equal(delta1, delta2)


@pytest.mark.cuda
def test_flash_bwd_dq_delta_matches_plain_rowsum(cuda):
    """delta = rowsum(dO * O) in f32, read through the tiles' swizzle, at
    every head dim and a ragged S."""
    for shape in ((1, 129, 2, 32), (3, 70, 2, 16), (1, 200, 2, 128), (2, 300, 3, 64)):
        q, k, v, out, lse, do = _flash_bwd_inputs(shape, True, cuda)
        _, delta = tfa.flash_bwd_dq(q, k, v, out, lse, do, True)
        want = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(delta.shape)
        assert _max_err(delta, want) <= 1e-4 * max(1.0, float(want.abs().max())), shape


@pytest.mark.cuda
def test_flash_bwd_wrapper_raises_on_bad_input(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError, match="lse must be"):
        tfa.flash_bwd(q, q, q, q, lse[:1], q)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_bwd(q, q, q, q.float(), lse, q)
    q48 = torch.zeros(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_bwd(q48, q48, q48, q48, lse, q48)


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels(cuda):
    """A gradient through layer_norm and flash_attention on CUDA launches
    each backward kernel once."""
    x = torch.randn(4, 128, 2 * 64, device=cuda).to(torch.bfloat16).requires_grad_()
    g = torch.ones(2 * 64, device=cuda, requires_grad=True)
    counts = (tfn.ln_bwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    h = tfn.layer_norm(x, g).reshape(4, 128, 2, 64)
    tfa.flash_attention(h, h, h).float().sum().backward()
    torch.cuda.synchronize()
    assert (tfn.ln_bwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(g.grad).all()
