"""The PyTorch port's flash attention, forward and backward, against the
JAX package's.

The same numpy q, k, v (and dO) go through
``zhpe_ompi_tpu.ops.flash_attention`` (``_flash_fwd`` and ``_flash_bwd`` in
Pallas interpret mode, and ``attn_reference``) and through
``zhpe_ompi_tpu_torch.ops.flash_attention`` on the CPU (the kernels' plain
versions behind ``flash_fwd`` and ``flash_bwd``, and ``attn_reference``).
The CUDA kernels are held against their plain versions in
``tests/test_torch_cuda_kernels.py``.

Tolerances: float32 differs by summation order only (1e-5 on outputs of
order 1 and on lse).  In bfloat16 both the Pallas kernel and the port's
plain version upcast to f32 and round the output once, so outputs may
differ by one bf16 ulp (1e-2 on |out| < 1); lse stays f32 (1e-4).  The two
``attn_reference`` bodies round scores and weights to bf16 at the same
places but in different libraries, so their bf16 bound is looser (3e-2).
Gradients: float32 by summation order only (1e-5 on gradients of order 1;
the JAX kernels scale f32 q before Q K^T, the port scales the scores after
it); bfloat16 gradients are computed in f32 by both and rounded once, one
bf16 ulp of the largest |gradient| (2^-7 relative).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhpe_ompi_tpu.ops import flash_attention as jfa
from zhpe_ompi_tpu_torch.ops import flash_attention as tfa

DTYPES = [
    pytest.param(jnp.float32, torch.float32, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, id="bf16"),
]
CAUSAL = [pytest.param(True, id="causal"), pytest.param(False, id="full")]


def _qkv(shape=(2, 64, 4, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_plain_fwd_matches_pallas_interpret(jdt, tdt, causal):
    q, k, v = _qkv()
    B, S, h, hd = q.shape
    jout, jlse = jfa._flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                causal, 32, 32, interpret=True)
    out, lse = tfa.flash_fwd(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                             causal)
    assert out.shape == (B, S, h, hd) and out.dtype == tdt
    assert lse.shape == (B * h, S) and lse.dtype == torch.float32
    out_tol, lse_tol = (1e-5, 1e-5) if jdt == jnp.float32 else (1e-2, 1e-4)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=0, atol=out_tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=0, atol=lse_tol)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_reference_matches_jax_reference(jdt, tdt, causal):
    q, k, v = _qkv()
    want = jfa.attn_reference(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal)
    got = tfa.attn_reference(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                             causal)
    tol = 1e-5 if jdt == jnp.float32 else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("causal", CAUSAL)
def test_plain_fwd_masks_ragged_sequence(causal):
    """S = 50 divides no block: the JAX wrapper falls back to the reference
    there, the port's kernel masks its own edge; both must agree."""
    q, k, v = _qkv((1, 50, 2, 16), seed=3)
    want = jfa.attn_reference(*(jnp.asarray(a) for a in (q, k, v)), causal)
    out, _ = tfa.flash_fwd(*(torch.tensor(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_force_selects_the_kernel_path_on_cpu():
    q, k, v = (torch.tensor(a) for a in _qkv())
    forced = tfa.flash_attention(q, k, v, causal=True, force=True)
    assert torch.equal(forced, tfa.flash_fwd(q, k, v, True)[0])
    assert torch.equal(tfa.flash_attention(q, k, v, causal=True),
                       tfa.attn_reference(q, k, v, True))


def _grad_tol(jdt, want):
    return 1e-5 if jdt == jnp.float32 else 2.0 ** -7 * float(np.abs(want).max())


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_plain_bwd_matches_pallas_interpret(jdt, tdt, causal):
    """flash_bwd (its plain version on the CPU) against the Pallas dq and
    dk/dv kernels, interpreted, from the same forward o and lse."""
    q, k, v = _qkv()
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal, 32, 32, interpret=True)
    want = jfa._flash_bwd(jq, jk, jv, jout, jlse, jdo, causal, 32, 32,
                          interpret=True)
    got = tfa.flash_bwd(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                        torch.tensor(np.asarray(jout, np.float32), dtype=tdt),
                        torch.tensor(np.asarray(jlse)[..., 0]),
                        torch.tensor(do, dtype=tdt), causal)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == tdt and tuple(t.shape) == q.shape
        np.testing.assert_allclose(_np(t), _np(w), rtol=0,
                                   atol=_grad_tol(jdt, _np(w)), err_msg=name)


@pytest.mark.parametrize("causal", CAUSAL)
def test_kernel_path_gradients_mask_ragged_sequence(causal):
    """S = 50: autograd through the port's forced kernel path (plain
    versions) against jax.grad of attn_reference, for the loss
    sum(out * w)."""
    q, k, v = _qkv((1, 50, 2, 16), seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda a, b, c: (jfa.attn_reference(a, b, c, causal) * w).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (tfa.flash_attention(*ts, causal=causal, force=True)
     * torch.tensor(w)).sum().backward()
    for name, t, g in zip(("dq", "dk", "dv"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_backward_wrappers_reject_a_device_without_kernel():
    q = torch.empty((1, 64, 2, 32), device="meta")
    lse = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_bwd_dkv(q, q, q, lse, lse, q)


def test_tma_geometry_of_a_contiguous_operand():
    B, S, h, hd = 2, 300, 3, 64
    t = torch.zeros((B, S, h, hd), dtype=torch.bfloat16)
    dims, strides, box = tfa.tma_map_geometry(t.shape, t.stride(), 2, t.data_ptr())
    assert dims == (hd, S, h, B)
    assert strides == (h * hd * 2, hd * 2, S * h * hd * 2)
    assert box == (64, 64, 1, 1)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_tma_geometry_of_fused_qkv_views(hd):
    """q, k, v as the model makes them, views into one (B, S, 3, H)
    tensor: the same byte strides, bases H * 2 bytes apart, a box of one
    swizzle atom (at most 64 bf16 columns, 128 bytes)."""
    B, S, h = 2, 192, 4
    H = h * hd
    qkv = torch.zeros((B, S, 3, H), dtype=torch.bfloat16)
    views = [qkv[:, :, i].reshape(B, S, h, hd) for i in range(3)]
    geoms = [tfa.tma_map_geometry(t.shape, t.stride(), t.element_size(), t.data_ptr())
             for t in views]
    for dims, strides, box in geoms:
        assert dims == (hd, S, h, B)
        assert strides == (3 * H * 2, hd * 2, S * 3 * H * 2)
        assert box == (min(hd, 64), 64, 1, 1)
    bases = [t.data_ptr() - qkv.data_ptr() for t in views]
    assert bases == [0, H * 2, 2 * H * 2]
    flat = list(tfa._maps(views[0].shape, *views))
    assert len(flat) == 3 * 11 and flat[:11] == flat[11:22] == flat[22:]


def test_tma_geometry_enforces_the_16_byte_rules():
    shape = (1, 64, 2, 64)
    good = (64 * 2 * 64, 2 * 64, 64, 1)
    assert tfa.tma_map_geometry(shape, good, 2, 4096)[1] == (256, 128, 16384)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tfa.tma_map_geometry(shape, good, 2, 4096 + 8)
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.tma_map_geometry(shape, (64 * 2 * 68, 2 * 68, 68, 1), 2, 4096)
    with pytest.raises(ValueError, match="contiguous last axis"):
        tfa.tma_map_geometry(shape, (8192, 128, 1, 2), 2, 4096)


def test_dq_maps_of_fused_qkv_views_and_contiguous_o_do():
    """flash_bwd_dq's five maps: q, k, v as views into one (B, S, 3, H)
    tensor, O and dO contiguous.  5 x 11 entries, the same dims and box,
    O's and dO's own strides."""
    B, S, h, hd = 2, 70, 4, 64
    H = h * hd
    qkv = torch.zeros((B, S, 3, H), dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B, S, h, hd) for i in range(3))
    o, do = (torch.zeros((B, S, h, hd), dtype=torch.bfloat16) for _ in range(2))
    flat = list(tfa._maps(q.shape, q, k, v, o, do))
    assert len(flat) == 5 * 11
    maps = [flat[11 * i:11 * (i + 1)] for i in range(5)]
    for m in maps:
        assert m[:4] == [hd, S, h, B] and m[7:] == [64, 64, 1, 1]
    for m in maps[:3]:
        assert m[4:7] == [3 * H * 2, hd * 2, S * 3 * H * 2]
    for m in maps[3:]:
        assert m[4:7] == [H * 2, hd * 2, S * H * 2]


@pytest.mark.parametrize("which", ["o", "do"])
def test_dq_maps_refuse_a_misaligned_o_or_do(which):
    """An O or dO view whose rows are not 16-byte aligned is refused with
    ValueError by the pure helper, before any launch."""
    B, S, h, hd = 1, 64, 2, 32
    q, k, v, o, do = (torch.zeros((B, S, h, hd), dtype=torch.bfloat16)
                      for _ in range(5))
    # a view 4 elements (8 bytes) into a wider buffer: base off by 8 bytes
    wide = torch.zeros((B, S, h, hd + 4), dtype=torch.bfloat16)
    bad = wide[..., 4:]
    ts = {"o": o, "do": do}
    ts[which] = bad
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tfa._maps(q.shape, q, k, v, ts["o"], ts["do"])
