"""Layernorm forward and backward: hand-written CUDA kernels and their
plain versions (namesake: ``zhpe_ompi_tpu/ops/fused_norm.py``).

- :func:`ln_reference` — the single semantic baseline, the same body as the
  JAX package's: f32 statistics and normalize, cast back to the input dtype.
- :func:`ln_fwd` — the forward kernel's wrapper.  On a CUDA tensor it
  launches ``zt_ln_fwd`` of ``csrc/fused_norm.cu`` (which replaces the TPU
  kernel ``_ln_fwd_kernel``) or raises; on a CPU tensor it runs
  :func:`ln_fwd_plain`, the kernel's arithmetic in plain PyTorch.  Returns
  ``(y, mean, rstd)``, the statistics as ``(N,)`` float32.
- :func:`ln_bwd` — the backward kernel's wrapper, the same way: ``zt_ln_bwd``
  (which replaces ``_ln_bwd_kernel``) or :func:`ln_bwd_plain`.  Returns
  ``(dx, dg)``, dg as ``(D,)`` float32.
- :func:`layer_norm` — the dispatcher the model calls; its kernel path is
  an autograd function whose forward saves the statistics and whose
  backward is :func:`ln_bwd`.

While a profiler records, each wrapper call runs in a profiler range
``zmpi.kernel.ln_fwd`` or ``zmpi.kernel.ln_bwd``
(``_build.kernel_range``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ln_reference(x, g):
    """f32 statistics and normalize, cast back to the input dtype."""
    dt = x.dtype
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - m) * torch.rsqrt(v + _EPS) * g).to(dt)


def ln_fwd_plain(x2, g):
    """The kernel's arithmetic in plain PyTorch: two passes in f32 over
    each row of ``x2`` (N, D).  Returns ``(y, mean, rstd)``."""
    xf = x2.float()
    m = xf.mean(-1, keepdim=True)
    c = xf - m
    r = torch.rsqrt((c * c).mean(-1, keepdim=True) + _EPS)
    y = (c * r * g.float()).to(x2.dtype)
    return y, m.squeeze(-1), r.squeeze(-1)


def ln_bwd_plain(x2, g, dy2, mean, rstd):
    """The backward kernel's arithmetic in plain PyTorch, f32 inside:
    x^ = (x - m) r, dx^ = dy g, dx = r (dx^ - mean(dx^) - x^ mean(dx^ x^)),
    dg = sum over rows of dy x^.  Returns ``(dx, dg)``."""
    xf, dyf = x2.float(), dy2.float()
    r = rstd[:, None]
    xhat = (xf - mean[:, None]) * r
    dxhat = dyf * g.float()
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x2.dtype), (dyf * xhat).sum(0)


def _lib():
    from .. import _build

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.load("fused_norm", {
        "zt_ln_fwd": (i32, [vp, vp, vp, vp, vp, i64, i32, i32,
                            ctypes.c_float, vp]),
        "zt_ln_bwd_partials": (i64, [vp, vp, vp, vp, i64, i32, i32]),
        "zt_ln_bwd": (i32, [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32,
                            i32, vp]),
    })


def _check_rows(who, x2, g):
    """The kernels take a contiguous (N, D) x in float32 or bfloat16 and a
    contiguous float32 (D,) g on the same device."""
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(
            f"{who}: x must be a contiguous (N, D) tensor, got shape "
            f"{tuple(x2.shape)} strides {x2.stride()}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"{who}: unsupported dtype {x2.dtype}")
    d = x2.shape[1]
    if (g.dtype != torch.float32 or g.shape != (d,) or not g.is_contiguous()
            or g.device != x2.device):
        raise ValueError(
            f"{who}: g must be a contiguous float32 ({d},) tensor on "
            f"{x2.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")


@_build.kernel_range
def ln_fwd(x2, g):
    """Layernorm of each row of ``x2`` (N, D) with float32 gain ``g`` (D,).
    CUDA tensor: the hand-written kernel, or an error; CPU tensor: the
    plain version."""
    if x2.device.type == "cpu":
        return ln_fwd_plain(x2, g)
    if x2.device.type != "cuda":
        raise ValueError(f"ln_fwd: no kernel for device {x2.device}")
    _check_rows("ln_fwd", x2, g)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        rc = _lib().zt_ln_fwd(
            x2.data_ptr(), g.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), n, d, _DTYPE_CODES[x2.dtype], _EPS,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_fwd: kernel launch failed (cudaError {rc})")
    _build.count_launch(ln_fwd)
    return y, mean, rstd


#: kernel launches since the count was last set to 0
ln_fwd.launches = 0


@_build.kernel_range
def ln_bwd(x2, g, dy2, mean, rstd):
    """Layernorm backward of rows ``x2`` (N, D) with float32 gain ``g``
    (D,), upstream gradient ``dy2`` (N, D) and the forward's (N,) float32
    ``mean`` and ``rstd``.  CUDA tensors: the hand-written kernel (one
    cooperative launch that also folds dg), or an error; CPU tensors: the
    plain version.  Returns ``(dx, dg)``."""
    if x2.device.type == "cpu":
        return ln_bwd_plain(x2, g, dy2, mean, rstd)
    if x2.device.type != "cuda":
        raise ValueError(f"ln_bwd: no kernel for device {x2.device}")
    _check_rows("ln_bwd", x2, g)
    n, d = x2.shape
    if (dy2.shape != x2.shape or dy2.dtype != x2.dtype
            or dy2.device != x2.device or not dy2.is_contiguous()):
        raise ValueError(
            f"ln_bwd: dy must be a contiguous {x2.dtype} {tuple(x2.shape)} "
            f"tensor on {x2.device}, got {dy2.dtype} {tuple(dy2.shape)} on "
            f"{dy2.device}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous() or t.device != x2.device):
            raise ValueError(
                f"ln_bwd: {name} must be a contiguous float32 ({n},) tensor "
                f"on {x2.device}, got {t.dtype} {tuple(t.shape)}")
    dx = torch.empty_like(x2)
    dg = torch.empty(d, dtype=torch.float32, device=x2.device)
    code = _DTYPE_CODES[x2.dtype]
    with torch.cuda.device(x2.device):
        lib = _lib()
        rows = lib.zt_ln_bwd_partials(x2.data_ptr(), g.data_ptr(),
                                      dy2.data_ptr(), dx.data_ptr(), n, d, code)
        if rows < 1:
            raise ValueError(f"ln_bwd: the kernel does not take shape {(n, d)}")
        partial = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
        rc = lib.zt_ln_bwd(
            x2.data_ptr(), g.data_ptr(), dy2.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dg.data_ptr(), partial.data_ptr(),
            rows, n, d, code, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_bwd: kernel launch failed (cudaError {rc})")
    _build.count_launch(ln_bwd)
    return dx, dg


#: kernel launches since the count was last set to 0
ln_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, g):
        y, mean, rstd = ln_fwd(x2, g)
        ctx.save_for_backward(x2, g, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, g, mean, rstd = ctx.saved_tensors
        dx, dg = ln_bwd(x2, g, dy.contiguous(), mean, rstd)
        return dx, dg.reshape(g.shape).to(g.dtype)


def layer_norm(x, g, force: bool = False):
    """Layernorm with gain over the last axis.  On CUDA: the kernels
    (forward, and backward under autograd).  On
    the CPU: :func:`ln_reference`, or with ``force=True`` the kernel's
    plain version, which also runs the kernel path's statistics (the
    counterpart of the JAX package's forced, interpreted Pallas kernel)."""
    if x.device.type == "cpu" and not force:
        return ln_reference(x, g)
    d = x.shape[-1]
    y = _LayerNorm.apply(x.reshape(-1, d).contiguous(),
                         g.to(torch.float32).contiguous())
    return y.reshape(x.shape)
