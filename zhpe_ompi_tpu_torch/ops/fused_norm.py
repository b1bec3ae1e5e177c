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
- The RMS form (the port's addition; the JAX package has no RMSNorm):
  :func:`rms_reference`, the wrappers :func:`rms_fwd` and :func:`rms_bwd`
  (``zt_rms_fwd`` and ``zt_rms_bwd``: the same kernels with their RMS flag
  set, so the trace names them ``ln_fwd_*`` and ``ln_bwd_*`` too) with
  their plain versions, and the dispatcher :func:`rms_norm`.

While a profiler records, each wrapper call runs in a profiler range
``zmpi.kernel.<wrapper>`` (``_build.kernel_range``).
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


def rms_reference(x, g):
    """RMSNorm: f32 mean square and normalize, cast back to the input
    dtype."""
    dt = x.dtype
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + _EPS) * g).to(dt)


def rms_fwd_plain(x2, g):
    """The RMS kernel's arithmetic in plain PyTorch: f32 over each row of
    ``x2`` (N, D).  Returns ``(y, rstd)``."""
    xf = x2.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + _EPS)
    return (xf * r * g.float()).to(x2.dtype), r.squeeze(-1)


def rms_bwd_plain(x2, g, dy2, rstd):
    """The RMS backward kernel's arithmetic in plain PyTorch, f32 inside:
    x^ = x r, dx^ = dy g, dx = r (dx^ - x^ mean(dx^ x^)), dg = sum over rows
    of dy x^.  Returns ``(dx, dg)``."""
    xf, dyf = x2.float(), dy2.float()
    r = rstd[:, None]
    xhat = xf * r
    dxhat = dyf * g.float()
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x2.dtype), (dyf * xhat).sum(0)


def _lib():
    from .. import _build

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = (i32, [vp, vp, vp, vp, vp, i64, i32, i32, ctypes.c_float, vp])
    partials = (i64, [vp, vp, vp, vp, i64, i32, i32])
    bwd = (i32, [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp])
    return _build.load("fused_norm", {
        "zt_ln_fwd": fwd, "zt_ln_bwd_partials": partials, "zt_ln_bwd": bwd,
        "zt_rms_fwd": fwd, "zt_rms_bwd_partials": partials, "zt_rms_bwd": bwd,
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


def _fwd(who, rms, x2, g):
    """Launch the forward kernel (``zt_rms_fwd`` with ``rms``, else
    ``zt_ln_fwd``) on CUDA rows ``x2``: ``(y, mean, rstd)``, mean None with
    ``rms``."""
    if x2.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x2.device}")
    _check_rows(who, x2, g)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = None if rms else torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        lib = _lib()
        entry = lib.zt_rms_fwd if rms else lib.zt_ln_fwd
        rc = entry(x2.data_ptr(), g.data_ptr(), y.data_ptr(),
                   None if rms else mean.data_ptr(), rstd.data_ptr(), n, d,
                   _DTYPE_CODES[x2.dtype], _EPS,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {rc})")
    return y, mean, rstd


@_build.kernel_range
def ln_fwd(x2, g):
    """Layernorm of each row of ``x2`` (N, D) with float32 gain ``g`` (D,).
    CUDA tensor: the hand-written kernel, or an error; CPU tensor: the
    plain version."""
    if x2.device.type == "cpu":
        return ln_fwd_plain(x2, g)
    out = _fwd("ln_fwd", False, x2, g)
    _build.count_launch(ln_fwd)
    return out


#: kernel launches since the count was last set to 0
ln_fwd.launches = 0


@_build.kernel_range
def rms_fwd(x2, g):
    """RMSNorm of each row of ``x2`` (N, D) with float32 gain ``g`` (D,):
    ``(y, rstd)``.  CUDA tensor: the kernel with its RMS flag, or an
    error; CPU tensor: :func:`rms_fwd_plain`."""
    if x2.device.type == "cpu":
        return rms_fwd_plain(x2, g)
    y, _, rstd = _fwd("rms_fwd", True, x2, g)
    _build.count_launch(rms_fwd)
    return y, rstd


#: kernel launches since the count was last set to 0
rms_fwd.launches = 0


def _bwd(who, rms, x2, g, dy2, mean, rstd):
    """Launch the backward kernel (``zt_rms_bwd`` with ``rms``, which reads
    no mean, else ``zt_ln_bwd``) on CUDA tensors: ``(dx, dg)``."""
    if x2.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x2.device}")
    _check_rows(who, x2, g)
    n, d = x2.shape
    if (dy2.shape != x2.shape or dy2.dtype != x2.dtype
            or dy2.device != x2.device or not dy2.is_contiguous()):
        raise ValueError(
            f"{who}: dy must be a contiguous {x2.dtype} {tuple(x2.shape)} "
            f"tensor on {x2.device}, got {dy2.dtype} {tuple(dy2.shape)} on "
            f"{dy2.device}")
    stats = (("rstd", rstd),) if rms else (("mean", mean), ("rstd", rstd))
    for name, t in stats:
        if (t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous() or t.device != x2.device):
            raise ValueError(
                f"{who}: {name} must be a contiguous float32 ({n},) tensor "
                f"on {x2.device}, got {t.dtype} {tuple(t.shape)}")
    dx = torch.empty_like(x2)
    dg = torch.empty(d, dtype=torch.float32, device=x2.device)
    code = _DTYPE_CODES[x2.dtype]
    with torch.cuda.device(x2.device):
        lib = _lib()
        partials = lib.zt_rms_bwd_partials if rms else lib.zt_ln_bwd_partials
        entry = lib.zt_rms_bwd if rms else lib.zt_ln_bwd
        rows = partials(x2.data_ptr(), g.data_ptr(), dy2.data_ptr(),
                        dx.data_ptr(), n, d, code)
        if rows < 1:
            raise ValueError(f"{who}: the kernel does not take shape {(n, d)}")
        partial = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
        rc = entry(
            x2.data_ptr(), g.data_ptr(), dy2.data_ptr(),
            None if rms else mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), partial.data_ptr(), rows, n, d, code,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {rc})")
    return dx, dg


@_build.kernel_range
def ln_bwd(x2, g, dy2, mean, rstd):
    """Layernorm backward of rows ``x2`` (N, D) with float32 gain ``g``
    (D,), upstream gradient ``dy2`` (N, D) and the forward's (N,) float32
    ``mean`` and ``rstd``.  CUDA tensors: the hand-written kernel (one
    cooperative launch that also folds dg), or an error; CPU tensors: the
    plain version.  Returns ``(dx, dg)``."""
    if x2.device.type == "cpu":
        return ln_bwd_plain(x2, g, dy2, mean, rstd)
    out = _bwd("ln_bwd", False, x2, g, dy2, mean, rstd)
    _build.count_launch(ln_bwd)
    return out


#: kernel launches since the count was last set to 0
ln_bwd.launches = 0


@_build.kernel_range
def rms_bwd(x2, g, dy2, rstd):
    """RMSNorm backward of rows ``x2`` (N, D) with float32 gain ``g``,
    upstream gradient ``dy2`` and the forward's (N,) float32 ``rstd``:
    ``(dx, dg)``.  CUDA tensors: the backward kernel with its RMS flag, or
    an error; CPU tensors: :func:`rms_bwd_plain`."""
    if x2.device.type == "cpu":
        return rms_bwd_plain(x2, g, dy2, rstd)
    out = _bwd("rms_bwd", True, x2, g, dy2, None, rstd)
    _build.count_launch(rms_bwd)
    return out


#: kernel launches since the count was last set to 0
rms_bwd.launches = 0


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


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, g):
        y, rstd = rms_fwd(x2, g)
        ctx.save_for_backward(x2, g, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, g, rstd = ctx.saved_tensors
        dx, dg = rms_bwd(x2, g, dy.contiguous(), rstd)
        return dx, dg.reshape(g.shape).to(g.dtype)


def rms_norm(x, g, force: bool = False):
    """RMSNorm with gain over the last axis, dispatched as
    :func:`layer_norm` is: the kernels on CUDA; on the CPU
    :func:`rms_reference`, or with ``force=True`` the kernels' plain
    versions."""
    if x.device.type == "cpu" and not force:
        return rms_reference(x, g)
    d = x.shape[-1]
    y = _RMSNorm.apply(x.reshape(-1, d).contiguous(),
                       g.to(torch.float32).contiguous())
    return y.reshape(x.shape)
