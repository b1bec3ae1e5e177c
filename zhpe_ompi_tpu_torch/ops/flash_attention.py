"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions (namesake: ``zhpe_ompi_tpu/ops/flash_attention.py``).

- :func:`attn_reference` — naive attention, the single semantic baseline,
  the same body as the JAX package's (q scaled in the model dtype, f32
  softmax, weights cast back to the model dtype).
- :func:`flash_fwd` — the forward kernel's wrapper.  On a CUDA tensor it
  launches ``csrc/flash_attention.cu`` (which replaces the TPU kernel
  ``_flash_fwd_kernel``) or raises; on a CPU tensor it runs
  :func:`flash_fwd_plain`, the kernel's arithmetic in plain PyTorch.
  Returns ``(out, lse)``: out (B, S, h, hd) in q's dtype, lse (B*h, S)
  float32.
- :func:`flash_bwd` — the backward.  On CUDA tensors it launches the two
  kernels of ``csrc/flash_attention_bwd.cu`` through their wrappers
  :func:`flash_bwd_dq` (which replaces ``_flash_bwd_dq_kernel`` and also
  computes delta = rowsum(dO * O)) and :func:`flash_bwd_dkv` (which
  replaces ``_flash_bwd_dkv_kernel``), or raises; on CPU tensors it runs
  :func:`flash_bwd_plain`.  Returns ``(dq, dk, dv)``.
- :func:`flash_attention` — the dispatcher the model calls; its kernel
  path is an autograd function whose forward saves q, k, v, out and lse
  and whose backward is :func:`flash_bwd`.
- :func:`tma_map_geometry` — the dims, byte strides and box of the TMA
  tensor map through which the kernels read each operand; the wrappers
  pass it to C, which encodes the maps per call.

While a profiler records, each call of the three kernel wrappers runs in a
profiler range ``zmpi.kernel.<wrapper>``
(``_build.kernel_range``).
"""

from __future__ import annotations

import array
import ctypes

import torch

from .. import _build

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)


def attn_reference(q, k, v, causal=True):
    """Naive attention over (B, S, heads, head_dim) tensors."""
    B, S, h, hd = q.shape
    qs = q * (hd ** -0.5)
    scores = torch.einsum("bshd,bthd->bhst", qs, k).float()
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def flash_fwd_plain(q, k, v, causal=True):
    """The kernel's arithmetic in plain PyTorch, over whole rows: f32
    scores scaled by hd^-1/2, -1e30 masking, f32 softmax statistics.
    Returns ``(out, lse)`` as :func:`flash_fwd` does."""
    B, S, h, hd = q.shape
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (hd ** -0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p / l, v.float()).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B * h, S)
    return out, lse


def flash_bwd_plain(q, k, v, o, lse, do, causal=True):
    """The backward kernels' arithmetic in plain PyTorch, over whole rows
    in f32: p = exp(scale * q k^T - lse) (masked: 0), delta = rowsum(dO *
    O), ds = p (dO v^T - delta), dq = scale ds k, dk = scale ds^T q,
    dv = p^T dO.  Returns ``(dq, dk, dv)`` in the operands' dtype."""
    B, S, h, hd = q.shape
    scale = hd ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - lse.reshape(B, h, S, 1))
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, h, S)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_VP, _I32 = ctypes.c_void_p, ctypes.c_int


def _lib():
    from .. import _build

    return _build.load("flash_attention", {
        "zt_flash_fwd": (_I32, [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32,
                                _I32, _VP, _I32, ctypes.c_float, _VP]),
    })


def _bwd_lib():
    from .. import _build

    args = [_VP] * 8 + [_I32] * 4 + [_VP, _I32, ctypes.c_float, _VP]
    return _build.load("flash_attention_bwd", {
        "zt_flash_bwd_dq": (_I32, args),
        "zt_flash_bwd_dkv": (_I32, args),
    })


#: the rows of one TMA box: a 64-row tile of q, k, v, O or dO
_TMA_BOX_ROWS = 64


def tma_map_geometry(shape, strides, itemsize, base):
    """The TMA tensor map of one (B, S, h, hd) attention operand, as the
    kernels encode it: ``(dims, byte_strides, box)``, innermost first.

    dims are (hd, S, h, B); byte_strides those of S, h and B (the last axis
    is contiguous); box (min(hd, 64), 64, 1, 1), one 64-row tile of one
    swizzle atom (a row of at most 128 bytes).  ``strides`` are in elements,
    ``base`` is the data pointer.  Raises ValueError where TMA cannot read
    the tensor: a last axis that is not contiguous, a base that is not
    16-byte aligned, or a byte stride that is not a multiple of 16."""
    B, S, h, hd = shape
    sb, ss, sh, sd = strides
    if sd != 1:
        raise ValueError(f"TMA needs a contiguous last axis, got strides {tuple(strides)}")
    byte_strides = (ss * itemsize, sh * itemsize, sb * itemsize)
    if (base | byte_strides[0] | byte_strides[1] | byte_strides[2]) & 15:
        raise ValueError(
            f"TMA needs a 16-byte aligned base and byte strides that are "
            f"multiples of 16, got base {base:#x} and byte strides {byte_strides}")
    return (hd, S, h, B), byte_strides, (min(hd, 64), _TMA_BOX_ROWS, 1, 1)


def _maps(shape, *ts):
    """The geometry of each tensor's map, flattened for the C entry points
    (11 int64 a tensor: dims, byte strides, box).  Every tensor has the
    (B, S, h, hd) ``shape`` and is bf16, as ``_check_operand`` holds.  An
    ``array.array``: its address is ``buffer_info()[0]``, and it is several
    times quicker to build than a ctypes array, on a path that runs every
    call."""
    flat = []
    for t in ts:
        dims, byte_strides, box = tma_map_geometry(shape, t.stride(), 2, t.data_ptr())
        flat += dims
        flat += byte_strides
        flat += box
    return array.array("q", flat)


def _check_operand(who, name, t, shape, device):
    if t.dtype != torch.bfloat16 or t.device != device or t.shape != shape:
        raise ValueError(
            f"{who}: {name} must be bfloat16 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    # the kernels read each (row, head) as 16-byte vectors
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(
            f"{who}: {name} needs a contiguous last axis, strides that "
            f"are multiples of 8 and a 16-byte aligned start, got strides "
            f"{t.stride()}")


def _check_qkv(who, q, k, v):
    """Device, rank and head dim of q, then every operand of q's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{who}: q must be (B, S, h, hd), got {tuple(q.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{who}: head_dim {q.shape[-1]} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(who, name, t, q.shape, q.device)


def _check_rows(who, name, t, B, S, h, device):
    if (t.dtype != torch.float32 or t.shape != (B * h, S)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(
            f"{who}: {name} must be a contiguous float32 {(B * h, S)} tensor "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


@_build.kernel_range
def flash_fwd(q, k, v, causal=True):
    """Attention forward over (B, S, heads, head_dim) tensors.  CUDA
    tensors: the hand-written kernel, or an error; CPU tensors: the plain
    version.  Returns ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    _check_qkv("flash_fwd", q, k, v)
    B, S, h, hd = q.shape
    out = torch.empty((B, S, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * h, S), dtype=torch.float32, device=q.device)
    maps = _maps(q.shape, q, k, v)
    with torch.cuda.device(q.device):
        rc = _lib().zt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, h, hd, maps.buffer_info()[0],
            int(bool(causal)), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed (cudaError {rc})")
    _build.count_launch(flash_fwd)
    return out, lse


#: kernel launches since the count was last set to 0
flash_fwd.launches = 0


@_build.kernel_range
def flash_bwd_dq(q, k, v, o, lse, do, causal=True):
    """The dq kernel on CUDA tensors (or an error): ``(dq, delta)``, with
    delta = rowsum(dO * O) as (B*h, S) float32 for :func:`flash_bwd_dkv`."""
    _check_qkv("flash_bwd_dq", q, k, v)
    B, S, h, hd = q.shape
    for name, t in (("o", o), ("do", do)):
        _check_operand("flash_bwd_dq", name, t, q.shape, q.device)
    _check_rows("flash_bwd_dq", "lse", lse, B, S, h, q.device)
    dq = torch.empty((B, S, h, hd), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * h, S), dtype=torch.float32, device=q.device)
    maps = _maps(q.shape, q, k, v, o, do)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().zt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, S, h, hd, maps.buffer_info()[0], int(bool(causal)),
            hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq: kernel launch failed (cudaError {rc})")
    _build.count_launch(flash_bwd_dq)
    return dq, delta


#: kernel launches since the count was last set to 0
flash_bwd_dq.launches = 0


@_build.kernel_range
def flash_bwd_dkv(q, k, v, lse, delta, do, causal=True):
    """The dk/dv kernel on CUDA tensors (or an error): ``(dk, dv)``."""
    _check_qkv("flash_bwd_dkv", q, k, v)
    B, S, h, hd = q.shape
    _check_operand("flash_bwd_dkv", "do", do, q.shape, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_rows("flash_bwd_dkv", name, t, B, S, h, q.device)
    dk = torch.empty((B, S, h, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, h, hd), dtype=q.dtype, device=q.device)
    maps = _maps(q.shape, q, k, v, do)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().zt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, h, hd, maps.buffer_info()[0], int(bool(causal)),
            hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv: kernel launch failed (cudaError {rc})")
    _build.count_launch(flash_bwd_dkv)
    return dk, dv


#: kernel launches since the count was last set to 0
flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, causal=True):
    """Attention backward over (B, S, heads, head_dim) tensors, from the
    forward's ``o`` and ``lse`` and the upstream gradient ``do``.  CUDA
    tensors: the two hand-written kernels, dq first (it also writes delta),
    or an error; CPU tensors: the plain version.  Returns ``(dq, dk, dv)``."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal)
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, force: bool = False):
    """Fused attention over (B, S, heads, head_dim) tensors, with its
    gradient.  On CUDA: the kernels.  On the CPU: :func:`attn_reference`,
    or with ``force=True`` the kernels' plain versions (the counterpart of
    the JAX package's forced, interpreted Pallas kernels)."""
    if q.device.type == "cpu" and not force:
        return attn_reference(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal)
