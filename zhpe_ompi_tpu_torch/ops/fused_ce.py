"""Chunked cross-entropy, forward and backward (namesake:
``zhpe_ompi_tpu/ops/fused_ce.py``).

The mean token cross-entropy ``lse(logits) - logits[target]`` without the
full (B, S, V) f32 logits: a loop over vocabulary chunks runs the online
logsumexp recurrence, so only one (B, S, chunk) block of logits exists at
a time.  The backward re-runs the chunk loop with the saved lse: p =
exp(logits - lse), dx += p emb_c and demb_c = p^T x per chunk, then the
target-logit terms.  The JAX package writes this in plain ``lax`` (no
Pallas kernel), so the port writes it in plain PyTorch: the products are
matrix products.

Precision follows the JAX package's ``preferred_element_type=float32``:
products of model-dtype operands, accumulated and returned in f32.  On
CUDA, a bf16/fp16 product is one ``torch.mm(..., out_dtype=float32)``
(the tensor cores, f32 accumulation, no bf16 rounding of the result).
Elsewhere both operands are upcast to f32 first: bf16 values are exact in
f32, so it is the same arithmetic up to summation order.  A float32 model
on a GPU needs ``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's
default) to keep full f32 precision.

The backward's two products take the JAX package's f32 operands (p and
the upcast x or emb chunk).  On CUDA with a bf16/fp16 model, p is rounded
to the model dtype and the product is ``torch.mm(..., out_dtype=float32)``,
as for the logits: the TPU's default precision for an f32 product is one
bf16 pass, and a full-f32 product on the card is the SIMT path.  Elsewhere
both operands are f32.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _mm_f32(a, b):
    """f32 ``a @ b`` of 2-D operands: one tensor-core product with an f32
    result for bf16/fp16 operands on CUDA, both operands upcast to f32
    otherwise."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(x, emb):
    """f32 (B, S, V) logits of model-dtype x (B, S, D) and emb (V, D)."""
    out = _mm_f32(x.reshape(-1, x.shape[-1]), emb.t())
    return out.reshape(*x.shape[:-1], emb.shape[0])


def _target_logits(x, emb, targets):
    return (x.float() * emb[targets].float()).sum(-1)


def ce_reference(x, emb, targets):
    """Unchunked loss — the single semantic baseline: mean over tokens of
    lse(logits) - logits[target]."""
    lse = torch.logsumexp(_logits(x, emb), dim=-1)
    return (lse - _target_logits(x, emb, targets)).mean()


def _online_lse(x, emb, chunk: int):
    """The online logsumexp recurrence over vocab chunks; returns the f32
    (B, S) lse."""
    B, S, _ = x.shape
    m = torch.full((B, S), _NEG, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for emb_c in emb.split(chunk):
        logits = _logits(x, emb_c)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log(s)


def _ce_bwd(x, emb, targets, lse, chunk: int, g):
    """Gradients of the mean loss w.r.t. x (B, S, D) and emb (V, D), from
    the saved f32 (B, S) lse; the upstream gradient ``g`` is a scalar."""
    B, S, D = x.shape
    gt = g.float() / (B * S)  # d mean
    x2 = x.reshape(-1, D)
    lse2 = lse.reshape(-1, 1)
    dx = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
    demb = torch.empty(emb.shape, dtype=torch.float32, device=x.device)
    for c, emb_c in enumerate(emb.split(chunk)):
        p = torch.exp(_logits(x2, emb_c) - lse2)  # softmax rows of the chunk
        if p.is_cuda:  # the products' operand precision: module docstring
            p = p.to(x.dtype)
        dx += _mm_f32(p, emb_c)
        demb[c * chunk:(c + 1) * chunk] = _mm_f32(p.t(), x2)
    # target-logit term: d(-logits[t])/dx = -emb[t]; /demb = scatter -x
    t = targets.reshape(-1)
    dx = (dx - emb[t].float()) * gt
    demb = demb * gt - torch.zeros_like(demb).index_add_(0, t, gt * x2.float())
    return dx.reshape(B, S, D).to(x.dtype), demb.to(emb.dtype)


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, targets, chunk):
        lse = _online_lse(x, emb, chunk)
        ctx.save_for_backward(x, emb, targets, lse)
        ctx.chunk = chunk
        return (lse - _target_logits(x, emb, targets)).mean()

    @staticmethod
    def backward(ctx, g):
        x, emb, targets, lse = ctx.saved_tensors
        dx, demb = _ce_bwd(x, emb, targets, lse, ctx.chunk, g)
        return dx, demb, None, None


def chunked_ce(x, emb, targets, chunk: int):
    """Mean token cross-entropy, vocab-chunked; equals ce_reference."""
    return _ChunkedCE.apply(x, emb, targets, chunk)


def token_ce(x, emb, targets, chunk: int | None = None):
    """Dispatcher: chunked when ``chunk`` divides the vocab (and the vocab
    is bigger than one chunk), the reference otherwise."""
    v = emb.shape[0]
    if chunk is None or v % chunk or v <= chunk:
        return ce_reference(x, emb, targets)
    return chunked_ce(x, emb, targets, chunk)
