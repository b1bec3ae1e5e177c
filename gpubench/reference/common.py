"""What the plain references of every architecture share: the products of
the reference's precision and of its lower-precision control, causal
attention in blocks of query rows, and the training steps they follow
(Adam written out) with the readings the comparison takes.

``precision="f32"`` computes every product in float32 with TF32 off: the
reference.  ``precision="fp8"`` is the control: every matrix product, the
attention products included, takes operands rounded to float8 (e4m3 for
weights and activations, e5m2 for gradients, one scale per tensor), the
step a later change might take below the configuration's bfloat16.
Nothing here imports JAX, the JAX package or the port.
"""

from __future__ import annotations

import contextlib
import math

import torch

ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
#: elements of one block of attention scores, and of one block of logits
BLOCK_ELEMS = 1 << 29
#: tokens of one block of rows through the model
ROW_TOKENS = 16384


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8) under one scale for the whole
    tensor, back in t's dtype."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def _act(t):
    return _fp8(t, torch.float8_e4m3fn)


def _grad(t):
    return _fp8(t, torch.float8_e5m2)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _act(a) @ _act(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = _grad(g)
        return gq @ _act(b).transpose(-1, -2), _act(a).transpose(-1, -2) @ gq


class Precision:
    """The products of one precision: ``mm`` inside autograd, ``raw``
    inside the hand-written attention (``grad_a``/``grad_b`` mark an
    operand that is a gradient)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a, b):
        if self.name == "f32":
            return a @ b
        return _Fp8Matmul.apply(a, b)

    def raw(self, a, b, grad_a=False, grad_b=False):
        if self.name == "f32":
            return a @ b
        return (_grad(a) if grad_a else _act(a)) @ (_grad(b) if grad_b else _act(b))


def _causal_mask(i0, i1, device):
    rows = torch.arange(i0, i1, device=device)[:, None]
    cols = torch.arange(0, i1, device=device)[None, :]
    return cols > rows


class Attention(torch.autograd.Function):
    """Causal attention over (B, H, S, hd) float32 tensors in blocks of
    query rows; the backward recomputes each block's probabilities from the
    saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prec, block):
        S, hd = q.shape[2], q.shape[3]
        scale = hd ** -0.5
        o = torch.empty_like(q)
        lse = q.new_empty(q.shape[:3])
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            s = prec.raw(q[:, :, i0:i1], k[:, :, :i1].transpose(-1, -2)) * scale
            s.masked_fill_(_causal_mask(i0, i1, q.device), -math.inf)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            del s
            l = p.sum(-1, keepdim=True)
            o[:, :, i0:i1] = prec.raw(p, v[:, :, :i1]) / l
            lse[:, :, i0:i1] = (m + torch.log(l)).squeeze(-1)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.prec, ctx.block = prec, block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        prec, block = ctx.prec, ctx.block
        S, hd = q.shape[2], q.shape[3]
        scale = hd ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (do * o).sum(-1, keepdim=True)
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            qi, doi = q[:, :, i0:i1], do[:, :, i0:i1]
            s = prec.raw(qi, k[:, :, :i1].transpose(-1, -2)) * scale
            s.masked_fill_(_causal_mask(i0, i1, q.device), -math.inf)
            p = torch.exp(s - lse[:, :, i0:i1, None])
            del s
            dv[:, :, :i1] += prec.raw(p.transpose(-1, -2), doi, grad_b=True)
            dp = prec.raw(doi, v[:, :, :i1].transpose(-1, -2), grad_a=True)
            ds = p * (dp - delta[:, :, i0:i1])
            del p, dp
            dq[:, :, i0:i1] = prec.raw(ds, k[:, :, :i1], grad_a=True) * scale
            dk[:, :, :i1] += prec.raw(ds.transpose(-1, -2), qi, grad_a=True) * scale
        return dq, dk, dv, None, None


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def readings(loss_backward, model: dict, leaves, batches, steps: int,
             precision: str = "f32") -> dict:
    """Follow ``steps`` training steps of Adam from the weights ``leaves``
    draws (``inputs.Leaves``) on ``batches[0..steps-1]``, each step's
    gradients accumulated by ``loss_backward(p, tokens, targets, model,
    prec)``, which returns the step's loss.  Returns what the comparison
    reads: the loss of each step, the norm of each leaf's first gradient,
    and the norm of each leaf's change after the last step."""
    prec = Precision(precision)
    with _no_tf32():
        p = {n: leaves.draw(n).requires_grad_(True) for n in leaves.names}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        b1, b2, lr, eps = ADAM["b1"], ADAM["b2"], ADAM["lr"], ADAM["eps"]
        losses, grad_norms = [], {}
        for t in range(1, steps + 1):
            tokens, targets = batches[t - 1]
            losses.append(loss_backward(p, tokens, targets, model, prec))
            with torch.no_grad():
                for n, w in p.items():
                    g = w.grad
                    if t == 1:
                        grad_norms[n] = float(g.norm())
                    m[n].lerp_(g, 1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    w.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                    w.grad = None
        del m, v
        with torch.no_grad():
            change = {}
            for n in leaves.names:
                w0 = leaves.draw(n)
                change[n] = float((p[n] - w0).norm())
                del w0
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
