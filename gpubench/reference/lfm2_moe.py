"""The plain reference of the LFM2-MoE training step (``arch/lfm2_moe.py``),
and its lower-precision control.

The model is the configuration as it runs (``as_run`` of its file): pre-norm
layers of two kinds, RMSNorm (eps 1e-5) before each mixer and each FFN.

- Short conv: ``B, C, X`` the three D-wide parts of ``h @ conv_in``,
  ``y = C * conv(B * X)`` with a depthwise causal convolution of
  ``conv_kernel`` taps over the sequence (zeros before the first position),
  then ``y @ conv_out``.
- Attention: q of ``n_heads`` and k, v of ``n_kv_heads`` heads of
  ``head_dim``, RMSNorm over each head's channels of q and k, rotary
  positions (rotate-half, base ``rope_theta``), k and v repeated to
  ``n_heads`` (q head h reads kv head h // (n_heads / n_kv_heads)), causal
  attention scaled by head_dim^-1/2, then ``o @ wo``.
- The first ``n_dense`` FFNs are ``(silu(h W1) * (h W3)) W2``; the rest
  route each token over all ``n_experts`` (sigmoid scores, the top
  ``top_k``, their scores over their sum plus 1e-6), and add the terms of
  the ``n_experts / ep_size`` experts held here (those of ``ep_rank``),
  each a SwiGLU of ``d_expert``.  The selection bias is held at zero.
- The loss is the mean token cross-entropy of ``h @ embed^T``; the
  optimizer is Adam (betas 0.9 and 0.999, eps 1e-8) written out, its
  learning rate rising linearly from 0 to 1e-3 over ``warmup_steps``
  steps (step t from 1 takes 1e-3 min(1, t / warmup_steps)).

To fit at the timed sizes the forward runs in blocks of rows, each layer is
recomputed in the backward, attention is computed in blocks of query rows
(``common.Attention``), each expert runs over the tokens that selected it,
and the loss runs in blocks of tokens.  In the float8 control every matrix
product (the router's and the experts' included) takes float8 operands, and
so do the convolution's products of its taps with its input.  Nothing here
imports JAX, the JAX package or the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference import common
from gpubench.reference import gpt

EPS = 1e-5
TOPK_EPS = 1e-6


def _rms(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * g


def _rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat((-x2, x1), -1)


def _swiglu(h2, w13, w2, prec):
    a = prec.mm(h2, w13)
    f = a.shape[-1] // 2
    return prec.mm(F.silu(a[:, :f]) * a[:, f:], w2)


class _Fp8Taps(torch.autograd.Function):
    """The control's product of one tap ``w`` (D,) with the input ``u``
    (B, S, D): float8 operands, as in ``common``'s products (e4m3 for the
    tap and the input, e5m2 for the gradient)."""

    @staticmethod
    def forward(ctx, w, u):
        ctx.save_for_backward(w, u)
        return common._act(w) * common._act(u)

    @staticmethod
    def backward(ctx, g):
        w, u = ctx.saved_tensors
        gq = common._grad(g)
        return (gq * common._act(u)).sum((0, 1)), gq * common._act(w)


def _taps(w, u, prec):
    return w * u if prec.name == "f32" else _Fp8Taps.apply(w, u)


def _conv(h, conv_in, conv_w, conv_out, prec):
    B, S, D = h.shape
    b, c, xs = prec.mm(h.reshape(B * S, D), conv_in).reshape(B, S, 3, D).unbind(2)
    u = b * xs
    k = conv_w.shape[-1]
    pad = torch.cat((u.new_zeros(B, k - 1, D), u), 1)
    y = sum(_taps(conv_w[:, j], pad[:, j:j + S], prec) for j in range(k))
    return prec.mm((c * y).reshape(B * S, D), conv_out).reshape(B, S, D)


def _attention(h, wq, wk, wv, wo, gq, gk, model, prec):
    B, S, D = h.shape
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    h2 = h.reshape(B * S, D)
    inv = 1.0 / model["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=h.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=h.device)[:, None] * inv
    ang = torch.cat((ang, ang), -1)[None, None]  # (1, 1, S, hd)
    cos, sin = ang.cos(), ang.sin()

    def heads(w, n, g):
        t = _rms(prec.mm(h2, w).reshape(B, S, n, hd), g).transpose(1, 2)
        return t * cos + _rotate_half(t) * sin

    q, k = heads(wq, H, gq), heads(wk, Hkv, gk)
    v = prec.mm(h2, wv).reshape(B, S, Hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, 1).contiguous()
    v = v.repeat_interleave(H // Hkv, 1).contiguous()
    block = max(1, min(S, common.BLOCK_ELEMS // (B * H * S)))
    o = common.Attention.apply(q.contiguous(), k, v, prec, block)
    return prec.mm(o.transpose(1, 2).reshape(B * S, H * hd), wo).reshape(B, S, D)


def _moe(h, router, w13, w2, model, prec):
    B, S, D = h.shape
    h2 = h.reshape(B * S, D)
    s = torch.sigmoid(prec.mm(h2, router))
    sel = torch.topk(s.detach(), model["top_k"], dim=-1).indices
    w = s.gather(1, sel)
    w = w / (w.sum(-1, keepdim=True) + TOPK_EPS) * model["routed_scaling"]
    held = model["n_experts"] // model["ep_size"]
    out = torch.zeros_like(h2)
    for j in range(held):
        tok, slot = (sel == model["ep_rank"] * held + j).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(h2[tok], w13[j], w2[j], prec) * w[tok, slot][:, None]
            out = out.index_add(0, tok, y)
    return out.reshape(B, S, D)


def _layer(x, i, p, model, prec):
    """Layer ``i`` on ``x``; ``p`` holds this layer's slices."""
    h = _rms(x, p["op_norm"])
    if model["layer_types"][i] == "conv":
        x = x + _conv(h, p["conv_in"], p["conv_w"], p["conv_out"], prec)
    else:
        x = x + _attention(h, p["wq"], p["wk"], p["wv"], p["wo"], p["q_norm"],
                           p["k_norm"], model, prec)
    h = _rms(x, p["ffn_norm"])
    if i < model["n_dense"]:
        B, S, D = h.shape
        return x + _swiglu(h.reshape(B * S, D), p["dense_w13"], p["dense_w2"],
                           prec).reshape(B, S, D)
    return x + _moe(h, p["router"], p["moe_w13"], p["moe_w2"], model, prec)


_KINDS = {"conv": ("conv_in", "conv_w", "conv_out"),
          "attn": ("wq", "wk", "wv", "wo", "q_norm", "k_norm"),
          "dense": ("dense_w13", "dense_w2"),
          "moe": ("router", "moe_w13", "moe_w2")}


def _slices(p, model):
    """Each layer's slices of the stacked leaves, in order."""
    n = {k: 0 for k in _KINDS}
    for i, kind in enumerate(model["layer_types"]):
        mixer = "conv" if kind == "conv" else "attn"
        ffn = "dense" if i < model["n_dense"] else "moe"
        out = {"op_norm": p["op_norm"][i], "ffn_norm": p["ffn_norm"][i]}
        for k in (mixer, ffn):
            out.update({name: p[name][n[k]] for name in _KINDS[k]})
            n[k] += 1
        yield out


def hidden(p, tok, model, prec):
    """The final RMSNorm's output for the token rows ``tok``, each layer
    recomputed in the backward."""
    x = p["embed"][tok]
    for i, w in enumerate(_slices(p, model)):
        x = checkpoint(_layer, x, i, w, model, prec, use_reentrant=False)
    return _rms(x, p["final_norm"]).reshape(-1, model["d_model"])


def loss_backward(p, tokens, targets, model, prec) -> float:
    """Accumulate into each leaf's ``.grad`` the gradient of the mean token
    cross-entropy over the batch, in blocks of rows.  Returns the loss."""
    B, S = tokens.shape
    rows = max(1, common.ROW_TOKENS // S)
    device = p["embed"].device
    total = 0.0
    for r0 in range(0, B, rows):
        tok = tokens[r0:r0 + rows].to(device)
        tgt = targets[r0:r0 + rows].to(device).reshape(-1)
        loss = gpt.ce_sum(hidden(p, tok, model, prec), p["embed"], tgt,
                          model, prec) / (B * S)
        loss.backward()
        total += float(loss.detach())
    return total


def readings(model: dict, leaves, batches, steps: int, precision: str = "f32") -> dict:
    """``common.readings``' readings of this model, with its learning-rate
    warmup: follow ``steps``
    steps of Adam from the weights ``leaves`` draws on ``batches``; return
    each step's loss, each leaf's first gradient norm and each leaf's
    change norm after the last step."""
    prec = common.Precision(precision)
    b1, b2, eps = common.ADAM["b1"], common.ADAM["b2"], common.ADAM["eps"]
    with common._no_tf32():
        p = {n: leaves.draw(n).requires_grad_(True) for n in leaves.names}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        losses, grad_norms = [], {}
        for t in range(1, steps + 1):
            tokens, targets = batches[t - 1]
            losses.append(loss_backward(p, tokens, targets, model, prec))
            lr = common.ADAM["lr"] * min(1.0, t / model["warmup_steps"])
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
