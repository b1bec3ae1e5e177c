"""The plain reference of ``models/lfm2_moe``: the same model written out
in float32 torch operations, with no kernel of the port, no grouped
product, no chunked loss and no JAX.  The tests hold the port against it
(logits, loss, and autograd's gradient of every leaf).

``cfg`` is read for its sizes alone (``models/lfm2_moe.Config`` or any
object with the same fields), and the leaves are ``lfm2_moe``'s.  The
routing is the program's: sigmoid scores over all ``n_experts``, the top
``top_k`` of the scores plus ``expert_bias``, the selected scores over
their sum plus 1e-6 times ``routed_scaling``; the layer adds the terms of
the experts it holds (``ep_rank``'s share of ``ep_size``), each expert
taken in turn over the tokens that selected it.  Every product runs in
float32 with TF32 off (``torch.backends.cuda.matmul`` and
``torch.backends.cudnn`` alike) for the length of each call.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-5
TOPK_EPS = 1e-6


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * g


def _rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat((-x2, x1), -1)


def _swiglu(h, w13, w2):
    a = h @ w13
    f = a.shape[-1] // 2
    return (F.silu(a[:, :f]) * a[:, f:]) @ w2


def conv_layer(h, conv_in, conv_w, conv_out):
    """Gated short convolution of ``h`` (B, S, D): the taps written out."""
    B, S, D = h.shape
    b, c, xs = (h @ conv_in).split(D, -1)
    u = b * xs
    k = conv_w.shape[-1]
    pad = torch.cat((u.new_zeros(B, k - 1, D), u), 1)
    y = sum(conv_w[:, j] * pad[:, j:j + S] for j in range(k))
    return (c * y) @ conv_out


def attention_layer(h, w, cfg):
    B, S, D = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ w["wq"]).reshape(B, S, H, hd)
    k = (h @ w["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ w["wv"]).reshape(B, S, Hkv, hd)
    inv = 1.0 / cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                device=h.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=h.device)[:, None] * inv
    ang = torch.cat((ang, ang), -1)[:, None, :]
    cos, sin = ang.cos(), ang.sin()
    q = rms(q, w["q_norm"])
    k = rms(k, w["k_norm"])
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    k = k.repeat_interleave(H // Hkv, 2)
    v = v.repeat_interleave(H // Hkv, 2)
    s = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, H * hd)
    return o @ w["wo"]


def route(h2, router, cfg, expert_bias=None):
    """``(sel, w)``: each token's selected experts (T, top_k) and their
    normalised weights."""
    s = torch.sigmoid(h2 @ router)
    key = s if expert_bias is None else s + expert_bias
    sel = torch.topk(key.detach(), cfg.top_k, dim=-1).indices
    w = s.gather(1, sel)
    return sel, w / (w.sum(-1, keepdim=True) + TOPK_EPS) * cfg.routed_scaling


def moe_layer(h, router, w13, w2, cfg, expert_bias=None):
    """The held experts' part of one MoE layer on ``h`` (B, S, D); ``w13``
    and ``w2`` hold the ``n_experts // ep_size`` experts of ``ep_rank``."""
    B, S, D = h.shape
    h2 = h.reshape(B * S, D)
    sel, w = route(h2, router, cfg, expert_bias)
    held = cfg.n_experts // cfg.ep_size
    out = torch.zeros_like(h2)
    for j in range(held):
        tok, slot = (sel == cfg.ep_rank * held + j).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(h2[tok], w13[j], w2[j]) * w[tok, slot][:, None]
            out = out.index_add(0, tok, y)
    return out.reshape(B, S, D)


def hidden(p, tokens, cfg, expert_bias=None):
    """The final RMSNorm's output (B, S, D)."""
    x = p["embed"][tokens]
    i_conv = i_attn = 0
    for i, kind in enumerate(cfg.layer_types):
        h = rms(x, p["op_norm"][i])
        if kind == "conv":
            x = x + conv_layer(h, p["conv_in"][i_conv], p["conv_w"][i_conv],
                               p["conv_out"][i_conv])
            i_conv += 1
        else:
            w = {n: p[n][i_attn] for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")}
            x = x + attention_layer(h, w, cfg)
            i_attn += 1
        h = rms(x, p["ffn_norm"][i])
        if i < cfg.n_dense:
            B, S, D = h.shape
            x = x + _swiglu(h.reshape(B * S, D), p["dense_w13"][i],
                            p["dense_w2"][i]).reshape(B, S, D)
        else:
            m = i - cfg.n_dense
            bias = expert_bias[m] if expert_bias is not None else None
            x = x + moe_layer(h, p["router"][m], p["moe_w13"][m], p["moe_w2"][m],
                              cfg, bias)
    return rms(x, p["final_norm"])


def forward(p, tokens, cfg, expert_bias=None):
    """Logits (B, S, V) of the tied head."""
    with _no_tf32():
        return hidden(p, tokens, cfg, expert_bias) @ p["embed"].t()


def loss(p, tokens, targets, cfg, expert_bias=None):
    """Mean token cross-entropy."""
    with _no_tf32():
        logits = hidden(p, tokens, cfg, expert_bias) @ p["embed"].t()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
