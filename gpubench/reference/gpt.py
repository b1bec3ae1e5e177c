"""The plain reference of the GPT training step (``arch/gpt.py``), and its
lower-precision control.

The model is the configuration as it runs (``as_run`` of its file): a
pre-layernorm transformer with tied embeddings, no biases, layernorm
without beta (eps 1e-5), causal attention scaled by head_dim^-1/2, the tanh
form of GELU, and the mean token cross-entropy of ``h @ embed^T``.  The
optimizer is Adam (lr 1e-3, betas 0.9 and 0.999, eps 1e-8), written out in
``common.readings``.  It starts from the weights and batches of
``gpubench.inputs`` and works out its own optimizer state.

To fit at the timed sizes the forward runs in blocks of rows, each layer is
recomputed in the backward, attention is computed in blocks of query rows
(forward and backward by hand, from the saved log-sum-exp), and the loss in
blocks of tokens.  Nothing here imports JAX, the JAX package or the port.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from gpubench.reference import common

EPS_LN = 1e-5


def _ln(x, g):
    m = x.mean(-1, keepdim=True)
    c = x - m
    return c * torch.rsqrt((c * c).mean(-1, keepdim=True) + EPS_LN) * g


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def _layer(x, wqkv, wo, w1, w2, g1, g2, n_heads, prec):
    B, S, D = x.shape
    hd = D // n_heads
    h = _ln(x, g1).reshape(B * S, D)
    qkv = prec.mm(h, wqkv.reshape(D, 3 * D)).reshape(B, S, 3, n_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    block = max(1, min(S, common.BLOCK_ELEMS // (B * n_heads * S)))
    o = common.Attention.apply(q, k, v, prec, block).transpose(1, 2).reshape(B * S, D)
    x = x + prec.mm(o, wo).reshape(B, S, D)
    h = _ln(x, g2).reshape(B * S, D)
    return x + prec.mm(_gelu_tanh(prec.mm(h, w1)), w2).reshape(B, S, D)


def _ce_sum(h, head, targets, prec):
    logits = prec.mm(h, head.t())
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[:, None]).squeeze(-1)).sum()


def hidden(p, tok, model, prec):
    """The final layernorm's output for the token rows ``tok``, each layer
    recomputed in the backward."""
    x = p["embed"][tok]
    for l in range(p["wqkv"].shape[0]):
        x = checkpoint(_layer, x, p["wqkv"][l], p["wo"][l], p["w1"][l],
                       p["w2"][l], p["ln1"][l], p["ln2"][l],
                       model["n_heads"], prec, use_reentrant=False)
    return _ln(x, p["lnf"]).reshape(-1, model["d_model"])


def ce_sum(h, head, tgt, model, prec):
    """The summed token cross-entropy of ``h @ head^T``, in blocks of
    tokens, each recomputed in the backward."""
    chunk = max(1, common.BLOCK_ELEMS // model["vocab"])
    loss = 0.0
    for c0 in range(0, h.shape[0], chunk):
        loss = loss + checkpoint(_ce_sum, h[c0:c0 + chunk], head, tgt[c0:c0 + chunk],
                                 prec, use_reentrant=False)
    return loss


def loss_backward(p, tokens, targets, model, prec) -> float:
    """Accumulate into each leaf's ``.grad`` the gradient of the mean token
    cross-entropy over the batch, in blocks of rows; returns the loss."""
    B, S = tokens.shape
    rows = max(1, common.ROW_TOKENS // S)
    device = p["embed"].device
    total = 0.0
    for r0 in range(0, B, rows):
        tok = tokens[r0:r0 + rows].to(device)
        tgt = targets[r0:r0 + rows].to(device).reshape(-1)
        loss = ce_sum(hidden(p, tok, model, prec), p["embed"], tgt, model, prec) / (B * S)
        loss.backward()
        total += float(loss.detach())
    return total


def readings(model: dict, leaves, batches, steps: int, precision: str = "f32") -> dict:
    """``common.readings`` of this model."""
    return common.readings(loss_backward, model, leaves, batches, steps, precision)
