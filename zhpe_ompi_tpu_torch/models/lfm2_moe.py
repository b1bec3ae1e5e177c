"""LFM2-MoE (Liquid AI's LFM2-8B-A1B family): a hybrid stack of gated
short-convolution and grouped-query attention layers, RMSNorm, a few dense
SwiGLU layers and then mixture-of-experts layers with a sigmoid top-k
router.  The port's addition: the JAX package has no such model.

With ``x`` the residual stream (B, S, D) in ``cfg.dtype`` over float32
masters cast at use, as in ``models/transformer``, layer i is::

    x = x + mixer_i(rms(x, op_norm[i]))
    x = x + ffn_i(rms(x, ffn_norm[i]))

and the model ends in ``rms(x, final_norm)``, the head tied to ``embed``.
``rms(x, g) = g x rsqrt(mean(x^2) + 1e-5)`` in float32
(``ops/fused_norm.rms_norm``: the layernorm kernels with their RMS flag).

- Short conv (``layer_types[i] == "conv"``): ``B, C, X = split3(h @
  conv_in)``, ``u = B X``, a depthwise causal convolution of ``conv_kernel``
  taps over the sequence (zeros before the first position, no bias),
  ``y = C conv(u)``, then ``y @ conv_out``.
- Attention (``"full_attention"``): q (``n_heads``), k and v
  (``n_kv_heads``) of ``head_dim``, an RMSNorm over each head's channels of
  q and k (gains ``q_norm``, ``k_norm``), rotary positions (rotate-half,
  base ``rope_theta``), k and v repeated to ``n_heads`` (q head h reads kv
  head h // (n_heads / n_kv_heads)), causal flash attention scaled by
  head_dim^-1/2, then ``o @ wo``.
- Dense FFN (the first ``n_dense`` layers): ``(silu(h W1) (h W3)) W2``
  with W1 and W3 side by side in ``dense_w13``.
- MoE FFN (the rest): ``s = sigmoid(h @ router)`` in float32 over all
  ``n_experts``, ``sel = top_k(s + expert_bias)``, ``w = s[sel]``
  normalised to sum 1 (plus 1e-6) and scaled by ``routed_scaling``, and the
  output ``sum_k w_k E_{sel_k}(h)`` with SwiGLU experts of ``d_expert``.

Expert parallelism: ``ep_size`` ranks share each MoE layer's experts, rank
``ep_rank`` holding experts ``[ep_rank * held, (ep_rank + 1) * held)``
with ``held = n_experts / ep_size``.  The router is whole on every rank.
A rank adds the terms whose expert it holds, with the weights normalised
over all ``top_k`` selections; the ranks' outputs add up to the whole
layer's.  On one rank nothing is exchanged: the exchange over cards is not
implemented, and the training step refuses ``ep_size > 1`` over more than
one data-parallel rank.

The expert layer is dropless: every (token, held expert) pair is
computed.  The pairs are sorted by expert on the device, one count is read
to the host per layer to size the buffers to the pairs routed here, and
each expert weight runs as one grouped product over the held experts
(``torch._grouped_mm`` on CUDA, with the group ends on the device; a loop
over the groups on the CPU).  The backward reads nothing to the host.

Leaves, stacked per layer kind and taken apart once per forward with
``unbind`` (as ``transformer.forward_hidden`` does): ``embed`` (V, D);
``op_norm``, ``ffn_norm`` (L, D); ``final_norm`` (D,); ``conv_in`` (Lc, D,
3D), ``conv_w`` (Lc, D, K), ``conv_out`` (Lc, D, D); ``wq`` (La, D, H hd),
``wk``, ``wv`` (La, D, Hkv hd), ``wo`` (La, H hd, D), ``q_norm``,
``k_norm`` (La, hd); ``dense_w13`` (Ld, D, 2F), ``dense_w2`` (Ld, F, D);
``router`` (Lm, D, E), ``moe_w13`` (Lm, held, D, 2Fe), ``moe_w2`` (Lm,
held, Fe, D).  The selection bias ``expert_bias`` is not a leaf: the
training step holds it at zero, and nothing updates it.

While a profiler records, the MoE layers' stages run in profiler ranges
``zmpi.moe.route``, ``zmpi.moe.experts`` and ``zmpi.moe.combine``, and the
short convolution in ``zmpi.conv``.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core import errors
from ..ops import flash_attention as fa
from ..ops import fused_ce, fused_norm
from ..parallel import hybrid
from ..runtime import ztrace
from . import transformer as tfm

_EPS = 1e-5
#: added to the sum of the selected scores before they are normalised
_TOPK_EPS = 1e-6


@dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    layer_types: tuple = ("conv", "conv", "full_attention", "conv")
    n_dense: int = 1
    d_ff: int = 128
    d_expert: int = 32
    n_experts: int = 8
    top_k: int = 2
    ep_size: int = 1
    ep_rank: int = 0
    conv_kernel: int = 3
    rope_theta: float = 1e6
    routed_scaling: float = 1.0
    seq: int = 64
    dtype: torch.dtype = torch.bfloat16
    # the 2 + 2 L width-D norms: None = the kernels on CUDA and
    # rms_reference on the CPU; True = the kernel path everywhere (its plain
    # version on the CPU); False = rms_reference everywhere
    fused_norm: bool | None = None
    # attention, the same three meanings with attn_reference
    flash: bool | None = None
    # vocab-chunked cross-entropy chunk size, or None for the unchunked loss
    ce_chunk: int | None = None

    @property
    def held(self) -> int:
        """Experts of each MoE layer on this rank."""
        return self.n_experts // self.ep_size

    def counts(self) -> dict:
        """Layers of each kind: conv, attention, dense FFN, MoE FFN."""
        n_conv = sum(t == "conv" for t in self.layer_types)
        return {"conv": n_conv, "attn": len(self.layer_types) - n_conv,
                "dense": self.n_dense,
                "moe": len(self.layer_types) - self.n_dense}


_CONV = ("conv_in", "conv_w", "conv_out")
_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_DENSE = ("dense_w13", "dense_w2")
_MOE = ("router", "moe_w13", "moe_w2")
LEAVES = (("embed", "op_norm", "ffn_norm", "final_norm") + _CONV + _ATTN
          + _DENSE + _MOE)


def check_config(cfg: Config) -> None:
    """Raise ``errors.ArgError`` on sizes the model does not take."""
    bad = [t for t in cfg.layer_types if t not in ("conv", "full_attention")]
    if bad:
        raise errors.ArgError(f"unknown layer types {sorted(set(bad))}")
    if cfg.n_heads % cfg.n_kv_heads:
        raise errors.ArgError("n_heads must be a multiple of n_kv_heads")
    if not 0 <= cfg.n_dense <= len(cfg.layer_types):
        raise errors.ArgError(f"n_dense {cfg.n_dense} out of range")
    if cfg.n_experts % cfg.ep_size or not 0 <= cfg.ep_rank < cfg.ep_size:
        raise errors.ArgError(
            f"{cfg.n_experts} experts do not split over ep_size "
            f"{cfg.ep_size} at ep_rank {cfg.ep_rank}")
    if not 0 < cfg.top_k <= cfg.n_experts:
        raise errors.ArgError(f"top_k {cfg.top_k} out of range")


def _range(name):
    """A profiler range ``name`` while a profiler records, else nothing."""
    if ztrace.profiler_recording():
        return ztrace.profiler_range(name)
    return contextlib.nullcontext()


def _rms(x, g, cfg):
    if cfg.fused_norm is False:
        return fused_norm.rms_reference(x, g)
    return fused_norm.rms_norm(x, g, force=cfg.fused_norm is True)


# ---------------------------------------------------------------- short conv

def _conv(h, w, cfg):
    """The gated short convolution of one layer on ``h`` (B, S, D)."""
    dtype = cfg.dtype
    B, S, D = h.shape
    with _range("zmpi.conv"):
        bcx = (h.reshape(B * S, D) @ w["conv_in"].to(dtype)).reshape(B, S, 3, D)
        b, c, xs = bcx.unbind(2)
        u = (b * xs).transpose(1, 2)  # (B, D, S)
        k = cfg.conv_kernel
        y = F.conv1d(u, w["conv_w"].to(dtype).unsqueeze(1), groups=D,
                     padding=k - 1)[..., :S]
        y = c * y.transpose(1, 2)
        return (y.reshape(B * S, D) @ w["conv_out"].to(dtype)).reshape(B, S, D)


# ----------------------------------------------------------------- attention

@functools.lru_cache(maxsize=8)
def _rope_tables(seq: int, head_dim: int, theta: float, device: torch.device):
    """float32 (S, hd) cos and sin of positions 0..S-1, rotate-half layout."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim)
    freqs = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv
    emb = torch.cat((freqs, freqs), -1)
    return emb.cos(), emb.sin()


def _rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat((-x2, x1), -1)


def _head_norm_rope(t, g, cos, sin, dtype):
    """RMSNorm over each head's channels of ``t`` (B, S, h, hd), then the
    rotary positions, in float32; cast to ``dtype`` once."""
    tf = t.float()
    tf = tf * torch.rsqrt((tf * tf).mean(-1, keepdim=True) + _EPS) * g
    cos, sin = cos[:, None, :], sin[:, None, :]
    return (tf * cos + _rotate_half(tf) * sin).to(dtype)


def _attention(h, w, cfg):
    dtype = cfg.dtype
    B, S, D = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h2 = h.reshape(B * S, D)
    q = (h2 @ w["wq"].to(dtype)).reshape(B, S, H, hd)
    k = (h2 @ w["wk"].to(dtype)).reshape(B, S, Hkv, hd)
    v = (h2 @ w["wv"].to(dtype)).reshape(B, S, Hkv, hd)
    cos, sin = _rope_tables(S, hd, float(cfg.rope_theta), h.device)
    q = _head_norm_rope(q, w["q_norm"], cos, sin, dtype)
    k = _head_norm_rope(k, w["k_norm"], cos, sin, dtype)
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    if cfg.flash is False:
        o = fa.attn_reference(q, k, v, causal=True)
    else:
        o = fa.flash_attention(q, k, v, causal=True, force=cfg.flash is True)
    return (o.reshape(B * S, H * hd) @ w["wo"].to(dtype)).reshape(B, S, D)


# ------------------------------------------------------------------------ ffn

def _swiglu(a):
    f = a.shape[-1] // 2
    return F.silu(a[..., :f]) * a[..., f:]


def _dense(h, w, cfg):
    dtype = cfg.dtype
    B, S, D = h.shape
    a = h.reshape(B * S, D) @ w["dense_w13"].to(dtype)
    return (_swiglu(a) @ w["dense_w2"].to(dtype)).reshape(B, S, D)


def grouped_mm(a, b, offs):
    """``a`` (n, K) in groups of rows ending at ``offs`` (G,) int32, each
    group times its matrix of ``b`` (G, K, N): (n, N).  CUDA:
    ``torch._grouped_mm`` (bfloat16, the group ends read on the device);
    CPU: a loop over the groups."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a, b, offs)
    out = a.new_empty(a.shape[0], b.shape[-1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[start:end] = a[start:end] @ b[g]
        start = end
    return out


def grouped_mm_wgrad(a, gy, offs):
    """Per group of rows (ends ``offs``), ``a_g^T gy_g``: (G, K, N) from
    ``a`` (n, K) and ``gy`` (n, N); zeros for an empty group (on CUDA
    ``torch._grouped_mm`` writes them, over memory left dirty before, as
    the ``cuda`` tests of an empty group show)."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a.t(), gy, offs)
    out = a.new_zeros(offs.shape[0], a.shape[1], gy.shape[1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[g] = a[start:end].t() @ gy[start:end]
        start = end
    return out


class _RouterScores(torch.autograd.Function):
    """``sigmoid(h2 @ router)`` in float32 from ``h2`` in the model dtype;
    saves ``h2`` as it is, not a float32 copy."""

    @staticmethod
    def forward(ctx, h2, router):
        s = torch.sigmoid(h2.float() @ router)
        ctx.save_for_backward(h2, router, s)
        return s

    @staticmethod
    def backward(ctx, gs):
        h2, router, s = ctx.saved_tensors
        gz = gs * s * (1 - s)
        return (gz @ router.t()).to(h2.dtype), h2.float().t() @ gz


class _Experts(torch.autograd.Function):
    """The held experts on their pairs: ``xp = h2[tok]`` (pairs sorted by
    expert, group ends ``offs``), ``a = xp @ w13`` and ``y = swiglu(a) @
    w2``, each a grouped product.  Saves ``h2``, ``tok`` and ``a``; the
    backward gathers ``xp`` and recomputes ``swiglu(a)``, and adds the
    pairs' gradients into ``h2``'s rows in float32."""

    @staticmethod
    def forward(ctx, h2, tok, offs, w13, w2):
        a = grouped_mm(h2.index_select(0, tok), w13, offs)
        ctx.save_for_backward(h2, tok, offs, w13, w2, a)
        return grouped_mm(_swiglu(a), w2, offs)

    @staticmethod
    def backward(ctx, gy):
        h2, tok, offs, w13, w2, a = ctx.saved_tensors
        gy = gy.contiguous()
        f = a.shape[-1] // 2
        a1, a3 = a[:, :f].float(), a[:, f:].float()
        sg = torch.sigmoid(a1)
        silu = a1 * sg
        u = (silu * a3).to(a.dtype)
        gu = grouped_mm(gy, w2.transpose(-1, -2), offs).float()
        dw2 = grouped_mm_wgrad(u, gy, offs)
        del u
        ga = torch.cat((gu * a3 * sg * (1 + a1 * (1 - sg)), gu * silu), -1).to(a.dtype)
        del a1, a3, sg, silu, gu
        dxp = grouped_mm(ga, w13.transpose(-1, -2), offs)
        dw13 = grouped_mm_wgrad(h2.index_select(0, tok), ga, offs)
        dh2 = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        dh2.index_add_(0, tok, dxp.float())
        return dh2.to(h2.dtype), None, None, dw13, dw2


class _Combine(torch.autograd.Function):
    """``out[t] = sum over pairs p of token t of w_p y_p``, summed in
    float32 into (T, D) and cast to ``y``'s dtype."""

    @staticmethod
    def forward(ctx, y, w, tok, T):
        out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
        out.index_add_(0, tok, y.float() * w[:, None])
        ctx.save_for_backward(y, w, tok)
        return out.to(y.dtype)

    @staticmethod
    def backward(ctx, gout):
        y, w, tok = ctx.saved_tensors
        g = gout.index_select(0, tok).float()
        gw = (g * y.float()).sum(-1)
        return (g * w[:, None]).to(y.dtype), gw, None, None


class MoeTally:
    """What the MoE layers of one step count: the pairs computed and the
    largest held expert's rows (summed over layers, on the device, read
    once by :meth:`close`), the host reads the forward made, and the stream
    span of routing, permutation and combine (``hybrid.Laps``: CUDA events
    on the card, the host clock elsewhere)."""

    def __init__(self, device):
        self.laps = hybrid.Laps({}, device)
        self.rows = torch.zeros(2, dtype=torch.int64, device=device)
        self.host_reads = 0

    def add(self, counts):
        self.rows += torch.stack((counts.sum(), counts.max()))

    def close(self, timings: dict) -> None:
        """Add ``moe_rows``, ``moe_rows_max``, ``moe_host_reads`` and
        ``moe_route_s`` into ``timings``."""
        route = self.laps.close().get("route", 0.0)
        rows, rows_max = self.rows.tolist()
        for key, value in (("moe_rows", rows), ("moe_rows_max", rows_max),
                           ("moe_host_reads", self.host_reads),
                           ("moe_route_s", route)):
            timings[key] = timings.get(key, 0) + value


def moe_ffn(h, w, cfg, expert_bias=None, tally: MoeTally | None = None):
    """One MoE layer on ``h`` (B, S, D): this rank's held experts' part of
    the output.  ``w`` holds ``router`` (D, E), ``moe_w13`` (held, D, 2Fe)
    and ``moe_w2`` (held, Fe, D); ``expert_bias`` (E,) is added to the
    scores for the selection alone (zeros where None)."""
    dtype = cfg.dtype
    B, S, D = h.shape
    T, k, held = B * S, cfg.top_k, cfg.held
    h2 = h.reshape(T, D)
    if tally is not None:
        tally.laps.restart()
    with _range("zmpi.moe.route"):
        s = _RouterScores.apply(h2, w["router"])
        with torch.no_grad():
            key = s if expert_bias is None else s + expert_bias
            sel = torch.topk(key, k, dim=-1).indices
        wts = s.gather(1, sel)
        wts = wts / (wts.sum(-1, keepdim=True) + _TOPK_EPS) * cfg.routed_scaling
        with torch.no_grad():
            local = sel - cfg.ep_rank * held
            group = torch.where((local >= 0) & (local < held), local, held).reshape(-1)
            order = torch.argsort(group, stable=True)
            counts = torch.zeros(held + 1, dtype=torch.int64, device=h.device)
            counts.scatter_add_(0, group, torch.ones_like(group))
            # the one host read: how many pairs this rank computes
            n = T * k - int(counts[held])
            if tally is not None:
                tally.host_reads += 1
                tally.add(counts[:held])
            pair = order[:n]
            tok = pair // k
            offs = counts[:held].cumsum(0).to(torch.int32)
        xw = wts.reshape(-1).index_select(0, pair)
    if tally is not None:
        tally.laps.lap("route")
    with _range("zmpi.moe.experts"):
        y = _Experts.apply(h2, tok, offs, w["moe_w13"].to(dtype), w["moe_w2"].to(dtype))
    if tally is not None:
        tally.laps.restart()
    with _range("zmpi.moe.combine"):
        out = _Combine.apply(y, xw, tok, T)
    if tally is not None:
        tally.laps.lap("route")
    return out.reshape(B, S, D)


# --------------------------------------------------------------------- model

def forward_hidden(params: dict, tokens, cfg: Config, expert_bias=None,
                   tally: MoeTally | None = None):
    """Forward pass up to the final RMSNorm: (B, S, D) in ``cfg.dtype``.
    ``expert_bias`` (Lm, E) is the routers' selection bias (zeros where
    None); ``tally`` counts the MoE layers' work."""
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    x = emb.to(cfg.dtype)[tokens]

    def layers(names):
        return iter(zip(*(params[n].unbind(0) for n in names)))

    conv, attn, dense, moe = (layers(n) for n in (_CONV, _ATTN, _DENSE, _MOE))
    norms = zip(params["op_norm"].unbind(0), params["ffn_norm"].unbind(0))
    biases = expert_bias.unbind(0) if expert_bias is not None else None
    for i, (kind, (g_op, g_ffn)) in enumerate(zip(cfg.layer_types, norms)):
        h = _rms(x, g_op, cfg)
        if kind == "conv":
            x = x + _conv(h, dict(zip(_CONV, next(conv))), cfg)
        else:
            x = x + _attention(h, dict(zip(_ATTN, next(attn))), cfg)
        h = _rms(x, g_ffn, cfg)
        if i < cfg.n_dense:
            x = x + _dense(h, dict(zip(_DENSE, next(dense))), cfg)
        else:
            bias = biases[i - cfg.n_dense] if biases is not None else None
            x = x + moe_ffn(h, dict(zip(_MOE, next(moe))), cfg, bias, tally)
    return _rms(x, params["final_norm"], cfg)


def forward(params: dict, tokens, cfg: Config, expert_bias=None):
    """Full forward pass: vocabulary logits (f32) from model-dtype operands
    with f32 accumulation."""
    x = forward_hidden(params, tokens, cfg, expert_bias)
    return fused_ce._logits(x, params["embed"].to(cfg.dtype))


_NO_LAPS = hybrid.Laps(None)


def loss_fn(params, tokens, targets, cfg: Config, expert_bias=None,
            tally: MoeTally | None = None, *, laps: hybrid.Laps | None = None):
    """Mean token cross-entropy in the fused lse form, vocab-chunked when
    ``cfg.ce_chunk`` is set.  ``laps`` times the ``"forward"`` and the
    ``"loss"`` apart, as ``transformer.loss_fn`` does."""
    laps = laps or _NO_LAPS
    with laps.phase("forward"):
        targets = torch.as_tensor(targets, device=params["embed"].device).long()
        x = forward_hidden(params, tokens, cfg, expert_bias, tally)
    with laps.phase("loss"):
        return fused_ce.token_ce(x, params["embed"].to(cfg.dtype), targets,
                                 cfg.ce_chunk)


def make_train_step_optax(cfg: Config, dp_comm, tp_comm=None, sp_comm=None,
                          optimizer=None, timings: dict | None = None):
    """The training step of ``transformer.make_train_step_optax``, its body
    shared (``transformer.optax_train_step``: the ``Laps`` phases, the
    ``coll/monitoring`` window, ``_sync_grads`` over ``dp_comm`` and the
    optimizer, default Adam), on :func:`loss_fn`.  Returns
    ``(init_opt_state, step, param_specs)``.

    Every leaf is replicated over dp (``param_specs`` maps each to None);
    the experts are this rank's share of an ``ep_size``-way
    expert-parallel layout.  Refused with
    ``errors.ArgError``: ``tp_comm`` of more than one rank, ``sp_comm``,
    and ``ep_size > 1`` over a ``dp_comm`` of more than one rank (that
    layout needs the exchange of tokens between cards, which is not
    implemented).

    ``timings`` gets the shared body's phases and collective counts and,
    from the MoE layers: ``moe_rows`` (the token-expert pairs computed
    here), ``moe_rows_max`` (the largest held expert's rows, summed over
    layers), ``moe_host_reads`` (the forward's reads to the host) and
    ``moe_route_s`` (the stream span of routing, permutation and combine).
    The pair counts are summed on the device and read once a step, after
    the step's phases are closed."""
    check_config(cfg)
    if tp_comm is not None and tp_comm.size > 1:
        raise errors.ArgError("lfm2_moe has no tensor parallelism: tp_comm.size must be 1")
    if sp_comm is not None:
        raise errors.ArgError("lfm2_moe has no sequence parallelism: sp_comm must be None")
    if cfg.ep_size > 1 and dp_comm.size > 1:
        raise errors.ArgError(
            "ep_size > 1 over more than one rank needs the expert exchange, "
            "which is not implemented")
    state: dict = {"tally": None}

    def loss(leaves, tokens, targets, laps):
        # the selection bias is held at zero
        return loss_fn(leaves, tokens, targets, cfg, None, state["tally"], laps=laps)

    # at tp 1 no gradient needs the tp mean: only the loss meets tp_comm
    init_opt_state, inner = tfm.optax_train_step(
        loss, dp_comm, tp_comm, None, optimizer=optimizer, timings=timings,
        tp_replicated=frozenset())

    def step(params, opt_state, tokens, targets):
        tally = state["tally"] = (MoeTally(params["embed"].device)
                                  if timings is not None else None)
        try:
            out = inner(params, opt_state, tokens, targets)
        finally:
            state["tally"] = None
        if tally is not None:
            tally.close(timings)
        return out

    return init_opt_state, step, {n: None for n in LEAVES}

