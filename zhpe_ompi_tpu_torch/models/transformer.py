"""Flagship model: a transformer LM whose every communication goes through
the framework's communicators (namesake:
``zhpe_ompi_tpu/models/transformer.py``).

The forward pass (``forward_hidden``, ``forward`` for logits, ``loss_fn``)
and the training step (``make_train_step``, with ``_sync_grads``) are
ported, with tensor and data parallelism: attention heads and the MLP
hidden are sharded over the ranks of ``tp_comm``, the partial sums after
the output and down projections are combined with ``tp_comm.allreduce``
through ``g_allreduce`` (whose partner ``f_identity`` sums the input
cotangents in the backward), and gradients are averaged over ``dp_comm``.

Parameters keep the JAX package's stacked layout, so that
:func:`params_from_numpy` is a plain copy of what
``zhpe_ompi_tpu.models.transformer.init_params`` returns: ``wqkv`` is
(L, D, 3, H), ``wo`` (L, H, D), ``w1`` (L, D, F), ``w2`` (L, F, D), the
gains ``ln1``/``ln2`` (L, D) and ``lnf`` (D,), ``embed`` (V, D), all
float32 masters cast to the model dtype at use.  The JAX package's
``lax.scan`` over layers is a Python loop over layer slices here.

Not ported yet: sequence parallelism (``sp_comm``, ring attention),
``remat`` and ``make_train_step_optax``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops as zops
from ..core import errors
from ..ops import fused_ce, fused_norm
from ..ops import flash_attention as fa
from ..parallel.grad import f_identity, g_allreduce


@dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    d_ff: int = 512
    n_layers: int = 2
    seq: int = 64
    dtype: torch.dtype = torch.bfloat16
    # attention: None = the flash kernel on CUDA and attn_reference on the
    # CPU; True = the kernel path everywhere (its plain version on the
    # CPU); False = attn_reference everywhere
    flash: bool | None = None
    # layernorm, the same three meanings with ln_reference
    fused_ln: bool | None = None
    # vocab-chunked cross-entropy chunk size, or None for the unchunked loss
    ce_chunk: int | None = None


# tp-sharded parameters and the axis each is sharded on (the JAX
# package's _param_specs, transformer.py:228-238); the rest is replicated
_TP_AXIS = {"wqkv": 3, "wo": 1, "w1": 2, "w2": 1}


def _device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; never the CPU in silence."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


def params_from_numpy(np_params: dict, cfg: Config, device=None,
                      tp_rank: int = 0, tp: int = 1) -> dict:
    """Carry the JAX package's parameters across: ``np_params`` is the dict
    ``init_params`` returns, as numpy arrays in the same layout.  With
    ``tp > 1`` each tensor-parallel parameter is sliced to rank
    ``tp_rank``'s shard, as the JAX package's ``_param_specs`` shards it."""
    dev = _device(device)
    if cfg.d_model % cfg.n_heads:
        raise errors.ArgError("d_model must be a multiple of n_heads")
    if not 0 <= tp_rank < tp:
        raise errors.ArgError(f"tp_rank {tp_rank} out of range [0, {tp})")
    out = {}
    for name, arr in np_params.items():
        a = np.asarray(arr, dtype=np.float32)
        axis = _TP_AXIS.get(name)
        if axis is not None and tp > 1:
            n = a.shape[axis]
            if n % tp:
                raise errors.ArgError(
                    f"{name} axis {axis} ({n}) does not split over tp={tp}")
            w = n // tp
            a = np.take(a, np.arange(tp_rank * w, (tp_rank + 1) * w), axis=axis)
        out[name] = torch.tensor(a, device=dev)
    return out


def _ln(x, g, fused):
    if fused is False:
        return fused_norm.ln_reference(x, g)
    return fused_norm.layer_norm(x, g, force=fused is True)


def _attention(q, k, v, flash):
    if flash is False:
        return fa.attn_reference(q, k, v, causal=True)
    return fa.flash_attention(q, k, v, causal=True, force=flash is True)


def forward_hidden(params: dict, tokens, cfg: Config, tp_comm=None):
    """Forward pass on this rank's shard, up to the final layernorm.

    ``tp_comm`` is a framework :class:`Communicator` over the tensor-
    parallel ranks, or None.  Heads and the ffn hidden arrive pre-sharded
    (``params_from_numpy(tp_rank=, tp=)``); after ``wo`` and ``w2`` the
    partial products are summed with ``tp_comm.allreduce``."""
    emb = params["embed"]
    dtype = cfg.dtype
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    x = emb.to(dtype)[tokens]  # (B, S, D)
    B, S, D = x.shape
    hd = D // cfg.n_heads
    n_heads_local = params["wqkv"].shape[-1] // hd

    for layer in range(params["wqkv"].shape[0]):
        h = _ln(x, params["ln1"][layer], cfg.fused_ln)
        if tp_comm is not None:
            h = f_identity(tp_comm, h)
        wqkv = params["wqkv"][layer].to(dtype)  # (D, 3, H_local)
        qkv = (h.reshape(B * S, D) @ wqkv.reshape(D, -1)).reshape(B, S, 3, -1)
        q = qkv[:, :, 0].reshape(B, S, n_heads_local, hd)
        k = qkv[:, :, 1].reshape(B, S, n_heads_local, hd)
        v = qkv[:, :, 2].reshape(B, S, n_heads_local, hd)
        o = _attention(q, k, v, cfg.flash).reshape(B, S, -1)
        o = o @ params["wo"][layer].to(dtype)
        if tp_comm is not None:
            o = g_allreduce(tp_comm, o)
        x = x + o
        h = _ln(x, params["ln2"][layer], cfg.fused_ln)
        if tp_comm is not None:
            h = f_identity(tp_comm, h)
        # jax.nn.gelu's default is the tanh approximation
        u = F.gelu(h @ params["w1"][layer].to(dtype), approximate="tanh")
        d = u @ params["w2"][layer].to(dtype)
        if tp_comm is not None:
            d = g_allreduce(tp_comm, d)
        x = x + d
    return _ln(x, params["lnf"], cfg.fused_ln)


def forward(params: dict, tokens, cfg: Config, tp_comm=None):
    """Full forward pass: hidden states -> vocabulary logits (f32), from
    model-dtype operands with f32 accumulation."""
    x = forward_hidden(params, tokens, cfg, tp_comm)
    return fused_ce._logits(x, params["embed"].to(cfg.dtype))


def loss_fn(params, tokens, targets, cfg: Config, tp_comm=None):
    """Mean token cross-entropy in the fused lse form, vocab-chunked when
    ``cfg.ce_chunk`` is set; differentiable on every path."""
    # targets go to the device before the forward is queued: a copy from
    # host memory queued after it would hold the host until the device
    # had run the whole forward
    targets = torch.as_tensor(targets, device=params["embed"].device).long()
    x = forward_hidden(params, tokens, cfg, tp_comm)
    return fused_ce.token_ce(x, params["embed"].to(cfg.dtype), targets,
                             cfg.ce_chunk)


# Parameters replicated over tp (everything else is tp-sharded).
_TP_REPLICATED = frozenset({"embed", "lnf", "ln1", "ln2"})


def _sync_grads(grads, loss, dp_comm, tp_comm, dp, tp):
    """The gradient synchronization semantics of the JAX package's
    ``_sync_grads``, every sync through the framework's allreduce:
      - tp-sharded params (wqkv/wo/w1/w2): their grads are tp-local
        already; average over dp only.
      - replicated-over-tp params (embed/ln): with the f/g wrappers each
        tp rank holds the full tp-summed gradient; a tp-mean makes the
        update bitwise-identical across tp ranks.
      - the loss is averaged over dp and tp.
    (The JAX package's sp-mean has no counterpart until sp is ported.)"""
    synced = {}
    for name, g in grads.items():
        g = dp_comm.allreduce(g, zops.SUM) / dp
        if name in _TP_REPLICATED and tp_comm is not None:
            g = tp_comm.allreduce(g, zops.SUM) / tp
        synced[name] = g
    loss = dp_comm.allreduce(loss, zops.SUM) / dp
    if tp_comm is not None:
        loss = tp_comm.allreduce(loss, zops.SUM) / tp
    return synced, loss


def make_train_step(cfg: Config, dp_comm, tp_comm=None, sp_comm=None,
                    lr: float = 1e-2):
    """Build the training step over dp x tp: gradients of :func:`loss_fn`
    by autograd, the sync of :func:`_sync_grads`, and the SGD update
    ``p - lr * g`` in each parameter's dtype.

    The port's communicators take the place of the JAX package's ``mesh``:
    each process runs ``step`` on its own shard, and ``dp_comm`` and
    ``tp_comm`` (framework :class:`Communicator` objects over this rank's
    data- and tensor-parallel groups; ``tp_comm`` may be None) carry every
    collective.  ``step(params, tokens, targets) -> (new_params, loss)``
    takes this rank's tp shards (``params_from_numpy(tp_rank=, tp=)``) and
    its dp slice of the batch, and returns new tensors (the old ones are
    left as they were).  ``param_specs`` maps each parameter to the axis
    it is tp-sharded on, or None.  There is no ``jit``: PyTorch runs the
    step eagerly.

    ``sp_comm`` (sequence parallelism) needs ring attention, which a later
    slice of the port brings; it raises ``UnsupportedError`` here."""
    if sp_comm is not None:
        raise errors.UnsupportedError(
            "make_train_step: sequence parallelism (sp_comm) runs ring "
            "attention (models/ring_attention.py), which a later slice of "
            "the port brings")
    dp = dp_comm.size
    tp = tp_comm.size if tp_comm is not None else 1
    param_specs = {name: _TP_AXIS.get(name) for name in
                   ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "lnf")}

    def step(params, tokens, targets):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = loss_fn(leaves, tokens, targets, cfg, tp_comm)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        synced, loss = _sync_grads(dict(zip(names, grads)), loss.detach(),
                                   dp_comm, tp_comm, dp, tp)
        with torch.no_grad():
            new_params = {n: (params[n] - lr * synced[n]).to(params[n].dtype)
                          for n in names}
        return new_params, loss

    return step, param_specs
