"""Flagship model: a transformer LM whose every communication goes through
the framework's communicators (namesake:
``zhpe_ompi_tpu/models/transformer.py``).

The forward pass (``forward_hidden``, ``forward`` for logits, ``loss_fn``)
and the training step (``make_train_step``, with ``_sync_grads``) are
ported, with tensor, data and sequence parallelism:

- **tp**: attention heads and the MLP hidden are sharded over the ranks of
  ``tp_comm``; the partial sums after the output and down projections are
  combined with ``tp_comm.allreduce`` through ``g_allreduce`` (whose
  partner ``f_identity`` sums the input cotangents in the backward);
- **dp**: gradients are averaged over ``dp_comm``;
- **sp**: tokens arrive sequence-sharded over ``sp_comm`` and attention
  runs as ring attention over its ranks (``models/ring_attention.py``),
  contiguous or, with ``cfg.zigzag_sp``, zigzag;
- **remat**: ``cfg.remat`` checkpoints each layer, keeping the projections'
  outputs and recomputing the rest in the backward.

Parameters keep the JAX package's stacked layout, so that
:func:`params_from_numpy` is a plain copy of what
``zhpe_ompi_tpu.models.transformer.init_params`` returns: ``wqkv`` is
(L, D, 3, H), ``wo`` (L, H, D), ``w1`` (L, D, F), ``w2`` (L, F, D), the
gains ``ln1``/``ln2`` (L, D) and ``lnf`` (D,), ``embed`` (V, D), all
float32 masters cast to the model dtype at use.  The JAX package's
``lax.scan`` over layers is a Python loop over layer slices here, taken
once per forward by ``unbind``: indexing a stacked leaf per layer would
make autograd fill a zero tensor the size of the whole stack and add it
into the leaf's gradient at every layer, where ``unbind``'s backward
stacks the layers' slices once.

``make_train_step_optax`` takes a ``torch.optim`` optimizer in place of an
optax transformation (default Adam with optax's defaults), which updates
the parameters in place where the JAX package donates them; with
``dcn_proc`` its gradients are averaged across processes over the host
plane (``parallel/hybrid.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import ops as zops
from ..coll import monitoring
from ..core import errors
from ..ops import fused_ce, fused_norm
from ..ops import flash_attention as fa
from ..parallel import hybrid
from ..parallel.grad import f_identity, g_allreduce
from . import ring_attention as ra


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
    # checkpoint each layer: keep the projections' outputs (aten.mm), and
    # recompute the rest (attention, layernorms, the tp allreduces) in the
    # backward — the JAX package's dots_with_no_batch_dims_saveable
    remat: bool = False
    # sequence parallelism on the zigzag layout: rank i holds global
    # chunks (i, 2n-1-i), and causal ring attention computes only the
    # live sub-blocks (models/ring_attention.py::ring_attention_zigzag)
    zigzag_sp: bool = False


# tp-sharded parameters and the axis each is sharded on (the JAX
# package's _param_specs, transformer.py:228-238); the rest is replicated
_TP_AXIS = {"wqkv": 3, "wo": 1, "w1": 2, "w2": 1}

# the parameters stacked over the layers (leading axis L)
_STACKED = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


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


def _attention(q, k, v, cfg, sp_comm):
    # under sp_comm attention is ring attention, whatever cfg.flash says
    if sp_comm is not None:
        if cfg.zigzag_sp:
            return ra.ring_attention_zigzag(sp_comm, q, k, v)
        return ra.ring_attention(sp_comm, q, k, v, causal=True)
    if cfg.flash is False:
        return fa.attn_reference(q, k, v, causal=True)
    return fa.flash_attention(q, k, v, causal=True, force=cfg.flash is True)


def _block(x, w, cfg, tp_comm, sp_comm):
    """One transformer layer on this rank's shard; ``w`` maps each name of
    ``_STACKED`` to this layer's slice of it."""
    dtype = cfg.dtype
    B, S, D = x.shape
    hd = D // cfg.n_heads
    n_heads_local = w["wqkv"].shape[-1] // hd
    h = _ln(x, w["ln1"], cfg.fused_ln)
    if tp_comm is not None:
        h = f_identity(tp_comm, h)
    wqkv = w["wqkv"].to(dtype)  # (D, 3, H_local)
    qkv = (h.reshape(B * S, D) @ wqkv.reshape(D, -1)).reshape(B, S, 3, -1)
    q = qkv[:, :, 0].reshape(B, S, n_heads_local, hd)
    k = qkv[:, :, 1].reshape(B, S, n_heads_local, hd)
    v = qkv[:, :, 2].reshape(B, S, n_heads_local, hd)
    o = _attention(q, k, v, cfg, sp_comm).reshape(B, S, -1)
    o = o @ w["wo"].to(dtype)
    if tp_comm is not None:
        o = g_allreduce(tp_comm, o)
    x = x + o
    h = _ln(x, w["ln2"], cfg.fused_ln)
    if tp_comm is not None:
        h = f_identity(tp_comm, h)
    # jax.nn.gelu's default is the tanh approximation
    u = F.gelu(h @ w["w1"].to(dtype), approximate="tanh")
    d = u @ w["w2"].to(dtype)
    if tp_comm is not None:
        d = g_allreduce(tp_comm, d)
    return x + d


def _save_only_mm(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``cfg.remat``: keep the outputs
    of ``aten.mm`` (the projections, all (B*S, D)-shaped operands) and
    recompute everything else — attention's batched products, the kernels
    (whose outputs are written in place through ctypes), the tp
    allreduces (which reduce a clone in place) and the sp shifts."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts():
    return create_selective_checkpoint_contexts(_save_only_mm)


def forward_hidden(params: dict, tokens, cfg: Config, tp_comm=None,
                   sp_comm=None):
    """Forward pass on this rank's shard, up to the final layernorm.

    ``tp_comm`` is a framework :class:`Communicator` over the tensor-
    parallel ranks, or None.  Heads and the ffn hidden arrive pre-sharded
    (``params_from_numpy(tp_rank=, tp=)``); after ``wo`` and ``w2`` the
    partial products are summed with ``tp_comm.allreduce``.

    ``sp_comm`` (sequence parallelism): ``tokens`` are this rank's block
    of the sequence (contiguous, or the zigzag chunk pair with
    ``cfg.zigzag_sp``) and attention runs as ring attention over
    ``sp_comm``'s ranks."""
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    x = emb.to(cfg.dtype)[tokens]  # (B, S_local, D)
    for slices in zip(*(params[n].unbind(0) for n in _STACKED)):
        w = dict(zip(_STACKED, slices))
        if cfg.remat:
            x = checkpoint(_block, x, w, cfg, tp_comm, sp_comm,
                           use_reentrant=False, context_fn=_remat_contexts)
        else:
            x = _block(x, w, cfg, tp_comm, sp_comm)
    return _ln(x, params["lnf"], cfg.fused_ln)


def forward(params: dict, tokens, cfg: Config, tp_comm=None, sp_comm=None):
    """Full forward pass: hidden states -> vocabulary logits (f32), from
    model-dtype operands with f32 accumulation."""
    x = forward_hidden(params, tokens, cfg, tp_comm, sp_comm)
    return fused_ce._logits(x, params["embed"].to(cfg.dtype))


def loss_fn(params, tokens, targets, cfg: Config, tp_comm=None, sp_comm=None,
            *, laps: hybrid.Laps | None = None):
    """Mean token cross-entropy (over this rank's tokens) in the fused lse
    form, vocab-chunked when ``cfg.ce_chunk`` is set; differentiable on
    every path.  ``laps`` (the training step's phase timer) times the
    ``"forward"`` (through the final layernorm) and the ``"loss"``
    (:func:`fused_ce.token_ce`) apart."""
    laps = laps or _NO_LAPS
    with laps.phase("forward"):
        # targets go to the device before the forward is queued: a copy
        # from host memory queued after it would hold the host until the
        # device had run the whole forward
        targets = torch.as_tensor(targets, device=params["embed"].device).long()
        x = forward_hidden(params, tokens, cfg, tp_comm, sp_comm)
    with laps.phase("loss"):
        return fused_ce.token_ce(x, params["embed"].to(cfg.dtype), targets,
                                 cfg.ce_chunk)


_NO_LAPS = hybrid.Laps(None)


# Parameters replicated over tp (everything else is tp-sharded).
_TP_REPLICATED = frozenset({"embed", "lnf", "ln1", "ln2"})


def _sync_grads(grads, loss, dp_comm, tp_comm, sp_comm, dp, tp, sp,
                replicated=_TP_REPLICATED):
    """The gradient synchronization semantics of the JAX package's
    ``_sync_grads``, in its order (dp, then sp, then tp), every sync
    through the framework's allreduce:
      - tp-sharded params (wqkv/wo/w1/w2): their grads are tp-local
        already; average over dp (and sp) only.
      - replicated-over-tp params (embed/ln): with the f/g wrappers each
        tp rank holds the full tp-summed gradient; a tp-mean makes the
        update bitwise-identical across tp ranks.
      - sp: every rank sees only its sequence block, so every param's grad
        is partial over sp: sp-mean them all (dp-mean x sp-mean composes
        to the global token mean).
      - the loss is averaged over dp, sp and tp.
    ``replicated`` names the replicated-over-tp parameters (GPT's by
    default)."""
    synced = {}
    for name, g in grads.items():
        g = dp_comm.allreduce(g, zops.SUM) / dp
        if sp_comm is not None:
            g = sp_comm.allreduce(g, zops.SUM) / sp
        if name in replicated and tp_comm is not None:
            g = tp_comm.allreduce(g, zops.SUM) / tp
        synced[name] = g
    loss = dp_comm.allreduce(loss, zops.SUM) / dp
    if sp_comm is not None:
        loss = sp_comm.allreduce(loss, zops.SUM) / sp
    if tp_comm is not None:
        loss = tp_comm.allreduce(loss, zops.SUM) / tp
    return synced, loss


def make_train_step(cfg: Config, dp_comm, tp_comm=None, sp_comm=None,
                    lr: float = 1e-2):
    """Build the training step over dp x tp x sp: gradients of
    :func:`loss_fn` by autograd, the sync of :func:`_sync_grads`, and the
    SGD update ``p - lr * g`` in each parameter's dtype.

    The port's communicators take the place of the JAX package's ``mesh``:
    each process runs ``step`` on its own shard, and ``dp_comm``,
    ``tp_comm`` and ``sp_comm`` (framework :class:`Communicator` objects
    over this rank's data-, tensor- and sequence-parallel groups;
    ``tp_comm`` and ``sp_comm`` may be None) carry every collective.
    ``step(params, tokens, targets) -> (new_params, loss)`` takes this
    rank's tp shards (``params_from_numpy(tp_rank=, tp=)``) and its block
    of the batch: its dp slice of the rows and its sp block of the
    sequence (the zigzag chunk pair with ``cfg.zigzag_sp``).  It returns
    new tensors (the old ones are left as they were).  ``param_specs``
    maps each parameter to the axis it is tp-sharded on, or None.  There
    is no ``jit``: PyTorch runs the step eagerly.

    The rank layout of the JAX package's ("dp", "tp", "sp") mesh: world
    rank ``r = (d * tp + t) * sp + s`` holds dp index d, tp index t and sp
    index s; its tp group is the ranks that differ from it in t only, its
    sp group those that differ in s only, its dp group those that differ
    in d only, each in increasing rank order."""
    dp = dp_comm.size
    tp = tp_comm.size if tp_comm is not None else 1
    sp = sp_comm.size if sp_comm is not None else 1
    param_specs = {name: _TP_AXIS.get(name) for name in
                   ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "lnf")}

    def step(params, tokens, targets):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = loss_fn(leaves, tokens, targets, cfg, tp_comm, sp_comm)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        synced, loss = _sync_grads(dict(zip(names, grads)), loss.detach(),
                                   dp_comm, tp_comm, sp_comm, dp, tp, sp)
        with torch.no_grad():
            new_params = {n: (params[n] - lr * synced[n]).to(params[n].dtype)
                          for n in names}
        return new_params, loss

    return step, param_specs


def _adam(params):
    """optax.adam(1e-3)'s defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0.
    optax adds eps after sqrt(nu_hat) and torch after sqrt(v)/sqrt(1 - b2^t):
    the same update in exact arithmetic, not in bits."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def make_train_step_optax(cfg: Config, dp_comm, tp_comm=None, sp_comm=None,
                          optimizer=None, dcn_proc=None,
                          dcn_weight: float | None = None,
                          dcn_sharded: bool = False,
                          timings: dict | None = None):
    """Stateful-optimizer training step: the gradients of
    :func:`make_train_step` (autograd of :func:`loss_fn`, then
    :func:`_sync_grads` over dp, sp and tp) handed to a ``torch.optim``
    optimizer.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default:
    Adam, lr 1e-3, with optax's defaults).  Returns ``(init_opt_state, step,
    param_specs)``: ``init_opt_state(params)`` builds the optimizer over the
    tensors of ``params``, and ``step(params, opt_state, tokens, targets) ->
    (params, opt_state, loss)`` updates those tensors and the optimizer's
    state **in place** (each parameter keeps its storage dtype) and returns
    the same objects.  The JAX package donates the old parameters and state
    instead; here a caller that keeps a tensor of either sees the next
    step's values, so a checkpoint must snapshot before the next step
    (``runtime/checkpoint.py`` copies at ``save``).  Since the optimizer
    owns the parameters' tensors, ``step`` refuses a ``params`` whose
    tensors are not the ones ``opt_state`` was built over.

    ``dcn_proc`` (multi-slice): a host-plane endpoint (``TcpProc``) over the
    slices, each a process running this step on its own batch.  After
    :func:`_sync_grads`, the gradients and the loss ride one
    ``parallel.hybrid.dcn_grad_sync`` (``dcn_sharded=True``: one
    ``dcn_grad_sync_sharded``, a reduction per tensor) with ``weight=
    dcn_weight`` (this slice's share of the global batch; default equal
    slices), come back on the card in the gradients' dtypes before the
    optimizer's ``step``, and the loss returned is the synced one.  At
    ``dcn_proc.size == 1`` nothing moves (as in the namesake).

    ``timings`` (the port's addition), when given a dict, accumulates over
    the steps, in seconds by phase (``parallel/hybrid.Laps``: on the card
    each phase's span on the CUDA stream, with no synchronization at its
    edges; the step returns once the last edge is reached):

    - ``"forward"`` (:func:`forward_hidden`), ``"loss"``
      (``fused_ce.token_ce``), ``"backward"`` (``torch.autograd.grad``),
      ``"sync"`` (:func:`_sync_grads`), and ``"local"``, their sum;
    - the dcn sync's ``"d2h"``, ``"dcn"`` and ``"h2d"``;
    - ``"optimizer"``: the gradients' casts, the optimizer's ``step`` and
      clearing the gradients;
    - ``"coll_calls"``, ``"coll_bytes"`` and ``"coll_host_s"``: the calls
      into the framework's collectives, their payload bytes and the host
      seconds inside them, counted at the dispatch point
      (``Communicator._coll_call_inner``, through a ``coll/monitoring``
      window armed around the step for its communicators, the backward's
      calls on autograd's threads included).

    With ``timings`` each phase runs in a profiler range
    ``zmpi.step.<phase>``, and while ``runtime/ztrace`` is armed it is
    recorded as a ``PHASE`` span ``step.<phase>``."""
    param_specs = {name: _TP_AXIS.get(name) for name in
                   ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "lnf")}

    def loss(leaves, tokens, targets, laps):
        return loss_fn(leaves, tokens, targets, cfg, tp_comm, sp_comm, laps=laps)

    init_opt_state, step = optax_train_step(
        loss, dp_comm, tp_comm, sp_comm, optimizer=optimizer,
        dcn_proc=dcn_proc, dcn_weight=dcn_weight, dcn_sharded=dcn_sharded,
        timings=timings)
    return init_opt_state, step, param_specs


def optax_train_step(loss, dp_comm, tp_comm=None, sp_comm=None, *,
                     optimizer=None, dcn_proc=None,
                     dcn_weight: float | None = None,
                     dcn_sharded: bool = False,
                     timings: dict | None = None,
                     tp_replicated=_TP_REPLICATED):
    """The body of :func:`make_train_step_optax`, shared by the port's
    models: ``loss(leaves, tokens, targets, laps)`` is the model's loss
    (its ``loss_fn`` timing the ``"forward"`` and ``"loss"`` phases on
    ``laps``), and ``tp_replicated`` names its replicated-over-tp leaves
    for :func:`_sync_grads`.  Returns ``(init_opt_state, step)``, with the
    arguments, phases, counts and in-place semantics that
    :func:`make_train_step_optax` documents."""
    factory = _adam if optimizer is None else optimizer
    dp = dp_comm.size
    tp = tp_comm.size if tp_comm is not None else 1
    sp = sp_comm.size if sp_comm is not None else 1

    # the rank the step's ztrace spans carry
    world_rank = (dp_comm.group.global_of_rank(dp_comm.rank)
                  if timings is not None else 0)

    def init_opt_state(params):
        return factory([params[n] for n in params])

    def step(params, opt_state, tokens, targets):
        names = list(params)
        owned = {id(p) for g in opt_state.param_groups for p in g["params"]}
        if owned != {id(params[n]) for n in names}:
            raise errors.ArgError(
                "opt_state was not built over these parameter tensors "
                "(init_opt_state(params))")
        if timings is None:
            return _step(params, opt_state, tokens, targets, names, _NO_LAPS)
        laps = hybrid.Laps(timings, params[names[0]].device, "step", world_rank)
        tally = monitoring.arm(c for c in (dp_comm, tp_comm, sp_comm) if c is not None)
        try:
            out = _step(params, opt_state, tokens, targets, names, laps)
        finally:
            monitoring.disarm(tally)
        spent = laps.close()
        timings["local"] = timings.get("local", 0.0) + sum(
            spent[p] for p in ("forward", "loss", "backward", "sync"))
        for key, value in (("coll_calls", tally.calls),
                           ("coll_bytes", tally.nbytes),
                           ("coll_host_s", tally.host_s)):
            timings[key] = timings.get(key, 0) + value
        return out

    def _step(params, opt_state, tokens, targets, names, laps):
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss_value = loss(leaves, tokens, targets, laps)
            with laps.phase("backward"):
                grads = torch.autograd.grad(loss_value, [leaves[n] for n in names])
        with laps.phase("sync"):
            synced, loss_value = _sync_grads(
                dict(zip(names, grads)), loss_value.detach(), dp_comm, tp_comm,
                sp_comm, dp, tp, sp, tp_replicated)
        if dcn_proc is not None and dcn_proc.size > 1:
            # the loss rides the gradients' float32 bucket: no extra round
            sync = (hybrid.dcn_grad_sync_sharded if dcn_sharded
                    else hybrid.dcn_grad_sync)
            bundle = sync(dcn_proc, {"grads": synced, "loss": loss_value.float()},
                          weight=dcn_weight, timings=timings)
            synced, loss_value = bundle["grads"], bundle["loss"]
            laps.restart()
        with laps.phase("optimizer"):
            for n in names:
                params[n].grad = synced[n].to(params[n].dtype)
            with torch.no_grad():
                opt_state.step()
            for n in names:
                params[n].grad = None
        return params, opt_state, loss_value

    return init_opt_state, step
