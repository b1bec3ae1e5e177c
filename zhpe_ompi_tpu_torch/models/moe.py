"""Mixture-of-Experts layer: expert parallelism over the framework's
alltoall (namesake: ``zhpe_ompi_tpu/models/moe.py``).

Top-1 switch routing with static capacity: each rank hosts one expert;
a token beyond its expert's capacity (per source rank) is dropped and its
output is zero (the residual carries it).  Both ep transposes go through
``comm.alltoall``, so ``--mca coll`` selection and monitoring apply to the
model's hot path.  :func:`moe_ffn` is differentiable: the backward of each
transpose is the alltoall of the cotangent (the transpose of an alltoall
is itself), as JAX differentiates through ``all_to_all``.

:func:`moe_host_ffn` is the same layer over the host plane's alltoall
(a ``RankContext`` or ``TcpProc`` endpoint).  ``init_moe_params`` draws
from the JAX PRNG; the port takes its numpy arrays through
:func:`moe_params_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import errors


def moe_params_from_numpy(np_params: dict, device=None, ep_rank: int | None = None
                          ) -> dict:
    """Carry ``init_moe_params``'s arrays across (``router`` (D, E),
    ``w_in`` (E, D, F), ``w_out`` (E, F, D), float32).  With ``ep_rank``,
    the expert weights are sliced to that rank's expert, (1, D, F) and
    (1, F, D), as the JAX package shards them over the ep axis."""
    from .transformer import _device

    dev = _device(device)
    out = {}
    for name, arr in np_params.items():
        a = np.asarray(arr, dtype=np.float32)
        if ep_rank is not None and name in ("w_in", "w_out"):
            if not 0 <= ep_rank < a.shape[0]:
                raise errors.ArgError(
                    f"ep_rank {ep_rank} out of range [0, {a.shape[0]})")
            a = a[ep_rank:ep_rank + 1]
        out[name] = torch.tensor(a, device=dev)
    return out


class _Alltoall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.alltoall(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.alltoall(ct.contiguous()), None


def moe_ffn(comm, params, x, capacity_factor: float = 1.25):
    """Expert-parallel FFN: ``x`` is this rank's (T_local, D) tokens; the
    rank holds its expert's ``w_in``/``w_out`` of shape (1, D, F)/(1, F, D)
    and the replicated ``router`` (D, E).  Returns ``(y, keep)``: y is
    (T_local, D), zero for dropped tokens, and keep marks the tokens that
    found room."""
    n = comm.size  # == number of experts
    T, D = x.shape
    cap = max(1, int(capacity_factor * T / n))

    probs = torch.softmax(x.float() @ params["router"], dim=-1)  # (T, E)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    # position of each token within its expert's capacity buffer, first
    # come, first served
    onehot = F.one_hot(expert, n)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    keep = pos < cap

    # scatter the tokens into the (E, cap, D) dispatch buffer; the dropped
    # ones go to a spare row that is cut off (no device-to-host sync)
    slot = torch.where(keep, expert * cap + pos, n * cap)
    buf = x.new_zeros((n * cap + 1, D)).index_copy(0, slot, x)[:n * cap]

    # ep transpose #1: expert e's buffer goes to rank e
    dispatched = _Alltoall.apply(buf, comm).reshape(n, cap, D)

    h = F.gelu(dispatched.float() @ params["w_in"][0], approximate="tanh")
    out = (h @ params["w_out"][0]).to(x.dtype)  # (n, cap, D)

    # ep transpose #2: results go back to their source ranks
    returned = _Alltoall.apply(out.reshape(n * cap, D), comm)

    y = returned.index_select(0, slot.clamp(0, n * cap - 1))
    y = torch.where(keep[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y * gate[:, None].to(y.dtype), keep


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def moe_host_ffn(ep, params, x, capacity_factor: float = 1.25,
                 timings: dict | None = None):
    """:func:`moe_ffn` on the HOST plane: the same top-1 routing and
    static-capacity math, but both ep transposes ride the host endpoint's
    ``alltoall`` (``coll/host.py``), the serving plane's expert-dispatch
    path.  ``ep`` is any host endpoint carrying ``HostCollectives`` (a
    ``RankContext``, a ``TcpProc``); one expert per rank.  Returns
    ``(y, keep)`` exactly like :func:`moe_ffn`.

    The router, the capacity math and the expert products run on ``x``'s
    device.  The host plane moves host payloads, so the dispatch buffer is
    staged explicitly with one ``.cpu()`` (its per-expert rows go out as
    views of that copy, where the namesake makes ``np.asarray`` blocks),
    and each received block is copied back with ``.to(x.device)``.  The
    coll layer routes the alltoall through the hierarchical han schedule
    (``coll/han.py``: intra-host gather over the shared-memory rings, one
    aggregated leader exchange per host pair, intra-host scatter) when the
    topology qualifies, and through the flat pairwise exchange otherwise.

    ``timings``, when given a dict, accumulates this call's host seconds
    per phase — ``"route"``, ``"d2h"``, ``"alltoall"`` (both transposes),
    ``"h2d"``, ``"expert"`` and ``"combine"`` — synchronizing the device
    at each phase boundary (so the phases do not overlap while timed), and
    ``"expert_device"``, the expert products' device seconds from CUDA
    events (on a CUDA ``x`` only)."""
    import time

    dev = x.device
    clock = [time.perf_counter()]

    def mark(phase: str) -> None:
        if timings is None:
            return
        _sync(dev)
        now = time.perf_counter()
        timings[phase] = timings.get(phase, 0.0) + now - clock[0]
        clock[0] = now

    if timings is not None:
        _sync(dev)
        clock[0] = time.perf_counter()
    n = ep.size
    T, D = x.shape
    cap = max(1, int(capacity_factor * T / n))

    probs = torch.softmax(x.float() @ params["router"], dim=-1)  # (T, E)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    keep = pos < cap
    slot = torch.where(keep, expert * cap + pos, n * cap)
    buf = x.new_zeros((n * cap + 1, D)).index_copy(0, slot, x)[:n * cap]
    mark("route")

    # ep transpose #1 on the host plane: one rank-indexed block per
    # destination expert, rows of one explicit host copy
    staged = buf.reshape(n, cap, D).cpu()
    mark("d2h")
    dispatched = ep.alltoall([staged[e] for e in range(n)])
    mark("alltoall")
    blocks = torch.empty((n, cap, D), dtype=x.dtype, device=dev)
    for s, blk in enumerate(dispatched):
        blocks[s].copy_(torch.as_tensor(blk))
    mark("h2d")

    if timings is not None and dev.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    h = F.gelu(blocks.float() @ params["w_in"][0], approximate="tanh")
    out = (h @ params["w_out"][0]).to(x.dtype)  # (n, cap, D)
    if timings is not None and dev.type == "cuda":
        ev1.record()
    mark("expert")
    if timings is not None and dev.type == "cuda":
        timings["expert_device"] = timings.get("expert_device", 0.0) \
            + ev0.elapsed_time(ev1) / 1e3

    # ep transpose #2: results ride back to their source ranks
    out_host = out.cpu()
    mark("d2h")
    returned = ep.alltoall([out_host[s] for s in range(n)])
    mark("alltoall")
    flat = torch.empty((n, cap, D), dtype=x.dtype, device=dev)
    for s, blk in enumerate(returned):
        flat[s].copy_(torch.as_tensor(blk))
    mark("h2d")

    y = flat.reshape(n * cap, D).index_select(0, slot.clamp(0, n * cap - 1))
    y = torch.where(keep[:, None], y,
                    torch.zeros((), dtype=y.dtype, device=dev))
    y = y * gate[:, None].to(y.dtype)
    mark("combine")
    return y, keep


def moe_reference_dense(params, x_all, n_experts: int, capacity: int,
                        block_tokens: int | None = None):
    """Single-device reference: the same routing and capacity semantics as
    :func:`moe_ffn`, no communication.  ``capacity`` is per (source block,
    expert) and ``block_tokens`` the per-rank token count (default: all of
    ``x_all`` is one block); dropped tokens give zeros.  ``params`` holds
    every expert's weights."""
    T, D = x_all.shape
    bt = block_tokens or T
    probs = torch.softmax(x_all.float() @ params["router"], dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    blocks = F.one_hot(expert, n_experts).reshape(T // bt, bt, n_experts)
    pos = ((torch.cumsum(blocks, dim=1) - 1) * blocks).sum(-1)
    keep = (pos < capacity).reshape(T)
    out = torch.zeros((T, D), dtype=torch.float32, device=x_all.device)
    for e in range(n_experts):
        h = F.gelu(x_all.float() @ params["w_in"][e], approximate="tanh")
        out = torch.where((expert == e)[:, None], h @ params["w_out"][e], out)
    return out * gate[:, None] * keep[:, None]
