"""The framework's training step against the same step with raw
collectives (the port of root ``bench.py``'s measurement, ``:144-404``).

Run on a machine with NVIDIA GPUs, one process per GPU::

    python3 -m zhpe_ompi_tpu_torch.bench            # one GPU
    torchrun --nproc-per-node N -m zhpe_ompi_tpu_torch.bench

It prints one JSON line.  The framework path is
``models/transformer.make_train_step`` over ``dp_comm`` and ``tp_comm``
(framework communicators over a dp x tp mesh, tp = 2 when the world is
even, else 1).  The plain path is the same step with every framework
collective replaced by ``dist.all_reduce`` on the same process group:
:class:`RawComm` stands in for ``tp_comm`` in ``loss_fn`` (the f/g pair),
and :func:`make_plain_step` writes ``_sync_grads`` out.  Both run the same
``loss_fn``, the same division by dp and tp and the same SGD cast, so the
two steps compute the same bits; ``vs_baseline`` (plain time / framework
time) is the framework's own cost, and below 1 when it costs time.  Unlike
``bench.py``, a tp group of one rank is still passed, so the step carries
the f/g pair's allreduces (30 framework collectives per step at 4 layers).

Width: ``bench.py:180-184`` (vocab 8192, d_model 1024, 16 heads, d_ff 4096,
4 layers, seq 512, bf16, ce_chunk 1024, batch 16 per dp rank), with
``remat=True`` (``bench.py:172``) and with ``remat=False``; then the
long-context configuration (``bench.py:345-402``: seq 4096, batch 2 per dp
rank, remat).  Weights are random, drawn with numpy in the JAX package's
``init_params`` layout and scales from seed 0 (1 for the long context), as
``bench.py``'s PRNG keys are.

Timing discipline (``bench.py:211-330``): each path warms up with 4 steps,
then one discarded burn-in window per path, then 4 alternating windows of
12 steps (framework first in even windows, plain first in odd ones); each
window ends with a host fetch of the last loss, which is checked finite;
times are the windows' medians and ``vs_baseline`` the median of the
adjacent-pair ratios.  The implied FLOP rate (``_train_flops_per_step``)
of every path's fastest window must stay below the card's dense bf16 peak,
chosen by the name ``nvidia-smi`` prints; an unknown name disables ``mfu``
(reported 0.0) and keeps a generous ceiling for the check.

Not carried over: ``_best_sweep_config`` (it reads TPU sweep results) and
the CPU fallback of ``bench.py``'s supervisor: the port has no fallback that
hides the device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

# Dense bf16 tensor-core peak per card (NVIDIA data sheets), by a substring
# of the name nvidia-smi prints; the first match wins.
_PEAK_BF16 = (
    ("h100 pcie", 756e12), ("h100 nvl", 835e12), ("h100", 989e12),
    ("h200", 989e12), ("h800", 989e12),
)
# Unknown card: a generous but finite ceiling, so the broken-sync guard
# still trips on dispatch-rate nonsense while never aborting a legitimate
# run on another card.
_UNKNOWN_PEAK = 2000e12

HEADLINE = dict(vocab=8192, d_model=1024, n_heads=16, d_ff=4096, n_layers=4,
                seq=512)
BATCH = 16
CE_CHUNK = 1024
ITERS = 12
WINDOWS = 4
LONG_CONTEXT = dict(seq=4096, batch=2, iters=8, windows=3)
LR = 1e-2
SEED = 0
LONG_CONTEXT_SEED = 1


def card_name(index: int = 0) -> str:
    """The card's name as ``nvidia-smi`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def card_peak(name: str) -> tuple[float, bool]:
    """(dense bf16 peak FLOP/s, known) for a card name."""
    low = name.lower()
    for key, peak in _PEAK_BF16:
        if key in low:
            return peak, True
    return _UNKNOWN_PEAK, False


def _train_flops_per_step(cfg, batch) -> int:
    """Approximate training FLOPs per step: 6 * n_matmul_params * tokens
    (fwd 2x + bwd 4x) plus the attention quadratic term
    12 * L * B * S^2 * D (QK^T and PV matmuls, fwd+bwd)."""
    d, f, v, L, s = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers, cfg.seq
    matmul_params = L * (4 * d * d + 2 * d * f) + v * d  # qkv+o, ffn, unembed
    tokens = batch * s
    return 6 * matmul_params * tokens + 12 * L * batch * s * s * d


def numpy_params(cfg, seed: int) -> dict:
    """Parameters in the JAX package's ``init_params`` layout and scales,
    drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    D, H, Fd, V, L = cfg.d_model, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers

    def nrm(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    return {
        "embed": nrm((V, D), 0.02),
        "wqkv": nrm((L, D, 3, H), D ** -0.5),
        "wo": nrm((L, H, D), H ** -0.5),
        "w1": nrm((L, D, Fd), D ** -0.5),
        "w2": nrm((L, Fd, D), Fd ** -0.5),
        "ln1": np.ones((L, D), np.float32),
        "ln2": np.ones((L, D), np.float32),
        "lnf": np.ones((D,), np.float32),
    }


def _all_reduce(x, pg):
    out = x.clone()
    dist.all_reduce(out, group=pg)
    return out


class RawComm:
    """``tp_comm``'s stand-in in the plain step: ``allreduce`` is one
    ``dist.all_reduce`` (sum) on the process group, nothing else."""

    def __init__(self, pg):
        self.pg = pg

    def allreduce(self, x, op=None):
        if op is not None and op.name != "MPI_SUM":
            raise ValueError(f"RawComm reduces sums only, not {op.name}")
        return _all_reduce(x, self.pg)


def make_plain_step(cfg, dp_pg, tp_pg, dp: int, tp: int, lr: float = LR):
    """``make_train_step``'s step with raw collectives: the same
    ``loss_fn`` (its f/g pair over :class:`RawComm`), ``_sync_grads``
    written out with ``dist.all_reduce`` (dp-mean every gradient, tp-mean
    the tp-replicated ones, the loss over dp then tp), and the same SGD
    update in each parameter's dtype.  ``tp_pg`` None runs without tp."""
    from .models import transformer as tfm

    raw_tp = RawComm(tp_pg) if tp_pg is not None else None
    replicated = tfm._TP_REPLICATED

    def step(params, tokens, targets):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = tfm.loss_fn(leaves, tokens, targets, cfg, raw_tp)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        synced = {}
        for name, g in zip(names, grads):
            g = _all_reduce(g, dp_pg) / dp
            if name in replicated and raw_tp is not None:
                g = _all_reduce(g, tp_pg) / tp
            synced[name] = g
        loss = _all_reduce(loss.detach(), dp_pg) / dp
        if raw_tp is not None:
            loss = _all_reduce(loss, tp_pg) / tp
        with torch.no_grad():
            new_params = {n: (params[n] - lr * synced[n]).to(params[n].dtype)
                          for n in names}
        return new_params, loss

    return step


def _window(st, iters: int) -> None:
    """``iters`` steps, then a host fetch of the last loss: the steps form
    a dependency chain (the parameters thread through), so the fetch bounds
    the whole window.  A non-finite loss raises."""
    step, tok, tgt, ps = st["step"], st["tok"], st["tgt"], st["ps"]
    t0 = time.perf_counter()
    for _ in range(iters):
        ps, loss = step(ps, tok, tgt)
    lval = float(loss)
    st["times"].append((time.perf_counter() - t0) / iters)
    st["ps"] = ps
    st["loss"] = lval
    # raise (not assert): this guard must survive python -O
    if not math.isfinite(lval):
        raise RuntimeError(f"non-finite loss {lval}")


def _prep(step, params, tok, tgt) -> dict:
    ps, loss = step(params, tok, tgt)
    for _ in range(3):
        ps, loss = step(ps, tok, tgt)
    float(loss)
    return {"step": step, "ps": ps, "tok": tok, "tgt": tgt, "times": []}


def _check_physics(flops: int, seconds: float, peak: float) -> float:
    implied = flops / seconds
    if implied >= peak:
        raise RuntimeError(
            f"implied {implied / 1e12:.1f} TFLOP/s exceeds the card's peak "
            f"{peak / 1e12:.1f}: timing sync is broken")
    return seconds


def _rank_inputs(cfg, dp_comm, tp_comm, batch: int, seed: int):
    """This rank's tp shards of the parameters drawn from ``seed``, and its
    dp rows of a batch of tokens and targets drawn from ``seed + 2``."""
    from .models import transformer as tfm

    device, dp = dp_comm.device, dp_comm.size
    tp, tp_rank = (tp_comm.size, tp_comm.rank) if tp_comm is not None else (1, 0)
    params = tfm.params_from_numpy(numpy_params(cfg, seed), cfg, device=device,
                                   tp_rank=tp_rank, tp=tp)
    rng = np.random.default_rng(seed + 2)
    rows = slice(dp_comm.rank * (batch // dp), (dp_comm.rank + 1) * (batch // dp))
    tok, tgt = (torch.as_tensor(rng.integers(0, cfg.vocab, (batch, cfg.seq))[rows],
                                device=device) for _ in range(2))
    return params, tok, tgt


def measure_pair(cfg, dp_comm, tp_comm, batch: int, peak: float,
                 kind_known: bool, iters: int = ITERS,
                 windows: int = WINDOWS) -> dict:
    """Framework step against plain step on the same parameters and batch:
    burn-in, ``windows`` alternating windows of ``iters`` steps, medians and
    the median pair ratio, as ``bench.py`` measures them."""
    from .models import transformer as tfm

    dp, tp = dp_comm.size, tp_comm.size if tp_comm is not None else 1
    params, tok, tgt = _rank_inputs(cfg, dp_comm, tp_comm, batch, SEED)
    step_fw, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=LR)
    step_pl = make_plain_step(cfg, dp_comm.pg,
                              tp_comm.pg if tp_comm is not None else None,
                              dp, tp, lr=LR)
    st_fw = _prep(step_fw, params, tok, tgt)
    st_pl = _prep(step_pl, params, tok, tgt)
    del params
    # burn-in: one discarded window per path
    _window(st_fw, iters)
    _window(st_pl, iters)
    st_fw["times"].clear()
    st_pl["times"].clear()
    ratios = []
    for i in range(windows):
        first, second = (st_fw, st_pl) if i % 2 == 0 else (st_pl, st_fw)
        _window(first, iters)
        _window(second, iters)
        ratios.append(st_pl["times"][-1] / st_fw["times"][-1])
    flops = _train_flops_per_step(cfg, batch)
    _check_physics(flops, min(st_fw["times"]), peak)
    _check_physics(flops, min(st_pl["times"]), peak)
    fw_s = float(np.median(st_fw["times"]))
    pl_s = float(np.median(st_pl["times"]))
    return {
        "value": batch * cfg.seq / fw_s,
        "vs_baseline": float(np.median(ratios)),
        "step_ms": fw_s * 1e3,
        "plain_step_ms": pl_s * 1e3,
        "plain_tokens_per_s": batch * cfg.seq / pl_s,
        "mfu": (flops / fw_s) / peak if kind_known else 0.0,
        "flops_per_step": flops,
        "window_ms": [t * 1e3 for t in st_fw["times"]],
        "plain_window_ms": [t * 1e3 for t in st_pl["times"]],
        "pair_ratios": ratios,
        "last_loss": st_fw["loss"],
        "plain_last_loss": st_pl["loss"],
    }


def measure_long_context(cfg, dp_comm, tp_comm, batch: int, peak: float,
                         kind_known: bool, iters: int, windows: int) -> dict:
    """The framework step alone at the long-context configuration: two
    warm-up steps, then ``windows`` windows of ``iters`` steps, median."""
    from .models import transformer as tfm

    params, tok, tgt = _rank_inputs(cfg, dp_comm, tp_comm, batch,
                                    LONG_CONTEXT_SEED)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=LR)
    ps, loss = step(params, tok, tgt)
    ps, loss = step(ps, tok, tgt)
    float(loss)
    del params
    st = {"step": step, "ps": ps, "tok": tok, "tgt": tgt, "times": []}
    for _ in range(windows):
        _window(st, iters)
    flops = _train_flops_per_step(cfg, batch)
    _check_physics(flops, min(st["times"]), peak)
    best = float(np.median(st["times"]))
    return {
        "long_ctx_seq": cfg.seq,
        "long_ctx_tokens_per_s": batch * cfg.seq / best,
        "long_ctx_step_ms": best * 1e3,
        "long_ctx_mfu": (flops / best) / peak if kind_known else 0.0,
    }


def run(dp_comm, tp_comm, peak: float, kind_known: bool) -> dict:
    """The whole measurement on communicators the caller made: remat on
    (the result's top-level fields, ``bench.py``'s configuration), remat
    off (``remat_off``), then the long-context line's fields.  ``peak`` is
    one card's; the job's is that times the dp x tp ranks."""
    from .models import transformer as tfm

    dp = dp_comm.size
    peak = peak * dp * (tp_comm.size if tp_comm is not None else 1)
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    on = measure_pair(replace(cfg, remat=True), dp_comm, tp_comm, BATCH * dp,
                      peak, kind_known)
    off = measure_pair(cfg, dp_comm, tp_comm, BATCH * dp, peak, kind_known)
    result = {"metric": "train_step_throughput", "unit": "tokens/s",
              "remat": True, **on, "remat_off": off}
    lc = LONG_CONTEXT
    lc_cfg = replace(cfg, seq=lc["seq"], remat=True)
    result.update(measure_long_context(
        lc_cfg, dp_comm, tp_comm, lc["batch"] * dp, peak, kind_known,
        lc["iters"], lc["windows"]))
    return result


def mesh_comms():
    """dp x tp communicators over the world of ``runtime.init()``, tp = 2
    when the world is even (``bench.py``'s layout), each over its
    ``make_mesh`` group."""
    from .comm.communicator import Communicator
    from .parallel import mesh as mesh_mod
    from .runtime import init as rt

    world = rt.world()
    tp = 2 if world.size % 2 == 0 else 1
    mesh = mesh_mod.make_mesh({"dp": world.size // tp, "tp": tp})
    return (Communicator(mesh.get_group("dp"), name="bench_dp"),
            Communicator(mesh.get_group("tp"), name="bench_tp"))


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    from .runtime import init as rt

    rt.init()
    try:
        dp_comm, tp_comm = mesh_comms()
        name = card_name(torch.cuda.current_device())
        peak, known = card_peak(name)
        if not known:
            print(f"warning: unknown card {name!r}; mfu disabled, physics "
                  f"ceiling {peak / 1e12:.0f} TFLOP/s", file=sys.stderr)
        result = run(dp_comm, tp_comm, peak, known)
        result["card"] = name
        if rt.world().rank == 0:
            print(json.dumps(result))
    finally:
        rt.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
