"""``Config.remat`` of the PyTorch port's transformer.

Each layer runs under ``torch.utils.checkpoint`` with a selective policy
that keeps the outputs of ``aten.mm`` (the four projections) and
recomputes the rest in the backward, the counterpart of the JAX package's
``dots_with_no_batch_dims_saveable``.  On the CPU, through a one-rank gloo
``Communicator`` as ``tp_comm`` (so the tp allreduces run, and are
recomputed, under the policy):

- loss and gradients equal the non-remat ones (rtol 1e-6 on the loss,
  rtol 1e-5 / atol 1e-6 on the gradients, as ``tests/test_model.py``
  holds the JAX package's remat), on the kernel path (the kernels' plain
  versions, chunked loss) and on the reference path;
- a dispatch-mode count over the backward sees as many ``aten.mm`` calls
  with remat as without: no projection is recomputed;
- the layernorm forward runs 2L more times and the flash forward L more
  times per step (the recomputed layers), and the backward kernels as
  often as without remat;
- one ``make_train_step`` step with remat gives the non-remat step's loss
  and parameters.

Remat across ranks (tp and sp collectives recomputed in the backward) is
held in ``tests/test_torch_sp_train.py``.
"""

import os
from dataclasses import replace

import numpy as np
import pytest

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from zhpe_ompi_tpu_torch.models import transformer as tt
from zhpe_ompi_tpu_torch.ops import flash_attention as fa
from zhpe_ompi_tpu_torch.ops import fused_norm

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=16)
PATHS = [pytest.param(True, 32, id="kernel-chunked"),
         pytest.param(False, None, id="reference")]


@pytest.fixture
def tp_comm(tmp_path, monkeypatch):
    import zhpe_ompi_tpu_torch as zmpi

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        yield zmpi.Communicator(name="tp")
    finally:
        dist.destroy_process_group()


def _inputs(cfg):
    rng = np.random.default_rng(3)
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers

    def nrm(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"embed": nrm((V, D), 0.02), "wqkv": nrm((L, D, 3, D), D ** -0.5),
              "wo": nrm((L, D, D), D ** -0.5), "w1": nrm((L, D, F), D ** -0.5),
              "w2": nrm((L, F, D), F ** -0.5),
              "ln1": 1 + nrm((L, D), 0.1), "ln2": 1 + nrm((L, D), 0.1),
              "lnf": 1 + nrm((D,), 0.1)}
    tokens = rng.integers(0, V, (2, cfg.seq))
    targets = rng.integers(0, V, (2, cfg.seq))
    return params, tokens, targets


class _CountMm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, tp_comm):
    np_params, tokens, targets = _inputs(cfg)
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    leaves = [p.requires_grad_(True) for p in params.values()]
    loss = tt.loss_fn(params, tokens, targets, cfg, tp_comm=tp_comm)
    with _CountMm() as counter:
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads], counter.mm


@pytest.mark.parametrize("path,ce_chunk", PATHS)
def test_remat_matches_no_remat(tp_comm, path, ce_chunk):
    cfg = tt.Config(**SMALL, dtype=torch.float32, flash=path, fused_ln=path,
                    ce_chunk=ce_chunk)
    la, ga, mm_a = _loss_and_grads(cfg, tp_comm)
    lb, gb, mm_b = _loss_and_grads(replace(cfg, remat=True), tp_comm)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the projections' outputs are kept: the backward runs no extra mm
    assert mm_a == mm_b and mm_a > 0


def test_remat_recomputes_each_layer_once(tp_comm, monkeypatch):
    counts = {}

    def counting(name, fn):
        def wrapped(*args):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args)
        return wrapped

    for mod, name in ((fused_norm, "ln_fwd"), (fused_norm, "ln_bwd"),
                      (fa, "flash_fwd"), (fa, "flash_bwd")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    cfg = tt.Config(**SMALL, dtype=torch.float32, flash=True, fused_ln=True,
                    ce_chunk=32)
    L = cfg.n_layers
    per_step = {}
    for remat in (False, True):
        counts.clear()
        _loss_and_grads(replace(cfg, remat=remat), tp_comm)
        per_step[remat] = dict(counts)
    assert per_step[False] == {"ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1,
                               "flash_fwd": L, "flash_bwd": L}
    assert per_step[True] == {"ln_fwd": 4 * L + 1, "ln_bwd": 2 * L + 1,
                              "flash_fwd": 2 * L, "flash_bwd": L}


def test_remat_train_step_matches(tp_comm):
    cfg = tt.Config(**SMALL, dtype=torch.float32, flash=True, fused_ln=True,
                    ce_chunk=32)
    np_params, tokens, targets = _inputs(cfg)
    results = []
    for remat in (False, True):
        c = replace(cfg, remat=remat)
        step, _ = tt.make_train_step(c, tp_comm, tp_comm, lr=0.05)
        results.append(step(tt.params_from_numpy(np_params, c, device="cpu"),
                            tokens, targets))
    (pa, la), (pb, lb) = results
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    for name in pa:
        np.testing.assert_allclose(pa[name].numpy(), pb[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
