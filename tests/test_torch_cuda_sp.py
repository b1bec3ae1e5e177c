"""The PyTorch port's slice-5 paths on the card: remat and the SPMD plane.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
This file imports torch and the port only, never jax, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_sp.py

- One ``make_train_step`` step with ``remat=True`` against the step without
  it, at a small width (vocab 512, d_model 256, 4 heads, d_ff 1024, 2
  layers, seq 256, batch 4, bf16) through one-rank NCCL communicators: the
  same loss bits (the forward is the same computation), every update
  within 1e-3 in relative Frobenius norm (the backward sums in another
  order), the forward kernels launched 2L+1 + 2L and L + L times.
- ``shift`` and ``ppermute`` at size 1 on CUDA tensors: a copy (or zeros
  for a non-wrapping shift) on the same device, with no NCCL call, and
  the gradient passes through.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

SMALL = dict(vocab=512, d_model=256, n_heads=4, d_ff=1024, n_layers=2, seq=256)


@pytest.fixture(scope="module")
def nccl_comm(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    import zhpe_ompi_tpu_torch as zmpi

    torch.cuda.set_device(0)
    store = os.path.join(tmp_path_factory.mktemp("nccl"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        yield zmpi.Communicator(name="one")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_remat_step_matches_step_without_remat(nccl_comm):
    from zhpe_ompi_tpu_torch.models import transformer as tt
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm

    cfg = tt.Config(**SMALL, dtype=torch.bfloat16, ce_chunk=256)
    rng = np.random.default_rng(0)
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    np_params = {
        "embed": rng.standard_normal((V, D)).astype(np.float32) * 0.02,
        "wqkv": rng.standard_normal((L, D, 3, D)).astype(np.float32) * D ** -0.5,
        "wo": rng.standard_normal((L, D, D)).astype(np.float32) * D ** -0.5,
        "w1": rng.standard_normal((L, D, F)).astype(np.float32) * D ** -0.5,
        "w2": rng.standard_normal((L, F, D)).astype(np.float32) * F ** -0.5,
        "ln1": np.ones((L, D), np.float32), "ln2": np.ones((L, D), np.float32),
        "lnf": np.ones(D, np.float32)}
    tokens = torch.as_tensor(rng.integers(0, V, (4, cfg.seq)), device="cuda")
    targets = torch.as_tensor(rng.integers(0, V, (4, cfg.seq)), device="cuda")
    params = tt.params_from_numpy(np_params, cfg)
    out = {}
    for remat in (False, True):
        step, _ = tt.make_train_step(replace(cfg, remat=remat), nccl_comm,
                                     nccl_comm, lr=0.1)
        fused_norm.ln_fwd.launches = fa.flash_fwd.launches = 0
        new, loss = step(params, tokens, targets)
        torch.cuda.synchronize()
        out[remat] = (new, float(loss), fused_norm.ln_fwd.launches,
                      fa.flash_fwd.launches)
    (pa, la, ln_a, fl_a), (pb, lb, ln_b, fl_b) = out[False], out[True]
    assert la == lb
    assert (ln_a, fl_a) == (2 * L + 1, L)
    assert (ln_b, fl_b) == (4 * L + 1, 2 * L)
    for name, p0 in params.items():
        rel = float((pb[name] - pa[name]).norm() / (pa[name] - p0).norm())
        assert rel <= 1e-3, (name, rel)


@pytest.mark.cuda
def test_shift_and_ppermute_at_size_one_on_cuda(nccl_comm, monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: calls.append(ops) or [])
    x = torch.arange(24.0, device="cuda").reshape(4, 6)[:, ::2]
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        t = x.to(dtype)
        y = nccl_comm.shift(t, 1)
        assert y.device == t.device and torch.equal(y, t)
        assert y.data_ptr() != t.data_ptr()
        assert torch.equal(nccl_comm.ppermute(t, [(0, 0)]), t)
        assert torch.equal(nccl_comm.permute(t, [0]), t)
        z = nccl_comm.shift(t, 1, wrap=False)
        assert z.device == t.device and not z.any()
    g = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(nccl_comm.shift(g, 1).sum(), g)
    assert torch.equal(grad, torch.ones_like(x))
    assert calls == []
