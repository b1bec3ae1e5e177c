"""The PyTorch port's slice-7 paths on the card: the Adam step, checkpoints
of CUDA tensors, and the device convertor.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
This file imports torch and the port only, never jax, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_devplane.py

- Two ``make_train_step_optax`` Adam steps on the kernel path against the
  plain path (``fused_ln=False, flash=False``) at a small width (vocab 512,
  d_model 256, 4 heads, d_ff 1024, 2 layers, seq 256, batch 4, bf16)
  through a one-rank NCCL communicator: the kernels launched 2L+1, 2L+1, L,
  L, L times a step, the losses within 2e-2 and each parameter's first
  moment (the running mean of the gradients each path computed) within
  2e-2 in relative Frobenius norm (``chip_smoke.py``'s tolerances for the
  training step: bf16 activations rounded at other places).  The update
  itself is not held to 2e-2: Adam moves an element by about +-lr whatever
  its gradient's size, so elements whose gradient is below the two paths'
  difference move in opposite directions (``chip_smoke.py``'s
  ``ADAM_UPDATE`` note).
- A ``Checkpointer`` save of CUDA tensors, updated in place on the card
  right after ``save`` returns: the files hold the values at ``save``, and
  ``restore`` places them back on the card.
- ``device_pack``/``device_unpack`` of a vector type on CUDA tensors (f32
  and bf16) equal to the host convertor's bytes.
- The OSU harness's device rows: ``bench_collective`` of each OSU op and
  every forced allreduce algorithm, and ``bench_device_probe``.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

SMALL = dict(vocab=512, d_model=256, n_heads=4, d_ff=1024, n_layers=2, seq=256)
LOSS_TOL = 2e-2
MOMENT_REL_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


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


def _np_params(cfg):
    rng = np.random.default_rng(0)
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    return {
        "embed": rng.standard_normal((V, D)).astype(np.float32) * 0.02,
        "wqkv": rng.standard_normal((L, D, 3, D)).astype(np.float32) * D ** -0.5,
        "wo": rng.standard_normal((L, D, D)).astype(np.float32) * D ** -0.5,
        "w1": rng.standard_normal((L, D, F)).astype(np.float32) * D ** -0.5,
        "w2": rng.standard_normal((L, F, D)).astype(np.float32) * F ** -0.5,
        "ln1": np.ones((L, D), np.float32), "ln2": np.ones((L, D), np.float32),
        "lnf": np.ones(D, np.float32)}


@pytest.mark.cuda
def test_adam_kernel_path_matches_plain_path(nccl_comm):
    from zhpe_ompi_tpu_torch.models import transformer as tt
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm

    cfg = tt.Config(**SMALL, dtype=torch.bfloat16, ce_chunk=256)
    L = cfg.n_layers
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, cfg.seq)), device="cuda")
    targets = torch.as_tensor(rng.integers(0, cfg.vocab, (4, cfg.seq)), device="cuda")
    p0 = tt.params_from_numpy(_np_params(cfg), cfg)
    counted = (fused_norm.ln_fwd, fused_norm.ln_bwd, fa.flash_fwd, fa.flash_bwd_dq,
               fa.flash_bwd_dkv)
    out = {}
    for kernels in (True, False):
        c = cfg if kernels else replace(cfg, fused_ln=False, flash=False)
        init, step, _ = tt.make_train_step_optax(c, nccl_comm, nccl_comm)
        params = {k: v.clone() for k, v in p0.items()}
        opt = init(params)
        losses = []
        for _ in range(2):
            for fn in counted:
                fn.launches = 0
            params, opt, loss = step(params, opt, tokens, targets)
            torch.cuda.synchronize()
            losses.append(float(loss))
            launches = [fn.launches for fn in counted]
            assert launches == ([2 * L + 1, 2 * L + 1, L, L, L] if kernels else [0] * 5)
        out[kernels] = (params, opt, losses)
    (pk, ok, lk), (pp, op, lp) = out[True], out[False]
    assert all(abs(a - b) <= LOSS_TOL for a, b in zip(lk, lp)), (lk, lp)
    for name in p0:
        mk, mp = ok.state[pk[name]]["exp_avg"], op.state[pp[name]]["exp_avg"]
        rel = float((mk - mp).norm() / mp.norm())
        assert rel <= MOMENT_REL_TOL, (name, rel)
        assert pk[name].dtype == torch.float32


@pytest.mark.cuda
def test_checkpoint_of_cuda_tensors(cuda, tmp_path):
    from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

    gen = torch.Generator(device="cuda").manual_seed(3)
    state = {"w": torch.randn((1024, 1024), generator=gen, device=cuda),
             "h": torch.randn(4096, generator=gen, device=cuda).bfloat16()}
    want = {k: v.clone() for k, v in state.items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    for v in state.values():
        v.mul_(3.0)  # an in-place update queued right after save returns
    ck.wait()
    got, step = ck.restore(placements="cuda")
    assert step == 1
    for k, v in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_pack_on_the_card(cuda, dtype):
    from zhpe_ompi_tpu_torch import datatype as dt
    from zhpe_ompi_tpu_torch.datatype import convertor

    base = dt.FLOAT if dtype == torch.float32 else dt.BFLOAT16
    vec = dt.create_resized(dt.create_vector(3, 2, 5, base), 0, 16 * base.size).commit()
    count = 1000
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(16 * count, generator=gen, device=cuda).to(dtype)
    packed = convertor.device_pack(x, vec, count)
    assert packed.device.type == "cuda"
    host_src = x.cpu()
    want = convertor.pack(host_src, vec, count)
    assert (packed.cpu().view(torch.uint8).numpy() == want).all()
    out = torch.zeros_like(x)
    assert convertor.device_unpack(packed, vec, count, out) is out
    host_out = torch.zeros_like(host_src)
    convertor.unpack(want, vec, count, out=host_out)
    assert torch.equal(out.cpu(), host_out)


@pytest.mark.cuda
def test_osu_device_rows_on_the_card(nccl_comm):
    """The OSU harness's device rows on the card (the one-rank NCCL group
    of ``nccl_comm`` adopted by ``runtime.init``): ``bench_collective`` of
    each OSU op in f32 and bf16 with the namesake's row keys and one-rank
    ``bytes``; every forced allreduce algorithm's top rung: at one rank
    each ``coll/algorithms`` allreduce returns its input itself (no
    device work), and ``xla`` (NCCL) a fresh tensor equal to it; and a
    probe row with no miss."""
    from zhpe_ompi_tpu_torch.benchmarks import osu_zmpi as osu
    from zhpe_ompi_tpu_torch.coll import tuned
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.runtime import init as rt

    keys = ["algorithm", "bandwidth_MBps", "bytes", "latency_us", "op"]
    try:
        world = rt.init()
        for dtype in (torch.float32, torch.bfloat16):
            for op in ("allreduce", "bcast", "allgather", "alltoall"):
                rows = osu.bench_collective(op, max_size=1 << 12, iters=3,
                                            dtype=dtype)
                assert [r["bytes"] for r in rows] == osu._sizes(1 << 12)
                assert all(sorted(r) == keys and r["latency_us"] > 0
                           for r in rows)
        for alg in tuned._ALG_TABLES["allreduce"]:
            rows = osu.bench_collective("allreduce", alg, max_size=1 << 12,
                                        iters=2)
            assert {r["algorithm"] for r in rows} == {alg}
            x = osu._rung(world, 1 << 12, torch.float32, "cuda")
            mca_var.set_var("coll_tuned_allreduce_algorithm", alg)
            try:
                got = osu._collective(world, "allreduce", x)()
            finally:
                mca_var.set_var("coll_tuned_allreduce_algorithm", "auto")
            if alg == "xla":
                assert got is not x and got.is_cuda and torch.equal(got, x)
            else:
                assert got is x, alg
        probe = osu.bench_device_probe(rounds=1)
        assert probe[0]["misses"] == probe[0]["device_faults"] == 0
    finally:
        rt.finalize()
