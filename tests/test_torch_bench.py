"""The port of ``bench.py``'s measurement (``zhpe_ompi_tpu_torch/bench.py``)
on the CPU.

- One step of the bench's plain step (raw ``dist.all_reduce`` in the f/g
  pair and in the written-out ``_sync_grads``) and one of the framework's
  ``make_train_step``, from the same parameters and batch, give the same
  loss and parameters bit for bit, with a one-rank tp communicator (the
  f/g pair's allreduces run) and without one.
- Both match the JAX single-device step (``jax.value_and_grad`` of
  ``loss_fn`` and ``p - lr * g``) to ``tests/test_torch_train.py``'s
  tolerance: rtol 2e-4, atol 2e-6, f32 on both sides.  Small config
  (vocab 256, d_model 128, 4 heads, d_ff 256, 2 layers, seq 64, batch 2),
  on the kernel path (the port's kernels' plain versions, chunked CE).
- The measurement's own code at that width (2 windows of 2 steps): the
  fields of ``bench.py``'s line, finite times and a pair ratio per window
  pair; the physics check raises on an impossible rate; the card table
  knows the H100 and disables ``mfu`` for an unknown name; the FLOP count
  is ``bench.py``'s.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

import bench as root_bench
from zhpe_ompi_tpu.models import transformer as jt
from zhpe_ompi_tpu_torch import bench
from zhpe_ompi_tpu_torch.models import transformer as tt

SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=64)
BATCH = 2
RTOL, ATOL = 2e-4, 2e-6


@functools.lru_cache(maxsize=None)
def _jax_step():
    cfg = jt.Config(**SMALL, dtype=jnp.float32, flash=True, fused_ln=True,
                    ce_chunk=64)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    targets = rng.integers(0, SMALL["vocab"], (BATCH, SMALL["seq"])).astype(np.int32)
    loss, grads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets), cfg)
    )(params)
    want = {k: np.asarray(params[k] - bench.LR * grads[k]) for k in params}
    return ({k: np.asarray(v) for k, v in params.items()}, tokens, targets,
            float(loss), want)


@pytest.fixture
def comms(tmp_path, monkeypatch):
    import zhpe_ompi_tpu_torch as zmpi

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        dp = zmpi.Communicator(name="dp")
        yield dp, dp.dup(name="tp")
    finally:
        dist.destroy_process_group()


def _cfg():
    return tt.Config(**SMALL, dtype=torch.float32, flash=True, fused_ln=True,
                     ce_chunk=64)


@pytest.mark.parametrize("with_tp", [True, False], ids=["tp1", "no-tp"])
def test_plain_and_framework_steps_agree_bitwise_and_with_jax(comms, with_tp):
    dp_comm, tp_comm = comms
    tp_comm = tp_comm if with_tp else None
    np_params, tokens, targets, jloss, want = _jax_step()
    cfg = _cfg()
    fw, _ = tt.make_train_step(cfg, dp_comm, tp_comm, lr=bench.LR)
    plain = bench.make_plain_step(cfg, dp_comm.pg,
                                  tp_comm.pg if tp_comm is not None else None,
                                  1, 1, lr=bench.LR)
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    new_fw, loss_fw = fw(params, tokens, targets)
    new_pl, loss_pl = plain(params, tokens, targets)
    assert torch.equal(loss_fw, loss_pl)
    for name in want:
        assert torch.equal(new_fw[name], new_pl[name]), name
    np.testing.assert_allclose(float(loss_pl), jloss, rtol=RTOL, atol=ATOL)
    for name, arr in want.items():
        np.testing.assert_allclose(new_pl[name].numpy(), arr, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_raw_comm_sums_only(comms):
    import zhpe_ompi_tpu_torch as zmpi

    raw = bench.RawComm(comms[0].pg)
    assert raw.allreduce(torch.ones(2), zmpi.SUM).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        raw.allreduce(torch.ones(2), zmpi.MAX)


def test_measurement_runs_at_a_tiny_width(comms):
    dp_comm, tp_comm = comms
    peak, known = bench.card_peak("cpu")
    got = bench.measure_pair(_cfg(), dp_comm, tp_comm, BATCH, peak, known,
                             iters=2, windows=2)
    for key in ("value", "vs_baseline", "step_ms", "plain_step_ms", "mfu",
                "flops_per_step"):
        assert math.isfinite(got[key]), key
    assert got["mfu"] == 0.0 and len(got["pair_ratios"]) == 2
    assert len(got["window_ms"]) == len(got["plain_window_ms"]) == 2
    assert got["last_loss"] == got["plain_last_loss"]
    lc = bench.measure_long_context(_cfg(), dp_comm, tp_comm, BATCH, peak,
                                    known, iters=1, windows=1)
    assert lc["long_ctx_seq"] == SMALL["seq"] and lc["long_ctx_step_ms"] > 0


def test_physics_check_and_card_table():
    with pytest.raises(RuntimeError, match="timing sync"):
        bench._check_physics(10**18, 1e-3, 989e12)
    assert bench._check_physics(10**9, 1e-3, 989e12) == 1e-3
    assert bench.card_peak("NVIDIA H100 80GB HBM3") == (989e12, True)
    assert bench.card_peak("NVIDIA H100 PCIe") == (756e12, True)
    assert bench.card_peak("Some Other Card") == (bench._UNKNOWN_PEAK, False)


def test_flop_count_is_bench_pys():
    for cfg in (tt.Config(**bench.HEADLINE), tt.Config(**SMALL)):
        for batch in (2, 16):
            assert (bench._train_flops_per_step(cfg, batch)
                    == root_bench._train_flops_per_step(cfg, batch))
