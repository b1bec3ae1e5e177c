#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (``zhpe_ompi_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Print the card's name and power limit, as nvidia-smi reports them.
2. Build every kernel of the main path from ``zhpe_ompi_tpu_torch/csrc``
   (one ``nvcc`` per source, started together) and time the build.
3. Hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (layernorm forward and backward 8192 x 1024 bf16;
   flash attention forward, dq and dk/dv (16, 512, 16, 64) bf16 causal),
   plus ragged and strided shapes and the flash kernels' edges (a 4096-long
   sequence, causal and not, whose ring phases wrap many times; S = 192,
   not a multiple of their 128-row blocks), check that dq (with delta) and
   dk/dv each give the same bits twice, and time kernel, plain version and the
   PyTorch library call that computes the same function (``F.layer_norm``,
   ``aten.native_layer_norm_backward``, ``F.scaled_dot_product_attention``
   and its autograd backward; timed as a yardstick only, never used by the
   port).  Then the host µs per call of the flash forward, dq and dk/dv
   wrappers (checks, tensor maps, launch) at the headline shape.
4. Hold the ring attention's block recurrence at (16, 512, 16, 64) bf16
   causal, the sequence cut into 4 blocks: for each virtual rank, the
   port's ``_chunk_attn`` over the blocks in the order the ring delivers
   them, then the normalisation, against ``_block_attention_single`` on
   the whole sequence (max abs error within 2e-2); the same with the
   zigzag layout's live sub-blocks; the time per rank of each.
5. The MPI entry point, at phase 7's flagship width, before any
   process group is made and before any profiler session runs:
   ``runtime.init()`` (timed) must give a one-rank NCCL COMM_WORLD and COMM_SELF and print the comm_method hook's lines (the
   world's layout and tuned over every operation); ``make_mesh({"dp": 1,
   "tp": 1, "sp": 1})`` then gives ``dp_comm`` from its dp group,
   ``tp_comm`` from ``world.split`` and ``sp_comm`` from a ``dup`` of its
   sp group.  With ``coll_monitoring_enable`` set, ``make_train_step``
   over ``dp_comm`` and ``tp_comm`` takes three steps: each must launch
   the kernels 9/9/4/4/4 times and raise the SPC counter
   ``coll_allreduce_calls`` by exactly the number of
   ``Communicator.allreduce`` calls the step makes (one per parameter on
   dp, one per tp-replicated parameter on tp, two for the loss, four per
   layer for the f/g pair: 30), split as counted per communicator.  On
   CUDA tensors: an allreduce on a revoked communicator raises
   ``Revoked``, ``shrink(failed=[])`` of it gives a working communicator,
   ``agree`` runs on it; ``probe_device_plane()`` at its default deadline
   returns "ok" (the child reports its seconds by stage), and with
   ``ZMPI_DEVICE_WEDGE`` set to "all" or to this rank it returns
   "deadline" or "hung" within its timeout.  Then
   ``zhpe_ompi_tpu_torch.bench``'s measurement (monitoring off again, on
   fresh communicators): the framework step against the plain step with
   remat on and off (step ms, tokens/s, ``vs_baseline``, mfu) and the
   long-context line, and one long-context step (seq 4096, batch 2,
   remat) between launch counts (17/9/8/4/4); then ``finalize()``, after
   which no process group is left.
6. On one-rank NCCL communicators (``tp``, ``dp``, ``sp``), whose
   collectives ``tuned`` serves over ``coll/nccl``: every entry of
   ``comm.coll``, and every algorithm of ``coll/algorithms.py`` forced
   through ``ZMPI_MCA_coll_tuned_<op>_algorithm``, on CUDA tensors of f32,
   bf16 and int32, must give the one-rank MPI answer.  Then the host µs
   per call of ``Communicator.allreduce`` through tuned and through a
   communicator composed without tuned, in 10 alternating turns, and of
   the nccl component's allreduce alone.
7. Drive the forward path at the flagship width (vocab 8192, d_model 1024,
   16 heads, d_ff 4096, 4 layers, seq 512, bf16, ce_chunk 1024, batch 16):
   numpy parameters in the JAX package's layout from a seed,
   ``params_from_numpy`` onto the card, ``tp_comm``, and three batches
   scored through ``forward`` and ``loss_fn``.  The kernels' launch counts
   (all five) are set to 0 just before and read just after; each forward
   must launch the layernorm kernel 9 times, the flash kernel 4 times and
   no backward kernel.  The losses
   must be finite and near ln(8192), and match the same forward with
   ``fused_ln=False, flash=False``; the logits product (bf16 operands, f32
   result) must match both operands upcast to f32.  Then steady-state
   times of ``forward`` and ``loss_fn`` and a torch.profiler breakdown of
   ``loss_fn`` are printed.
8. Drive the training path at the same width: ``make_train_step`` with
   ``dp_comm`` and ``tp_comm``, five SGD steps on one repeated batch.  The
   launch counts are set to 0 just before each step and read just after;
   each step must launch the layernorm forward and backward kernels 9
   times each and the flash forward, dq and dk/dv kernels 4 times each.
   The losses must be finite and the last below the first.  One step on
   the kernel path and one on the plain path (``fused_ln=False,
   flash=False``) from the same parameters and batch must agree in loss
   and in every parameter's update.  Then the steady step time (median,
   quartiles), tokens trained per second, the peak device memory, and a
   torch.profiler breakdown of one step are printed.
9. The same with ``remat=True``: each step must launch the layernorm
   forward 17 times and the flash forward 8 times (the recomputed layers),
   the backward kernels as before; the first step's loss is compared in
   its bits with the step without remat on the same parameters and batch,
   and each parameter's update must agree within 1e-3 (relative Frobenius
   norm); the peak device memory must be below the step's without remat.
10. The same with the one-rank NCCL ``sp_comm`` (ring attention),
   contiguous and then zigzag: no flash launch, 9 layernorm forward and
   backward launches per step, the first loss within 2e-2 of the flash
   path's.
11. The Adam step at the same width: ``make_train_step_optax`` (foreach
   ``torch.optim.Adam`` with optax's defaults) over ``dp_comm`` and
   ``tp_comm``, three steps on one batch, each between launch counts
   (9/9/4/4/4); the same three steps through the plain versions must agree
   in loss and in each parameter's first moment (``ADAM_UPDATE``); then the
   steady step time, tokens/s and peak memory beside the SGD step's, and
   ADAM_SGD_TURNS alternating turns of one synchronised SGD and one Adam
   step (both in the same process state).
12. Checkpoint and resume: after the second Adam step, ``Checkpointer.save``
   of the parameters and ``optimizer.state_dict()`` (704,753,664 bytes of
   f32) into a temporary directory, written in the background, then
   ``wait``; after the live third step, ``restore`` into fresh tensors and a
   fresh optimizer, whose third step must equal the live one in its bits.
   Snapshot, write and restore ms and the bytes on disk are printed; the
   directory is removed.
13. ``moe_ffn`` on 8192 tokens of d_model 1024 and d_ff 4096 (f32, capacity
   1.25, ep 1 over a one-rank NCCL communicator) against
   ``moe_reference_dense`` (``MOE_REL_TOL``), and ``pipeline_apply`` of
   ``t @ w + 1`` (D 1024, 4 microbatches) against the sequential loop.
14. At one rank on CUDA tensors: ``DeviceWindow`` put, get and accumulate,
   a ``DeviceHeap`` put and fetch-add epoch, ``neighbor_allgather`` on a
   periodic (1,) cart, and ``device_pack``/``device_unpack`` of a vector
   type on a 64 MiB tensor against the host convertor, with µs and GB/s.
15. The host plane in this process (``check_host_plane``): a 4-rank
   thread ``LocalUniverse``, then four 4-rank ``TcpProc`` universes in
   threads over loopback: ``tcp`` (``sm=False``: every frame on the
   wire), ``sm`` (the ``sm`` var at its default, one boot id: the
   shared-memory rings carry the data and the wire only the modex),
   ``han`` (``sm_boot_id`` pinned so ranks 0-1 and 2-3 are two emulated
   hosts: ``coll_han_enable=auto`` takes the two-level schedules, intra
   and inter bytes both rise, no flat fallback) and ``numa`` (one boot id,
   ``sm_numa_id`` pinned to two domains of two ranks: allreduce, bcast and
   barrier run three-level).  On each: a barrier, an ``allreduce`` SUM of
   int64 CPU tensors at 1 KiB, 1 MiB and 64 MiB (the last two above
   ``host_coll_large_msg``: the flat planes must take the ring), checked
   exactly against numpy, an ``alltoall``, an ``iallreduce``, a ``bcast``
   and a 4 MiB point-to-point message; rank 0's median µs per call and the
   plane's SPC counters.  ``TcpProc.send`` and ``isend`` of a CUDA tensor
   must raise dss's typed error on every TcpProc plane.  The han plane
   also runs one ``moe_host_ffn`` at the host-moe width (below), experts
   on ``cuda``, held against ``moe_reference_dense`` (``MOE_REL_TOL``)
   with the kept mask equal.  After each plane no ring file, poll thread,
   segment audit failure or han tag window may be left.
16. The host-plane MoE path through its entry point
   (``drive_host_moe_both``), twice: with ``ZMPI_MCA_sm`` unset (the
   default: the rings carry both alltoalls) and with ``ZMPI_MCA_sm=0``
   (all on the loopback wire).  For each this script starts 4 child
   processes of itself, each with the ``ZMPI_*`` coordinator contract
   (this process hosts the rendezvous, ``ZMPI_COORD_EXTERNAL=1``), the
   second job after the first.  Each calls ``zmpi.host_init()``, builds its
   expert on ``cuda`` from a seeded numpy generator, and runs
   ``moe_host_ffn`` at d_model 1024, d_ff 4096, 2048 f32 tokens per rank,
   4 experts, capacity factor 1.25, TF32 off: the median ms of 5 calls,
   then 5 calls split into routing, device-to-host staging, the two
   alltoalls, host-to-device, the expert products (host clock and CUDA
   events) and the combine; the kernels' launch counts over the calls (the
   path launches none of them) and the bytes per call on the rings and on
   the wire.  Rank 0 gathers every rank's ``y`` and ``keep`` over the host
   plane and holds them against ``moe_reference_dense`` over all 8192
   tokens (``MOE_REL_TOL``) and the reference's kept mask.  A child that
   exits non-zero, or prints no result, fails the smoke.
17. Print one ``{"kernels": [...]}`` line (``launches``: per training
   step; ``launches_by_path``: per forward, training, remat, sp, runtime,
   long-context and Adam step), the card's line, and last ``{"ok": true,
   "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, with no result line, when no CUDA
device is present or when the port's package is not beside this script.

    python3 chip_smoke.py --wrapper-host-us PORT_ROOT

prints only the wrappers' host µs per call, and ``Communicator.allreduce``'s,
of the port under PORT_ROOT (for example an older commit unpacked there),
to compare two versions on one card.

    python3 chip_smoke.py --compare-host-us OTHER_ROOT [PAIRS]

runs that measurement for OTHER_ROOT and for the port beside this script
in PAIRS (default 10) alternating pairs of processes (other first in even
pairs, this one first in odd pairs) and prints each version's median and
quartiles of every number.  PORT_ROOT and OTHER_ROOT must hold the port's
``bench.py``, whose headline width the wrappers are timed at.

    python3 chip_smoke.py --host-plane

runs only phases 15 and 16 (no kernel build), printing the card's line
and their results.

    python3 chip_smoke.py --host-moe-child

is phase 16's child (started by the smoke itself, with the ``ZMPI_*``
environment); run alone it fails, as ``host_init`` does without that
contract.

    python3 chip_smoke.py --bench-after

runs every phase, and after phase 14 the bench's remat-off pair once more,
in this process after the profiled phases, beside phase 5's reading.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# flagship width (bench.py's headline config), its batch per chip and CE
# chunk: main() takes them from the port's own zhpe_ompi_tpu_torch.bench
HEADLINE: dict = {}
BATCH = CE_CHUNK = 0
N_BATCHES = 3
TRAIN_STEPS = 5
STEADY_STEPS = 12
# SGD rate of the smoke's training steps: the JAX package's default 1e-2
# moves the loss of a random-weight model by less per step than bf16
# rounding moves it between two runs of the same step; 0.1 makes five
# steps on one batch a clear fall
TRAIN_LR = 0.1

# Tolerances, each with its reason:
# - layernorm y: kernel and plain version both compute f32 statistics and
#   round y to bf16 once; f32 summation order can move y across one bf16
#   rounding boundary, so allow one bf16 ulp of the largest |y| (2^-7
#   relative covers it).  m and r: f32 sums in another order.
LN_Y_REL_TOL = 2.0 ** -7
LN_STAT_TOL = 1e-4
# - flash out: the kernel rounds the probabilities to bf16 for the P V
#   product (the plain version keeps them f32; relative error 2^-9 of
#   sum p|v|) and both round O to bf16 (one ulp, at most 2^-7 of |O|):
#   two bf16 ulps of the largest |O| (2^-6 relative) cover both.
FLASH_OUT_REL_TOL = 2.0 ** -6
# - flash lse: f32 scores from bf16 products in another summation order.
FLASH_LSE_TOL = 1e-3
# - main path, kernel path vs plain path (fused_ln=False, flash=False):
#   bf16 activations through four layers, rounded at other places.
LOSS_TOL = 2e-2
LOGITS_TOL = 0.1
# - logits product: the same bf16 products accumulated in f32 in another
#   order, over d_model = 1024 terms of logits of order 1
PRODUCT_TOL = 1e-3
LOSS_NEAR_LN_V = 0.5
# - layernorm backward: dx in f32 rounded once (one bf16 ulp of the largest
#   |dx|, or f32 summation order for an f32 x); dg an f32 sum over the rows
#   in another order.
LN_DX_REL_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
LN_DG_REL_TOL = 1e-4
# - flash backward: the kernels round p and ds to bf16 for their products
#   (the plain version keeps f32) and round dq, dk, dv to bf16: two bf16
#   ulps of the largest |gradient| (2^-6 relative).
FLASH_BWD_REL_TOL = 2.0 ** -6
# - training step, kernel path vs plain path from the same parameters and
#   batch: the loss as above, and each parameter's update dp (= -lr g) in
#   relative Frobenius norm, |dp_kernel - dp_plain| / |dp_plain|; the two
#   paths round bf16 activations and their gradients at other places
#   (attn_reference rounds the scores and weights to bf16, the kernels do
#   not) through four layers forward and back.  On an H100 the update
#   difference measured at most 0.0101 (embed, ln1, ln2, wqkv and w1 all
#   near 0.01): twice that is the bound.
TRAIN_LOSS_TOL = 2e-2
UPDATE_REL_TOL = 2e-2

# - remat: the same forward, so the same loss; the backward recomputes the
#   same layers, so each parameter's update agrees to f32 summation order
#   (relative Frobenius norm).
REMAT_UPDATE_REL_TOL = 1e-3
# - ring recurrence at (16, 512, 16, 64) bf16 in RING_BLOCKS blocks against
#   one exact block: both in f32 from bf16 inputs, rounded to bf16 once
#   (2^-8 relative of outputs of order 1), summed in another order.
RING_BLOCKS = 4
# rounds of the in-process comparison of allreduce's host cost with and
# without tuned
HOST_US_TURNS = 10
# Adam: counted steps (the checkpoint is taken after the one before last).
# ADAM_UPDATE: the Adam steps are held to the plain path's by their losses
# (TRAIN_LOSS_TOL) and by each parameter's first moment, the running mean of
# the gradients each path computed (UPDATE_REL_TOL, the train phase's bound
# on lr * g).  The parameter update itself is printed, not gated: Adam moves
# each element by about lr * m / sqrt(v), +-lr whatever the gradient's size,
# so an element whose gradient is smaller than the two paths' difference
# moves +lr on one and -lr on the other.  On an H100 the updates after three
# steps differed by 0.043-0.071 (relative Frobenius norm) while the losses
# agreed within 1e-4.
ADAM_STEPS = 3
# turns of the alternating Adam-against-SGD step timing
ADAM_SGD_TURNS = 8
# - moe_ffn at ep 1 against moe_reference_dense: the same f32 products (TF32
#   off), the dispatch path's on a capacity-padded buffer, so cuBLAS may sum
#   the d_model and d_ff terms in another order: 1e-4 of the largest |y|.
MOE_TOKENS = 8192
MOE_REL_TOL = 1e-4
# pipeline_apply: microbatches and their rows (at one stage the pipeline is
# the stage over each microbatch: the same products, compared exactly)
PIPE_M, PIPE_MB = 4, 2048
# device_pack's source tensor (f32), of which a vector type packs half
PACK_BYTES = 64 << 20
# host plane: ranks of the in-process universes, allreduce sizes with the
# calls timed at each, the point-to-point message (above tcp_eager_limit)
HOST_RANKS = 4
HOST_SIZES = {"1KiB": (1 << 10, 10), "1MiB": (1 << 20, 5), "64MiB": (64 << 20, 3)}
# timed calls of the small collectives and of the 4 MiB message per plane
HOST_REPS, HOST_P2P_REPS = 10, 5
HOST_P2P_BYTES = 4 << 20
HOST_TIMEOUT_S = 300.0
# host-plane MoE: ranks (one expert each), tokens per rank, timed calls,
# capacity factor, and the seed of the experts and tokens
HOST_MOE_RANKS = 4
HOST_MOE_TOKENS = 2048
HOST_MOE_CALLS = 5
HOST_MOE_CAPACITY = 1.25
HOST_MOE_SEED = 1808
RING_TOL = 2e-2

# Shapes at the flash kernels' edges, (shape, causal, strided): a long
# sequence, so the ring's mbarrier phases wrap many times (64 key or query
# tiles a block), and an S that is not a multiple of the forward's 128-row
# block nor of the dk/dv kernel's 128-key block.
EDGE_CASES = [((1, 4096, 2, 64), True, False), ((1, 4096, 2, 64), False, False),
              ((2, 192, 3, 64), True, False)]


# device function names of the port's kernels, as the profiler lists them
PORT_KERNELS = ("ln_fwd_", "ln_bwd_", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")


def _take_widths() -> None:
    """HEADLINE, BATCH and CE_CHUNK from ``zhpe_ompi_tpu_torch.bench`` of
    the port first on ``sys.path``."""
    global HEADLINE, BATCH, CE_CHUNK
    from zhpe_ompi_tpu_torch import bench

    HEADLINE, BATCH, CE_CHUNK = bench.HEADLINE, bench.BATCH, bench.CE_CHUNK


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, n_sets, iters=40, warmup=4) -> float:
    """Mean device time of one call, by CUDA events around ``iters``
    back-to-back calls.  ``fn(i)`` uses input set ``i % n_sets``; the
    caller makes enough sets that together they exceed the 50 MB L2, so
    each call reads its inputs from device memory.  A spin kernel holds the
    device while the host queues the calls, so the events time the
    device's work and not the host's launch rate."""
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if host_ms > 40:
        raise SystemExit(f"timing: the host took {host_ms} ms to queue the "
                         "calls, longer than the spin kernel holds the device")
    return start.elapsed_time(end) / iters


def _event_ms(torch, fn, reps=3) -> float:
    """Time of one call by CUDA events around ``reps`` calls after one
    warm-up, with no spin kernel ahead of them: for work that issues many
    small kernels, the time includes the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us_per_call(torch, fn, n_sets, calls=200, reps=3) -> float:
    """Host time of one call in µs: the median over ``reps`` runs of
    ``calls`` back-to-back calls queued while a spin kernel holds the
    device, so the clock reads the wrapper's own cost (checks, tensor maps,
    ctypes, launch) and not the device's work."""
    for i in range(4):
        fn(i % n_sets)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(200_000_000)  # ~100 ms of device time
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i % n_sets)
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    runs.sort()
    return runs[reps // 2]


def wrapper_host_us(torch, fa) -> dict:
    """Host µs per call of the flash forward, dq and dk/dv wrappers at the
    headline shape (16, 512, 16, 64) bf16 causal."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (BATCH, HEADLINE["seq"], HEADLINE["n_heads"],
             HEADLINE["d_model"] // HEADLINE["n_heads"])
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, True)
    _, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    return {
        "flash_fwd": host_us_per_call(torch, lambda i: fa.flash_fwd(q, k, v, True), 1),
        "flash_bwd_dq": host_us_per_call(
            torch, lambda i: fa.flash_bwd_dq(q, k, v, out, lse, do, True), 1),
        "flash_bwd_dkv": host_us_per_call(
            torch, lambda i: fa.flash_bwd_dkv(q, k, v, lse, delta, do, True), 1),
    }


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_layernorm(torch, F, fused_norm):
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, d = BATCH * HEADLINE["seq"], HEADLINE["d_model"]
    # odd shapes: the register path's masked edge, the generic path, f32
    for shape, dtype in (((1000, 1000), torch.bfloat16),
                         ((77, 1001), torch.bfloat16),
                         ((333, 640), torch.float32),
                         ((n, d), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        g = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        y, m, r = fused_norm.ln_fwd(x, g)
        torch.cuda.synchronize()
        yp, mp, rp = fused_norm.ln_fwd_plain(x, g)
        err = _max_err(y, yp)
        tol = LN_Y_REL_TOL * float(yp.float().abs().max())
        serr = max(_max_err(m, mp), _max_err(r, rp) / float(rp.abs().max()))
        print(f"layernorm {shape} {dtype}: max|y-plain| {err} (tol {tol}), "
              f"stats {serr} (tol {LN_STAT_TOL})")
        if not (err <= tol and serr <= LN_STAT_TOL):
            raise SystemExit(f"layernorm kernel disagrees at {shape} {dtype}")
    g_lib = g.to(x.dtype)
    xs = [x] + [x.clone() for _ in range(3)]  # 4 x 16 MB: more than the L2
    ms = _time_ms(torch, lambda i: fused_norm.ln_fwd(xs[i], g), len(xs))
    plain_ms = _time_ms(torch, lambda i: fused_norm.ln_fwd_plain(xs[i], g), len(xs))
    lib_ms = _time_ms(torch, lambda i: F.layer_norm(xs[i], (d,), g_lib, None, 1e-5),
                      len(xs))
    # a device copy of x into y moves the same 32 MB: the practical ceiling
    ys = [torch.empty_like(t) for t in xs]
    copy_ms = _time_ms(torch, lambda i: ys[i].copy_(xs[i]), len(xs))
    nbytes = 2 * n * d * x.element_size() + d * 4 + 2 * n * 4
    nflop = 8 * n * d  # sum, centre, square, sum, scale, gain (f32 SIMT)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nflop / F32_FLOP_PER_S * 1e3
    return {
        "name": "layernorm_fwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/fused_norm.cu",
        "replaces": "zhpe_ompi_tpu/ops/fused_norm.py:49",
        "shape": [n, d], "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "copy_ms": copy_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }


def check_flash(torch, F, fa):
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # odd shapes: ragged S, other head dims, strided views of a fused qkv
    cases = [((2, 300, 3, 64), True, False), ((2, 300, 3, 64), False, False),
             ((1, 129, 2, 32), True, False), ((1, 200, 2, 128), True, False),
             ((2, 256, 4, 64), True, True), *EDGE_CASES, ((B, S, h, hd), True, False)]
    for shape, causal, strided in cases:
        if strided:
            b_, s_, h_, d_ = shape
            qkv = rnd(b_, s_, 3, h_ * d_)
            q, k, v = (qkv[:, :, i].reshape(shape) for i in range(3))
        else:
            q, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
        out, lse = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        err, lerr = _max_err(out, out_p), _max_err(lse, lse_p)
        tol = FLASH_OUT_REL_TOL * float(out_p.float().abs().max())
        print(f"flash {shape} causal={causal} strided={strided}: "
              f"max|o-plain| {err} (tol {tol}), "
              f"max|lse-plain| {lerr} (tol {FLASH_LSE_TOL})")
        if not (err <= tol and lerr <= FLASH_LSE_TOL):
            raise SystemExit(f"flash kernel disagrees at {shape} causal={causal}")
    # 3 sets of q, k, v (48 MB each): more than the L2
    sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v)) for _ in range(2)]
    # SDPA takes (B, h, S, hd): the same tensors, viewed
    tsets = [tuple(t.transpose(1, 2) for t in qkv) for qkv in sets]
    ms = _time_ms(torch, lambda i: fa.flash_fwd(*sets[i], True), len(sets))
    plain_ms = _time_ms(torch, lambda i: fa.flash_fwd_plain(*sets[i], True),
                        len(sets), iters=10, warmup=2)
    lib_ms = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
        *tsets[i], is_causal=True), len(sets))
    pairs = B * h * S * (S + 1) // 2  # causal (query, key) pairs this run needs
    nflop = 4 * pairs * hd            # Q K^T and P V, 2 flops per multiply-add
    nbytes = 4 * B * S * h * hd * 2 + B * h * S * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nflop / BF16_TENSOR_FLOP_PER_S * 1e3
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/flash_attention.cu",
        "replaces": "zhpe_ompi_tpu/ops/flash_attention.py:65",
        "shape": [B, S, h, hd], "dtype": "bfloat16", "causal": True,
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }


def _bound(nbytes, nflop, flop_rate):
    """The least time (ms) the card could take, and what binds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nflop / flop_rate * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_layernorm_bwd(torch, fused_norm):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, d = BATCH * HEADLINE["seq"], HEADLINE["d_model"]
    for shape, dtype in (((1000, 1000), torch.bfloat16),
                         ((77, 1001), torch.bfloat16),
                         ((333, 640), torch.float32),
                         ((n, d), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        _, m, r = fused_norm.ln_fwd_plain(x, g)
        dx, dg = fused_norm.ln_bwd(x, g, dy, m, r)
        torch.cuda.synchronize()
        dxp, dgp = fused_norm.ln_bwd_plain(x, g, dy, m, r)
        err, gerr = _max_err(dx, dxp), _max_err(dg, dgp)
        tol = LN_DX_REL_TOL[str(dtype).split(".")[-1]] * float(dxp.float().abs().max())
        gtol = LN_DG_REL_TOL * float(dgp.abs().max())
        print(f"layernorm bwd {shape} {dtype}: max|dx-plain| {err} (tol {tol}), "
              f"max|dg-plain| {gerr} (tol {gtol})")
        if not (err <= tol and gerr <= gtol):
            raise SystemExit(f"layernorm backward kernel disagrees at {shape} {dtype}")
    # 3 sets of x and dy (32 MB each): more than the L2
    sets = [(x, dy)] + [(x.clone(), dy.clone()) for _ in range(2)]
    ms = _time_ms(torch, lambda i: fused_norm.ln_bwd(sets[i][0], g, sets[i][1], m, r),
                  len(sets))
    plain_ms = _time_ms(torch, lambda i: fused_norm.ln_bwd_plain(
        sets[i][0], g, sets[i][1], m, r), len(sets))
    g_lib, m2, r2 = g.to(x.dtype), m[:, None], r[:, None]
    lib_ms = _time_ms(torch, lambda i: torch.ops.aten.native_layer_norm_backward(
        sets[i][1], sets[i][0], [d], m2, r2, g_lib, None, [True, True, False]),
        len(sets))
    nbytes = 3 * n * d * x.element_size() + 2 * d * 4 + 2 * n * 4
    nflop = 11 * n * d  # x^, dx^, dg, two row sums, dx (f32 SIMT)
    bound_ms, bound_by = _bound(nbytes, nflop, F32_FLOP_PER_S)
    return {
        "name": "layernorm_bwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/fused_norm.cu",
        "replaces": "zhpe_ompi_tpu/ops/fused_norm.py:91",
        "shape": [n, d], "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": tol, "dg_max_abs_err": gerr,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "torch.ops.aten.native_layer_norm_backward",
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_flash_bwd(torch, F, fa):
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cases = [((2, 300, 3, 64), True, False), ((2, 300, 3, 64), False, False),
             ((1, 129, 2, 32), True, False), ((1, 200, 2, 128), True, False),
             ((3, 70, 2, 16), False, False), ((2, 256, 4, 64), True, True),
             *EDGE_CASES, ((B, S, h, hd), True, False)]
    for shape, causal, strided in cases:
        if strided:
            b_, s_, h_, d_ = shape
            qkv = rnd(b_, s_, 3, h_ * d_)
            q, k, v = (qkv[:, :, i].reshape(shape) for i in range(3))
        else:
            q, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
        do = rnd(*shape)
        out, lse = fa.flash_fwd(q, k, v, causal)
        got = fa.flash_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        want = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
        errs, tols, rels = [], [], []
        for t, w in zip(got, want):
            errs.append(_max_err(t, w))
            tols.append(FLASH_BWD_REL_TOL * float(w.float().abs().max()))
            rels.append(float((t.float() - w.float()).norm() / w.float().norm()))
        print(f"flash bwd {shape} causal={causal} strided={strided}: "
              f"max|d(q,k,v)-plain| {errs} (tol {tols}), relative norm {rels}")
        if not all(e <= t for e, t in zip(errs, tols)):
            raise SystemExit(f"flash backward kernels disagree at {shape} causal={causal}")
    # dq (with delta) and dk/dv sum in a fixed order (no atomics): the same
    # bits twice
    first = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    again = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"flash dq and delta twice on the same inputs: same bits {deterministic}")
    if not deterministic:
        raise SystemExit("the dq kernel is not deterministic")
    delta = first[1]
    first = fa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    again = fa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"flash dk/dv twice on the same inputs: same bits {deterministic}")
    if not deterministic:
        raise SystemExit("the dk/dv kernel is not deterministic")
    # 2 sets of q, k, v, out, dO (84 MB each): more than the L2
    sets = [(q, k, v, out, lse, do)] + [
        tuple(t.clone() for t in (q, k, v, out, lse, do)) for _ in range(1)]
    deltas = [fa.flash_bwd_dq(*st)[1] for st in sets]
    dq_ms = _time_ms(torch, lambda i: fa.flash_bwd_dq(*sets[i], True), len(sets))
    dkv_ms = _time_ms(torch, lambda i: fa.flash_bwd_dkv(
        *sets[i][:3], sets[i][4], deltas[i], sets[i][5], True), len(sets))
    plain_ms = _time_ms(torch, lambda i: fa.flash_bwd_plain(*sets[i], True),
                        len(sets), iters=6, warmup=2)
    # library yardstick: the backward alone of SDPA (is_causal, flash
    # backend) through autograd, on a graph kept from one forward per set
    graphs = []
    for st in sets:
        tq = [t.transpose(1, 2).detach().requires_grad_() for t in st[:3]]
        graphs.append((F.scaled_dot_product_attention(*tq, is_causal=True), tq,
                       st[5].transpose(1, 2)))
    lib_ms = _time_ms(torch, lambda i: torch.autograd.grad(
        graphs[i][0], graphs[i][1], graphs[i][2], retain_graph=True), len(sets))
    print(f"flash bwd {(B, S, h, hd)} causal: dq {dq_ms * 1e3} us + dk/dv "
          f"{dkv_ms * 1e3} us = pair {(dq_ms + dkv_ms) * 1e3} us, SDPA backward "
          f"{lib_ms * 1e3} us")
    pairs = B * h * S * (S + 1) // 2  # causal (query, key) pairs this run needs
    elems = B * S * h * hd
    rows = B * h * S
    common = {"route": "cuda", "source": "zhpe_ompi_tpu_torch/csrc/flash_attention_bwd.cu",
              "shape": [B, S, h, hd], "dtype": "bfloat16", "causal": True,
              "plain_ms": plain_ms, "plain": "flash_bwd_plain (dq, dk and dv together)",
              "library_ms": lib_ms,
              "library": "autograd backward of F.scaled_dot_product_attention "
                         "(is_causal), dq, dk and dv together"}
    # dq: reads q, k, v, O, dO, lse; writes dq and delta; 3 products
    dq_bound, dq_by = _bound(6 * elems * 2 + 2 * rows * 4, 3 * 2 * pairs * hd,
                             BF16_TENSOR_FLOP_PER_S)
    # dk/dv: reads q, k, v, dO, lse, delta; writes dk, dv; 4 products
    dkv_bound, dkv_by = _bound(6 * elems * 2 + 2 * rows * 4, 4 * 2 * pairs * hd,
                               BF16_TENSOR_FLOP_PER_S)
    return [
        dict(common, name="flash_attention_bwd_dq",
             replaces="zhpe_ompi_tpu/ops/flash_attention.py:214",
             max_abs_err=errs[0], tolerance=tols[0], ms=dq_ms,
             bound_ms=dq_bound, bound_by=dq_by),
        dict(common, name="flash_attention_bwd_dkv",
             replaces="zhpe_ompi_tpu/ops/flash_attention.py:248",
             max_abs_err=max(errs[1:]), tolerance=min(tols[1:]), ms=dkv_ms,
             bound_ms=dkv_bound, bound_by=dkv_by),
    ]


def steady_times(torch, tfm, params, cfg, tp_comm, tokens, targets, reps=20):
    """Host-clock times of ``forward`` and ``loss_fn`` on one batch after
    warm-up, each call ended by a synchronize: median, quartiles, extremes
    over ``reps`` calls, and the scoring rate at the median."""
    out = {}
    calls = {"forward": lambda: tfm.forward(params, tokens, cfg, tp_comm=tp_comm),
             "loss_fn": lambda: tfm.loss_fn(params, tokens, targets, cfg,
                                            tp_comm=tp_comm)}
    with torch.inference_mode():
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ms.sort()
            out[name] = {"reps": reps, "median_ms": ms[reps // 2],
                         "q1_ms": ms[reps // 4], "q3_ms": ms[3 * reps // 4],
                         "min_ms": ms[0], "max_ms": ms[-1],
                         "tokens_per_s": BATCH * cfg.seq / (ms[reps // 2] / 1e3)}
    return out


def profile_calls(torch, call, reps=3):
    """Device time by kernel over ``reps`` calls of ``call()``, from
    torch.profiler (CUPTI), and the device's busy share of the wall time
    (one stream, so kernel times do not overlap).  The profiler's own cost
    is in the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, host_ops = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels.append((us / 1e3 / reps, evt.count / reps, evt.key))
        else:
            host_ops.append((evt.self_cpu_time_total / 1e3 / reps,
                             evt.count / reps, evt.key))
    kernels.sort(reverse=True)
    host_ops.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {
        "wall_ms_per_call": wall_s * 1e3 / reps,
        "device_ms_per_call": busy_ms,
        "busy_share": busy_ms / (wall_s * 1e3 / reps),
        "top_kernels_ms_per_call": [[k[2][:90], k[0], k[1]] for k in kernels[:16]],
        # the port's own kernels, wherever they rank
        "port_kernels_ms_per_call": [[k[2][:90], k[0], k[1]] for k in kernels
                                     if any(n in k[2] for n in PORT_KERNELS)],
        # host time by operator (self time, profiler cost included)
        "top_host_ops_ms_per_call": [[k[2][:60], k[0], k[1]] for k in host_ops[:12]],
    }


def drive_main_path(torch, np, tfm, fused_ce, fused_norm, fa, tp_comm):
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    plain_cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK,
                           fused_ln=False, flash=False)
    from zhpe_ompi_tpu_torch.bench import numpy_params

    params = tfm.params_from_numpy(numpy_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                rng.integers(0, cfg.vocab, (BATCH, cfg.seq)))
               for _ in range(N_BATCHES)]
    results = []
    counted = _kernel_counters(fused_norm, fa)
    for fn in counted.values():
        fn.launches = 0
    with torch.inference_mode():
        for tokens, targets in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = tfm.forward(params, tokens, cfg, tp_comm=tp_comm)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = tfm.loss_fn(params, tokens, targets, cfg, tp_comm=tp_comm)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            results.append((logits, float(loss), t1 - t0, t2 - t1))
    launches = {name: fn.launches for name, fn in counted.items()}
    n_forward = 2 * N_BATCHES
    want = {"layernorm_fwd": (2 * cfg.n_layers + 1) * n_forward,
            "layernorm_bwd": 0, "flash_attention_fwd": cfg.n_layers * n_forward,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    print(f"main path launches {launches}, expected {want} "
          f"({n_forward} forwards)")
    if launches != want:
        raise SystemExit("the main path did not launch every kernel as expected")

    card = torch.cuda.get_device_name(0)
    for i, (logits, loss, t_fwd, t_loss) in enumerate(results):
        shape_ok = tuple(logits.shape) == (BATCH, cfg.seq, cfg.vocab)
        finite = bool(torch.isfinite(logits).all()) and math.isfinite(loss)
        print(f"batch {i}: loss {loss} forward {t_fwd * 1e3} ms "
              f"loss_fn {t_loss * 1e3} ms "
              f"({BATCH * cfg.seq / t_loss} tokens/s scored) on {card}")
        if not (shape_ok and finite and abs(loss - math.log(cfg.vocab)) < LOSS_NEAR_LN_V):
            raise SystemExit(f"batch {i}: bad output (shape {tuple(logits.shape)}, "
                             f"loss {loss})")

    tokens, targets = batches[0]
    with torch.inference_mode():
        plain_logits = tfm.forward(params, tokens, plain_cfg, tp_comm=tp_comm)
        plain_loss = float(tfm.loss_fn(params, tokens, targets, plain_cfg,
                                       tp_comm=tp_comm))
    lerr = abs(results[0][1] - plain_loss)
    gerr = _max_err(results[0][0], plain_logits)
    print(f"kernel path vs plain path: |loss diff| {lerr} (tol {LOSS_TOL}), "
          f"max|logits diff| {gerr} (tol {LOGITS_TOL})")
    if not (lerr <= LOSS_TOL and gerr <= LOGITS_TOL):
        raise SystemExit("kernel path disagrees with the plain path")
    # the logits product (bf16 operands, f32 result) against both
    # operands upcast to f32 first
    with torch.inference_mode():
        hidden = tfm.forward_hidden(params, tokens, cfg, tp_comm=tp_comm)
        emb = params["embed"].to(cfg.dtype)
        lg = fused_ce._logits(hidden, emb)
        lg_f32 = hidden.float() @ emb.float().t()
    perr = _max_err(lg, lg_f32)
    print(f"logits product vs f32 product: max|diff| {perr} "
          f"(tol {PRODUCT_TOL})")
    if lg.dtype != torch.float32 or not perr <= PRODUCT_TOL:
        raise SystemExit("the f32-result logits product disagrees")
    steady = steady_times(torch, tfm, params, cfg, tp_comm, tokens, targets)
    print(json.dumps({"steady_state": steady, "card": card}))

    def score():
        with torch.inference_mode():
            tfm.loss_fn(params, tokens, targets, cfg, tp_comm=tp_comm)

    prof = profile_calls(torch, score)
    print(json.dumps({"profile_loss_fn": prof, "card": card}))
    return launches, [r[2] for r in results], [r[3] for r in results]


def _kernel_counters(fused_norm, fa):
    return {"layernorm_fwd": fused_norm.ln_fwd, "layernorm_bwd": fused_norm.ln_bwd,
            "flash_attention_fwd": fa.flash_fwd,
            "flash_attention_bwd_dq": fa.flash_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv}


def train_steps(torch, step, params, tokens, targets, counted, want, label):
    """TRAIN_STEPS steps on one batch, each between launch counts set to 0
    just before and read just after; fails unless every count is as
    ``want`` says and the loss falls with finite values.  The trained
    parameters come back in a dict that no one else references, so that
    ``steady_steps`` can replace them step by step and the peak memory it
    reads holds one live set."""
    card = torch.cuda.get_device_name(0)
    losses = []
    for i in range(TRAIN_STEPS):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, tokens, targets)
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        print(f"{label} step {i}: loss {loss} in {dt * 1e3} ms, launches "
              f"{launches} (expected {want}) on {card}")
        if launches != want:
            raise SystemExit(f"a {label} step did not launch the kernels as expected")
        losses.append(loss)
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if not (all(math.isfinite(x) for x in losses) and finite and losses[-1] < losses[0]):
        raise SystemExit(f"{label}: the loss did not fall with finite values: {losses}")
    return {"params": params}, losses, launches


def steady_steps(torch, step, state, tokens, targets, label):
    """Synchronised steps after two warm-up steps: the step time's median
    and quartiles, tokens trained per second, the peak device memory over
    the steady steps, and a torch.profiler breakdown of two steps.
    ``state["params"]`` is replaced by each step's result: the caller
    holds no other reference to it."""
    card = torch.cuda.get_device_name(0)

    def one_step():
        state["params"], _ = step(state["params"], tokens, targets)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(STEADY_STEPS):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms.sort()
    n = len(ms)
    steady = {"steps": n, "median_ms": ms[n // 2], "q1_ms": ms[n // 4],
              "q3_ms": ms[3 * n // 4], "min_ms": ms[0], "max_ms": ms[-1],
              "tokens_per_s_trained": BATCH * HEADLINE["seq"] / (ms[n // 2] / 1e3),
              "max_memory_allocated_bytes": peak}
    prof = profile_calls(torch, one_step, reps=2)
    steady["busy_share"] = prof["busy_share"]
    steady["device_ms_per_step"] = prof["device_ms_per_call"]
    print(json.dumps({f"{label}_steady_state": steady, "card": card}))
    print(json.dumps({f"profile_{label}_step": prof, "card": card}))
    return steady


def _train_inputs(torch, np, tfm, cfg, batch=None):
    from zhpe_ompi_tpu_torch.bench import numpy_params

    batch = BATCH if batch is None else batch
    params0 = tfm.params_from_numpy(numpy_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(2)
    tokens, targets = (torch.as_tensor(rng.integers(0, cfg.vocab, (batch, cfg.seq)),
                                       device="cuda") for _ in range(2))
    return params0, tokens, targets


def _update_rel(params0, new_a, new_b):
    """Relative Frobenius difference of two updates of each parameter."""
    return {name: float((new_a[name] - p0 - (new_b[name] - p0)).norm()
                        / (new_b[name] - p0).norm())
            for name, p0 in params0.items()}


def drive_train(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm):
    """The training path: make_train_step at the headline width."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    plain_step, _ = tfm.make_train_step(
        replace(cfg, fused_ln=False, flash=False), dp_comm, tp_comm, lr=TRAIN_LR)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    state, losses, launches = train_steps(torch, step, params0, tokens, targets,
                                          counted, want, "train")

    # one step on each path from the same parameters and batch
    new_k, loss_k = step(params0, tokens, targets)
    new_p, loss_p = plain_step(params0, tokens, targets)
    lerr = abs(float(loss_k) - float(loss_p))
    rel = _update_rel(params0, new_k, new_p)
    print(f"train step, kernel path vs plain path: |loss diff| {lerr} "
          f"(tol {TRAIN_LOSS_TOL}), relative update difference {rel} "
          f"(tol {UPDATE_REL_TOL})")
    if not (lerr <= TRAIN_LOSS_TOL and all(r <= UPDATE_REL_TOL for r in rel.values())):
        raise SystemExit("the kernel path's training step disagrees with the plain path")
    del new_k, new_p
    print(json.dumps({"losses": losses, "lr": TRAIN_LR}))
    steady = steady_steps(torch, step, state, tokens, targets, "train")
    return launches, steady, float(loss_k)


def drive_remat(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, train_steady):
    """The training path with ``remat=True``: each layer checkpointed,
    the projections' outputs kept, the rest (both forward kernels
    included) recomputed in the backward."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(replace(cfg, remat=True), dp_comm, tp_comm,
                                  lr=TRAIN_LR)
    base_step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 4 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    state, losses, launches = train_steps(torch, step, params0, tokens, targets,
                                          counted, want, "remat")
    # the first step against the step without remat, same params and batch:
    # the forward is the same computation, so the same loss bits
    new_r, loss_r = step(params0, tokens, targets)
    new_b, loss_b = base_step(params0, tokens, targets)
    loss_r, loss_b = float(loss_r), float(loss_b)
    rel = _update_rel(params0, new_r, new_b)
    print(f"remat step vs step without remat: loss {loss_r} vs {loss_b} "
          f"(difference {loss_r - loss_b}), relative update difference {rel} "
          f"(tol {REMAT_UPDATE_REL_TOL})")
    if loss_r != loss_b:
        print("remat: the first step's loss differs in its bits from the step "
              "without remat")
    if not all(r <= REMAT_UPDATE_REL_TOL for r in rel.values()):
        raise SystemExit("the remat step's update disagrees with the step without remat")
    del new_r, new_b
    print(json.dumps({"remat_losses": losses, "first_loss": loss_r,
                      "first_loss_without_remat": loss_b}))
    steady = steady_steps(torch, step, state, tokens, targets, "remat")
    peak, base_peak = (steady["max_memory_allocated_bytes"],
                       train_steady["max_memory_allocated_bytes"])
    print(f"remat: step median {steady['median_ms']} ms (without remat "
          f"{train_steady['median_ms']} ms), peak memory {peak} bytes (without "
          f"remat {base_peak} bytes), launches per step {launches}")
    if not peak < base_peak:
        raise SystemExit("remat did not lower the training step's peak memory")
    return launches, steady


def drive_sp(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, sp_comm, flash_loss):
    """The training path with a one-rank NCCL ``sp_comm``: attention is ring
    attention (at one rank, one exact block), contiguous then zigzag."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    out = {}
    for zigzag in (False, True):
        label = "sp_zigzag" if zigzag else "sp_contiguous"
        step, _ = tfm.make_train_step(replace(cfg, zigzag_sp=zigzag), dp_comm,
                                      tp_comm, sp_comm, lr=TRAIN_LR)
        params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
        state, losses, launches = train_steps(
            torch, step, params0, tokens, targets, counted, want, label)
        lerr = abs(losses[0] - flash_loss)
        print(f"{label}: first loss {losses[0]} vs the flash path's {flash_loss}: "
              f"|diff| {lerr} (tol {TRAIN_LOSS_TOL})")
        if not lerr <= TRAIN_LOSS_TOL:
            raise SystemExit(f"{label}: the loss disagrees with the flash path")
        steady = steady_steps(torch, step, state, tokens, targets, label)
        out[label] = (launches, steady)
    return out


def _adam_steps(torch, step, params, opt, tokens, targets, n, counted=None, want=None,
                label="adam"):
    """``n`` Adam steps (in place), each between launch counts set to 0 just
    before and read just after when ``counted`` is given; the losses and the
    last step's launches."""
    losses, launches = [], None
    for i in range(n):
        if counted is not None:
            for fn in counted.values():
                fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if counted is not None:
            launches = {name: fn.launches for name, fn in counted.items()}
            print(f"{label} step: loss {loss} in {dt * 1e3} ms, launches {launches} "
                  f"(expected {want})")
            if launches != want:
                raise SystemExit(f"an {label} step did not launch the kernels as expected")
        losses.append(loss)
    return losses, launches


def _turns_vs_sgd(torch, tfm, cfg, dp_comm, tp_comm, adam_step, params, params0, tokens,
                  targets, card_line):
    """The Adam step against the SGD step in ADAM_SGD_TURNS alternating turns
    (SGD first in even turns), each step synchronised: both read the same
    host and the same process history, which the steady phases, run at
    other times, do not."""
    sgd_step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    state = {"sgd": {k: v.clone() for k, v in params0.items()}, "adam": params}
    steps = {"sgd": sgd_step, "adam": adam_step}
    ms = {"sgd": [], "adam": []}
    for name in ("sgd", "adam"):  # warm-up
        state[name], _ = steps[name](state[name], tokens, targets)
    for i in range(ADAM_SGD_TURNS):
        for name in (("sgd", "adam") if i % 2 == 0 else ("adam", "sgd")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state[name], _ = steps[name](state[name], tokens, targets)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    ratios = sorted(a / b for a, b in zip(ms["adam"], ms["sgd"]))
    out = {"sgd": _quartiles(ms["sgd"]), "adam": _quartiles(ms["adam"]),
           "adam_over_sgd_median": ratios[len(ratios) // 2], "ratios": ratios}
    print(json.dumps({"adam_vs_sgd_turns": out, "card": card_line}))
    return out


def drive_adam(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, train_steady, card_line):
    """The Adam step (``make_train_step_optax``, torch.optim.Adam with optax's
    defaults) at the headline width: ADAM_STEPS counted steps, a checkpoint
    of the parameters and optimizer state after step 2 restored into fresh
    tensors whose step 3 must equal the live step 3 in its bits, the same
    steps through the plain versions, then steady steps."""
    from dataclasses import replace

    from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    init, step, _ = tfm.make_train_step_optax(cfg, dp_comm, tp_comm)
    pinit, plain_step, _ = tfm.make_train_step_optax(
        replace(cfg, fused_ln=False, flash=False), dp_comm, tp_comm)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    params = {k: v.clone() for k, v in params0.items()}
    opt = init(params)
    losses, _ = _adam_steps(torch, step, params, opt, tokens, targets, ADAM_STEPS - 1,
                            counted, want)
    # the checkpoint after step ADAM_STEPS - 1, written in the background
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(ADAM_STEPS - 1, {"params": params, "opt": opt.state_dict()})
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        step_dir = os.path.join(ckdir, f"step_{ADAM_STEPS - 1}")
        disk = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        more, launches = _adam_steps(torch, step, params, opt, tokens, targets, 1,
                                     counted, want)
        losses += more
        t3 = time.perf_counter()
        state, at = ck.restore(placements={"params": "cuda", "opt": "cpu"})
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    fresh = state["params"]
    fresh_opt = init(fresh)
    fresh_opt.load_state_dict(state["opt"])
    resumed, _ = _adam_steps(torch, step, fresh, fresh_opt, tokens, targets, 1)
    same = resumed[0] == losses[-1] and all(torch.equal(fresh[k], params[k]) for k in params)
    ckpt = {"snapshot_ms": (t1 - t0) * 1e3, "write_ms": (t2 - t1) * 1e3,
            "restore_ms": (t4 - t3) * 1e3, "bytes_on_disk": disk, "step": at,
            "resumed_loss": resumed[0], "live_loss": losses[-1], "bits_equal": same}
    print(json.dumps({"checkpoint": ckpt, "card": card_line}))
    if not same:
        raise SystemExit("the step resumed from the checkpoint differs from the live step")
    del fresh, fresh_opt, state

    # the same steps through the plain versions, from the same parameters
    plain = {k: v.clone() for k, v in params0.items()}
    plain_opt = pinit(plain)
    plain_losses, _ = _adam_steps(torch, plain_step, plain, plain_opt, tokens, targets,
                                  ADAM_STEPS)
    lerr = max(abs(a - b) for a, b in zip(losses, plain_losses))
    rel = _update_rel(params0, params, plain)
    m_rel = {name: float((opt.state[p]["exp_avg"] - plain_opt.state[plain[name]]["exp_avg"])
                         .norm() / plain_opt.state[plain[name]]["exp_avg"].norm())
             for name, p in params.items()}
    print(f"adam, kernel path vs plain path over {ADAM_STEPS} steps: losses {losses} vs "
          f"{plain_losses} (max |diff| {lerr}, tol {TRAIN_LOSS_TOL}), relative first-"
          f"moment difference {m_rel} (tol {UPDATE_REL_TOL}), relative update difference "
          f"{rel} (not gated: see ADAM_UPDATE)")
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if not (finite and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"adam: the loss did not fall with finite values: {losses}")
    if not (lerr <= TRAIN_LOSS_TOL and all(r <= UPDATE_REL_TOL for r in m_rel.values())):
        raise SystemExit("the kernel path's Adam steps disagree with the plain path")
    del plain, plain_opt

    def adam_step(p, tok, tgt):
        p, _, loss = step(p, opt, tok, tgt)
        return p, loss

    steady = steady_steps(torch, adam_step, {"params": params}, tokens, targets, "adam")
    steady["turns_vs_sgd"] = _turns_vs_sgd(torch, tfm, cfg, dp_comm, tp_comm, adam_step,
                                           params, params0, tokens, targets, card_line)
    moments = 2 * sum(p.numel() * p.element_size() for p in params0.values())
    print(f"adam: step median {steady['median_ms']} ms (SGD {train_steady['median_ms']} "
          f"ms), peak {steady['max_memory_allocated_bytes']} bytes (SGD "
          f"{train_steady['max_memory_allocated_bytes']} + moments {moments} = "
          f"{train_steady['max_memory_allocated_bytes'] + moments}) on {card_line}")
    return launches, steady, ckpt, {"losses": losses, "plain_losses": plain_losses,
                                    "exp_avg_rel": m_rel, "update_rel": rel}


def check_moe_pipeline(torch, np, comm, card_line):
    """``moe_ffn`` on MOE_TOKENS tokens of the headline d_model and d_ff at
    capacity 1.25 and ep = 1, against ``moe_reference_dense``; then
    ``pipeline_apply`` of ``t @ w + 1`` over PIPE_M microbatches at D =
    d_model against the sequential loop."""
    from zhpe_ompi_tpu_torch.models import moe, pipeline

    D, F = HEADLINE["d_model"], HEADLINE["d_ff"]
    rng = np.random.default_rng(8)
    prm = moe.moe_params_from_numpy({
        "router": rng.standard_normal((D, 1)) * D ** -0.5,
        "w_in": rng.standard_normal((1, D, F)) * D ** -0.5,
        "w_out": rng.standard_normal((1, F, D)) * F ** -0.5}, ep_rank=0)
    x = torch.as_tensor(rng.standard_normal((MOE_TOKENS, D)), dtype=torch.float32,
                        device="cuda")
    y, keep = moe.moe_ffn(comm, prm, x, capacity_factor=1.25)
    cap = max(1, int(1.25 * MOE_TOKENS))
    dense = moe.moe_reference_dense(prm, x, 1, cap)
    err = _max_err(y, dense) / float(dense.abs().max())
    res = {"moe_ms": _event_ms(torch, lambda: moe.moe_ffn(comm, prm, x, 1.25), reps=5),
           "dense_ms": _event_ms(torch, lambda: moe.moe_reference_dense(prm, x, 1, cap),
                                 reps=5),
           "moe_rel_err": err, "kept": int(keep.sum())}
    if not (err <= MOE_REL_TOL and res["kept"] == MOE_TOKENS and bool(torch.isfinite(y).all())):
        raise SystemExit(f"moe_ffn disagrees with moe_reference_dense: {res}")
    w = torch.as_tensor(rng.standard_normal((1, D, D)) * D ** -0.5, dtype=torch.float32,
                        device="cuda")
    xs = torch.as_tensor(rng.standard_normal((PIPE_M, PIPE_MB, D)), dtype=torch.float32,
                         device="cuda")
    stage = lambda ww, t: t @ ww[0] + 1.0  # noqa: E731
    out = pipeline.pipeline_apply(comm, stage, w, xs)
    seq = torch.stack([t @ w[0] + 1.0 for t in xs])
    res["pipeline_ms"] = _event_ms(torch, lambda: pipeline.pipeline_apply(comm, stage, w, xs),
                                   reps=5)
    res["pipeline_equal"] = torch.equal(out, seq)
    print(json.dumps({"moe_pipeline": res, "card": card_line}))
    if not res["pipeline_equal"]:
        raise SystemExit("pipeline_apply disagrees with the sequential loop")
    return res


def check_device_plane(torch, np, comm, card_line):
    """At one rank on CUDA tensors: DeviceWindow put, get and accumulate; a
    DeviceHeap put and fetch-add epoch; neighbor_allgather on a periodic
    (1,) cart; device_pack and device_unpack of a vector type on a tensor
    of PACK_BYTES against the host convertor, with µs and GB/s."""
    from zhpe_ompi_tpu_torch import datatype as dt
    from zhpe_ompi_tpu_torch import topo
    from zhpe_ompi_tpu_torch.datatype import convertor
    from zhpe_ompi_tpu_torch.osc import DeviceWindow
    from zhpe_ompi_tpu_torch.shmem import spml

    res = {}
    win = DeviceWindow(comm, torch.zeros(1 << 20, device="cuda"))
    vals = torch.arange(16, dtype=torch.float32, device="cuda")
    win = win.put(vals, [0], [100]).fence()
    got = win.get([0], [100], count=16)
    win = win.accumulate(vals, [0], [100])
    res["window"] = (torch.equal(got, vals)
                     and torch.equal(win.shard[100:116], 2 * vals)
                     and float(win.shard.sum()) == float(2 * vals.sum()))
    heap = spml.shmem_pe(comm, heap_bytes=1 << 12)
    sym = heap.shmalloc(2, torch.float32)

    def prog(pe, _):
        pe = pe.local_set(sym, float(pe.my_pe()) + 5.0).barrier()
        pe = pe.put(sym, torch.full((2,), 3.0, device="cuda"), pe_of=lambda r, n: (r + 1) % n)
        old, pe = pe.fadd(sym, 1.0, pe_of=lambda r, n: (r + 1) % n, index=0)
        return pe, old[None]

    old = heap.epoch(prog, torch.zeros((1, 1), device="cuda"))
    res["heap"] = heap.read(sym).tolist() == [[4.0, 3.0]] and old.tolist() == [[3.0]]
    heap.finalize()
    cart = topo.CartTopology(comm, (1,), periods=(True,))
    x = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3)
    nb = topo.neighbor_allgather(cart, x)
    res["neighbor"] = tuple(nb.shape) == (2, 2, 3) and torch.equal(nb[0], x) \
        and torch.equal(nb[1], x)
    # a vector type tiling the buffer: 2 blocks of 2 floats, stride 4, an
    # instance every 8 floats (half the bytes are packed)
    vec = dt.create_resized(dt.create_vector(2, 2, 4, dt.FLOAT), 0, 32).commit()
    n = PACK_BYTES // 4
    count = n // 8
    gen = torch.Generator(device="cuda").manual_seed(9)
    src = torch.randn(n, generator=gen, device="cuda")
    packed = convertor.device_pack(src, vec, count)
    host = convertor.pack(src.cpu().numpy(), vec, count)
    same_pack = bool((packed.cpu().numpy().view(np.uint8) == host).all())
    out = torch.zeros_like(src)
    convertor.device_unpack(packed, vec, count, out)
    want = np.zeros(n, np.float32)
    convertor.unpack(host, vec, count, out=want)
    same_unpack = bool((out.cpu().numpy() == want).all())
    moved = 2 * packed.numel() * packed.element_size()  # read once, written once
    pack_ms = _event_ms(torch, lambda: convertor.device_pack(src, vec, count), reps=20)
    unpack_ms = _event_ms(torch, lambda: convertor.device_unpack(packed, vec, count, out),
                          reps=20)
    res["pack"] = {"source_bytes": n * 4, "packed_bytes": packed.numel() * 4,
                   "pack_us": pack_ms * 1e3, "pack_gb_per_s": moved / pack_ms / 1e6,
                   "unpack_us": unpack_ms * 1e3, "unpack_gb_per_s": moved / unpack_ms / 1e6,
                   "equal_to_host_pack": same_pack, "equal_to_host_unpack": same_unpack}
    print(json.dumps({"device_plane": res, "card": card_line}))
    if not (res["window"] and res["heap"] and res["neighbor"] and same_pack and same_unpack):
        raise SystemExit(f"the device plane at one rank gave a wrong result: {res}")
    return res


def _in_threads(n, fn, timeout):
    """fn(r) in n threads; the results by rank, or the first error."""
    import threading

    results, excs = [None] * n, [None] * n

    def main(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e

    threads = [threading.Thread(target=main, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise SystemExit("host plane: a rank hung")
    for e in excs:
        if e is not None:
            raise e
    return results


def _tcp_run(n, prog, timeout, kwargs_by_rank=None):
    """prog(proc) on an n-rank TcpProc universe in threads over loopback;
    rank 0 binds the coordinator on port 0.  ``kwargs_by_rank[r]`` are
    rank r's constructor overrides (``sm``, ``sm_boot_id``, ...)."""
    import threading

    from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

    ready, addr = threading.Event(), [None]

    def publish(a):
        addr[0] = a
        ready.set()

    def rank(r):
        kw = dict((kwargs_by_rank or {}).get(r, {}), timeout=timeout)
        if r == 0:
            proc = TcpProc(0, n, coordinator=("127.0.0.1", 0), on_coordinator_bound=publish,
                           **kw)
        else:
            if not ready.wait(timeout):
                raise SystemExit("host plane: no coordinator address")
            proc = TcpProc(r, n, coordinator=addr[0], **kw)
        try:
            return prog(proc)
        finally:
            proc.close()

    return _in_threads(n, rank, timeout)


def _host_moe_inputs(np, n, tokens):
    """The host-plane MoE's experts and tokens at the headline width, from
    HOST_MOE_SEED (numpy; every rank takes its expert and its tokens)."""
    D, F = HEADLINE["d_model"], HEADLINE["d_ff"]
    rng = np.random.default_rng(HOST_MOE_SEED)
    full = {"router": rng.standard_normal((D, n), dtype=np.float32) * D ** -0.5,
            "w_in": rng.standard_normal((n, D, F), dtype=np.float32) * D ** -0.5,
            "w_out": rng.standard_normal((n, F, D), dtype=np.float32) * F ** -0.5}
    return full, rng.standard_normal((n * tokens, D), dtype=np.float32)


def _host_moe_check(torch, moe, full, x_all, ys, keeps, n, tokens) -> dict:
    """Every rank's ``y`` and ``keep`` (gathered) against
    ``moe_reference_dense`` over all tokens on the card, and the reference's
    kept mask (first come, first served per (block, expert))."""
    cap = max(1, int(HOST_MOE_CAPACITY * tokens / n))
    full_t = moe.moe_params_from_numpy(full, device="cuda")
    xa = torch.from_numpy(x_all).to("cuda")
    dense = moe.moe_reference_dense(full_t, xa, n, cap, block_tokens=tokens)
    expert = torch.argmax(torch.softmax(xa @ full_t["router"], dim=-1), dim=-1)
    blocks = torch.nn.functional.one_hot(expert, n).reshape(n, tokens, n)
    keep_ref = (((torch.cumsum(blocks, dim=1) - 1) * blocks).sum(-1) < cap).reshape(-1)
    y_all = torch.cat([torch.as_tensor(v) for v in ys]).to("cuda")
    keep_all = torch.cat([torch.as_tensor(v) for v in keeps]).to("cuda")
    return {"rel_err": float((y_all - dense).abs().max() / dense.abs().max()),
            "keep_equal": bool(torch.equal(keep_all, keep_ref)),
            "kept_total": int(keep_all.sum()), "finite": bool(torch.isfinite(y_all).all()),
            "cap": cap}


def _moe_ok(res) -> bool:
    return res["rel_err"] <= MOE_REL_TOL and res["keep_equal"] and res["finite"]


def _host_plane_prog(torch, np, zmpi, torch_sum, moe_case=None):
    """The per-rank body of check_host_plane: rank 0's µs per call (a
    barrier before each call), and exact checks against numpy.  With
    ``moe_case`` (experts, tokens), one ``moe_host_ffn`` call at the
    host-moe width, experts on the card, held by rank 0 against the
    dense reference."""
    def timed(ep, fn, reps):
        times, out = [], None
        for _ in range(reps):
            ep.barrier()
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
        return out, times[len(times) // 2]

    def prog(ep):
        r, n = ep.rank, ep.size
        us = {}
        _, us["barrier"] = timed(ep, ep.barrier, HOST_REPS)
        for label, (nbytes, reps) in HOST_SIZES.items():
            count = nbytes // 8
            x = torch.from_numpy(np.arange(count, dtype=np.int64) * (r + 1) + r)
            got, us[f"allreduce_{label}"] = timed(ep, lambda: ep.allreduce(x, torch_sum), reps)
            want = np.arange(count, dtype=np.int64) * (n * (n + 1) // 2) + n * (n - 1) // 2
            if not (isinstance(got, torch.Tensor) and got.dtype == torch.int64
                    and np.array_equal(got.numpy(), want)):
                raise SystemExit(f"host plane: allreduce {label} is wrong on rank {r}")
        blocks = [torch.full((128,), 1000 * r + d, dtype=torch.int64) for d in range(n)]
        got, us["alltoall_1KiB"] = timed(ep, lambda: ep.alltoall(blocks), HOST_REPS)
        if [int(b[0]) for b in got] != [1000 * s + r for s in range(n)]:
            raise SystemExit(f"host plane: alltoall is wrong on rank {r}")
        small = torch.full((128,), r + 1, dtype=torch.int64)
        got, us["iallreduce_1KiB"] = timed(
            ep, lambda: ep.iallreduce(small, torch_sum).wait(HOST_TIMEOUT_S), HOST_REPS)
        if not bool((got == n * (n + 1) // 2).all()):
            raise SystemExit(f"host plane: iallreduce is wrong on rank {r}")
        got, us["bcast_1KiB"] = timed(
            ep, lambda: ep.bcast(small if r == n - 1 else None, root=n - 1), HOST_REPS)
        if not bool((got == n).all()):
            raise SystemExit(f"host plane: bcast is wrong on rank {r}")
        big = torch.arange(HOST_P2P_BYTES // 4, dtype=torch.float32)

        def p2p():
            if r == 0:
                ep.send(big, 1, tag=77)
            elif r == 1:
                got = ep.recv(0, tag=77, timeout=HOST_TIMEOUT_S)
                if not torch.equal(got, big):
                    raise SystemExit("host plane: the 4 MiB message is wrong")

        _, us["p2p_4MiB"] = timed(ep, p2p, HOST_P2P_REPS)
        refused = None
        if hasattr(ep, "address_book") and r == 0:
            refused = []
            cuda = torch.ones(4, device="cuda")
            for call in (lambda: ep.send(cuda, 1, tag=78), lambda: ep.isend(cuda, 1, tag=78)):
                try:
                    call()
                    refused.append(None)
                except zmpi.errors.TypeError_ as e:
                    refused.append(str(e))
        moe_res = None
        if moe_case is not None:
            from zhpe_ompi_tpu_torch.models import moe

            full, x_all = moe_case
            tokens = HOST_MOE_TOKENS
            params = moe.moe_params_from_numpy(full, device="cuda", ep_rank=r)
            x = torch.from_numpy(x_all[r * tokens:(r + 1) * tokens]).to("cuda")
            ep.barrier()
            t0 = time.perf_counter()
            y, keep = moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ys, keeps = ep.gather(y.cpu(), root=0), ep.gather(keep.cpu(), root=0)
            if r == 0:
                moe_res = dict(_host_moe_check(torch, moe, full, x_all, ys, keeps, n,
                                               tokens), ms=ms)
        ep.barrier()
        return us, refused, moe_res

    return prog


# Phase 15's planes: the thread universe, then 4-rank TcpProc universes in
# this process's threads — per rank constructor overrides.  "tcp": sm off
# (every frame on the loopback wire); "sm": sm at its default (one boot
# id, the rings carry the data); "han": sm_boot_id pinned so ranks 0-1 and
# 2-3 are two emulated hosts (coll_han_enable auto engages); "numa": one
# boot id, sm_numa_id pinned to two domains of two ranks (three-level han).
HOST_TCP_PLANES = {
    "tcp": {r: {"sm": False} for r in range(HOST_RANKS)},
    "sm": {},
    "han": {r: {"sm_boot_id": "smoke-host-a" if r < 2 else "smoke-host-b"}
            for r in range(HOST_RANKS)},
    "numa": {r: {"sm_numa_id": "d0" if r < 2 else "d1"} for r in range(HOST_RANKS)},
}
HOST_COUNTERS = ("sm_bytes_sent", "tcp_bytes_sent", "sm_fallback_tcp_sends",
                 "coll_han_intra_bytes", "coll_han_inter_bytes", "han_flat_fallbacks",
                 "coll_han_numa_collectives", "coll_han_alltoall_collectives")


def check_host_plane(torch, np, card_line):
    """Phase 15: the host plane's collectives and messages on the thread
    universe and the four TcpProc planes of HOST_TCP_PLANES, exact against
    numpy, with rank 0's median µs per call and each plane's counters; a
    CUDA tensor sent by a TcpProc must raise dss's typed error; the han
    plane also runs moe_host_ffn against the dense reference; no ring file,
    poll thread, audit failure or han tag window may outlive a plane."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import han
    from zhpe_ompi_tpu_torch.coll import host as coll_host
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.pt2pt import groups, sm
    from zhpe_ompi_tpu_torch.pt2pt import tcp  # noqa: F401 - registers tcp_*
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse
    from zhpe_ompi_tpu_torch.runtime import spc

    moe_case = _host_moe_inputs(np, HOST_RANKS, HOST_MOE_TOKENS)
    calls = {"ring": 0, "numa_allreduce": 0, "numa_bcast": 0, "numa_barrier": 0}
    patched = [(coll_host, "_allreduce_ring", "ring"),
               (han, "_allreduce_numa", "numa_allreduce"),
               (han, "_bcast_numa", "numa_bcast"),
               (han, "_barrier_numa", "numa_barrier")]
    saved = []
    for mod, name, key in patched:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        setattr(mod, name, counted)
    res = {"large_msg": mca_var.get("host_coll_large_msg"),
           "tcp_eager_limit": mca_var.get("tcp_eager_limit"),
           "sm_ring_bytes": mca_var.get("sm_ring_bytes"),
           "sm_max_frag": mca_var.get("sm_max_frag")}
    try:
        for plane in ("thread", *HOST_TCP_PLANES):
            prog = _host_plane_prog(torch, np, zmpi, zmpi.SUM,
                                    moe_case if plane == "han" else None)
            for k in calls:
                calls[k] = 0
            before = {k: spc.read(k) for k in HOST_COUNTERS}
            t0 = time.perf_counter()
            if plane == "thread":
                uni = LocalUniverse(HOST_RANKS)
                try:
                    out = uni.run(prog, timeout=HOST_TIMEOUT_S)
                finally:
                    uni.close()
            else:
                out = _tcp_run(HOST_RANKS, prog, HOST_TIMEOUT_S, HOST_TCP_PLANES[plane])
            res[plane] = {"us_per_call": out[0][0], "s": time.perf_counter() - t0,
                          "ring_calls": calls["ring"],
                          "numa_calls": {k: v for k, v in calls.items() if k != "ring"},
                          "counters": {k: spc.read(k) - before[k] for k in HOST_COUNTERS},
                          "cuda_send_refused": out[0][1], "moe": out[0][2],
                          "leftovers": [*sm.orphaned_ring_files(), *sm.live_poll_threads(),
                                        *sm.segment_audit_failures(),
                                        *groups.leaked_tag_windows()]}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(json.dumps({"host_plane": res, "card": card_line}))
    # the two sizes above host_coll_large_msg take the ring on every rank,
    # once per timed call, wherever the allreduce is flat
    want_ring = HOST_RANKS * sum(reps for nbytes, reps in HOST_SIZES.values()
                                 if nbytes >= res["large_msg"])
    for plane in ("thread", "tcp", "sm"):
        if res[plane]["ring_calls"] != want_ring:
            raise SystemExit(f"host plane ({plane}): {res[plane]['ring_calls']} ring "
                             f"allreduces, expected {want_ring}")
    for plane in HOST_TCP_PLANES:
        got = res[plane]
        refused = got["cuda_send_refused"]
        if not (refused and all(m is not None and ".cpu()" in m for m in refused)):
            raise SystemExit(f"host plane ({plane}): TcpProc sent a CUDA tensor: {refused}")
        if got["leftovers"]:
            raise SystemExit(f"host plane ({plane}): left behind {got['leftovers']}")
    c = {plane: res[plane]["counters"] for plane in HOST_TCP_PLANES}
    if c["tcp"]["sm_bytes_sent"] != 0:
        raise SystemExit(f"host plane (tcp): ring bytes with sm off: {c['tcp']}")
    # sm: the rings carry the data; the wire only the modex frames
    if not (c["sm"]["sm_bytes_sent"] > HOST_RANKS * (64 << 20)
            and c["sm"]["tcp_bytes_sent"] < 16 << 10 and c["sm"]["sm_fallback_tcp_sends"] == 0):
        raise SystemExit(f"host plane (sm): the rings did not carry the data: {c['sm']}")
    if not (c["han"]["coll_han_intra_bytes"] > 0 and c["han"]["coll_han_inter_bytes"] > 0
            and c["han"]["han_flat_fallbacks"] == 0):
        raise SystemExit(f"host plane (han): the two-level schedules did not run: {c['han']}")
    moe_res = res["han"]["moe"]
    if not (moe_res and _moe_ok(moe_res)
            and c["han"]["coll_han_alltoall_collectives"] >= 2 * HOST_RANKS):
        raise SystemExit(f"host plane (han): moe_host_ffn is wrong or flat: {moe_res}")
    numa = res["numa"]["numa_calls"]
    if not (all(v > 0 for v in numa.values())
            and c["numa"]["coll_han_numa_collectives"] >= sum(numa.values())
            and c["numa"]["han_flat_fallbacks"] == 0):
        raise SystemExit(f"host plane (numa): the three-level schedules did not run: "
                         f"{numa} {c['numa']}")
    print(f"host plane: rank 0 µs per call by plane "
          f"{ {p: res[p]['us_per_call'] for p in ('thread', *HOST_TCP_PLANES)} }; "
          f"han moe_host_ffn {moe_res['ms']} ms, rel err {moe_res['rel_err']} on {card_line}")
    return res


def _host_rendezvous(srv, size):
    """The launcher-hosted coordinator of ZMPI_COORD_EXTERNAL: gather every
    rank's modex card, hand back the address book."""
    from zhpe_ompi_tpu_torch.pt2pt import tcp
    from zhpe_ompi_tpu_torch.utils import dss

    book, conns = [None] * size, []
    for _ in range(size):
        conn, _ = srv.accept()
        rank, card = dss.unpack(tcp._recv_frame(conn))
        book[rank] = card
        conns.append(conn)
    for conn in conns:
        tcp._send_frame(conn, dss.pack(book))
        conn.close()


def host_moe_child() -> int:
    """Phase 16's child: one rank of the host-plane MoE job (see the module
    doc), through ``zmpi.host_init``; prints one JSON line."""
    import numpy as np
    import torch

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import moe
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm
    from zhpe_ompi_tpu_torch.runtime import spc

    torch.backends.cuda.matmul.allow_tf32 = False
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r, n, T = ep.rank, ep.size, HOST_MOE_TOKENS
    full, x_all = _host_moe_inputs(np, n, T)
    params = moe.moe_params_from_numpy(full, device="cuda", ep_rank=r)
    x = torch.from_numpy(x_all[r * T:(r + 1) * T]).to("cuda")
    counted = _kernel_counters(fused_norm, fa)
    moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)  # warm-up
    for fn in counted.values():
        fn.launches = 0
    wire0, ring0 = spc.read("tcp_bytes_sent"), spc.read("sm_bytes_sent")
    times = []
    for _ in range(HOST_MOE_CALLS):
        ep.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, keep = moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # the barriers' frames are counted too: a few hundred bytes a call
    wire = (spc.read("tcp_bytes_sent") - wire0) / HOST_MOE_CALLS
    ring = (spc.read("sm_bytes_sent") - ring0) / HOST_MOE_CALLS
    split: dict = {}
    for _ in range(HOST_MOE_CALLS):
        ep.barrier()
        moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY, timings=split)
    launches = {name: fn.launches for name, fn in counted.items()}
    times.sort()
    out = {"rank": r, "size": n, "sm": ep._sm_seg is not None,
           "median_ms": times[len(times) // 2], "ms": times,
           "split_ms": {k: v * 1e3 / HOST_MOE_CALLS for k, v in split.items()},
           "launches": launches, "wire_bytes_sent_per_call": wire,
           "ring_bytes_sent_per_call": ring, "kept": int(keep.sum())}
    ys = ep.gather(y.cpu(), root=0)
    keeps = ep.gather(keep.cpu(), root=0)
    if r == 0:
        out.update(_host_moe_check(torch, moe, full, x_all, ys, keeps, n, T))
    zmpi.host_finalize()
    print(json.dumps(out))
    if r == 0 and not _moe_ok(out):
        return 1
    if any(launches.values()):
        return 1
    return 0


def drive_host_moe(torch, card_line, sm=None):
    """One phase-16 job: start HOST_MOE_RANKS children of this script with
    the ZMPI_* contract (this process hosts the rendezvous) and collect
    their results; any child that fails or prints nothing fails the smoke.
    ``sm`` None leaves ``ZMPI_MCA_sm`` unset (the default: the rings carry
    the alltoalls), else exports it."""
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(HOST_MOE_RANKS)
    srv.settimeout(HOST_TIMEOUT_S)
    host, port = srv.getsockname()
    env = dict(os.environ, ZMPI_SIZE=str(HOST_MOE_RANKS), ZMPI_COORD_HOST=host,
               ZMPI_COORD_PORT=str(port), ZMPI_COORD_EXTERNAL="1")
    for k in ("ZMPI_PMIX", "ZMPI_FT", "ZMPI_MCA_sm"):
        env.pop(k, None)
    if sm is not None:
        env["ZMPI_MCA_sm"] = str(sm)
    label = "sm unset" if sm is None else f"ZMPI_MCA_sm={sm}"
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--host-moe-child"],
        env=dict(env, ZMPI_RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(HOST_MOE_RANKS)]
    try:
        _host_rendezvous(srv, HOST_MOE_RANKS)
        outs = [c.communicate(timeout=HOST_TIMEOUT_S) for c in children]
    finally:
        srv.close()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    results = []
    for r, (c, (out, err)) in enumerate(zip(children, outs)):
        lines = out.strip().splitlines()
        if c.returncode != 0 or not lines:
            raise SystemExit(f"host moe ({label}): rank {r} exited {c.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
        results.append(json.loads(lines[-1]))
    want_sm = sm is None or int(sm) != 0
    if any(x["sm"] != want_sm for x in results):
        raise SystemExit(f"host moe ({label}): a rank's sm segment is not as configured")
    if want_sm and any(x["ring_bytes_sent_per_call"] <= 0 for x in results):
        raise SystemExit(f"host moe ({label}): the rings did not carry the alltoalls")
    res = {"config": label, "ranks": results, "s": time.perf_counter() - t0,
           "median_ms": max(x["median_ms"] for x in results)}
    print(json.dumps({"host_moe": res, "card": card_line}))
    head = results[0]
    print(f"host moe ({label}): moe_host_ffn median {res['median_ms']} ms (slowest rank), "
          f"rank 0 split {head['split_ms']} ms, ring {head['ring_bytes_sent_per_call']} B "
          f"and wire {head['wire_bytes_sent_per_call']} B per call, rel err "
          f"{head['rel_err']} (tol {MOE_REL_TOL}), kept {head['kept_total']} of "
          f"{HOST_MOE_RANKS * HOST_MOE_TOKENS} on {card_line}")
    return res


def drive_host_moe_both(torch, card_line) -> dict:
    """Phase 16 in both configurations, one after the other (each in
    processes of its own): sm at its default, then sm off."""
    return {"sm_default": drive_host_moe(torch, card_line),
            "sm_off": drive_host_moe(torch, card_line, sm=0)}


def drive_runtime(torch, np, dist, tfm, fused_norm, fa, card_line):
    """Phase 5: the MPI entry point, the monitored train step, the ULFM
    methods on CUDA tensors, the device probe, the bench, finalize."""
    import contextlib
    import io

    from zhpe_ompi_tpu_torch import bench
    from zhpe_ompi_tpu_torch.comm.communicator import Communicator
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
    from zhpe_ompi_tpu_torch.runtime import init as rt
    from zhpe_ompi_tpu_torch.runtime import spc

    if dist.is_initialized():
        raise SystemExit("runtime phase: a process group is already up")
    mca_var.set_var("hook_comm_method_enable", True)
    mca_var.set_var("coll_monitoring_enable", True)
    hook_err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(hook_err):
        world = rt.init()
    init_ms = (time.perf_counter() - t0) * 1e3
    hook_lines = [ln for ln in hook_err.getvalue().splitlines() if "comm_method" in ln]
    for ln in hook_lines:
        print(f"hook: {ln}")
    cs = rt.comm_self()
    print(f"runtime.init(): {init_ms} ms; world {world.name} rank {world.rank} of "
          f"{world.size} on {world.backend}, self {cs.name} size {cs.size} on "
          f"{cs.backend}; {card_line}")
    if not (world.size == 1 and world.backend == "nccl" and cs.size == 1
            and cs.backend == "nccl" and dist.is_initialized()):
        raise SystemExit("runtime.init() did not make a one-rank NCCL world")
    want_hook = "comm_method: world of 1 rank(s) [0] on cuda device(s), backend nccl"
    if not (hook_lines and want_hook in hook_lines[0]
            and sum("-> tuned" in ln for ln in hook_lines) == 12):
        raise SystemExit("the comm_method hook did not print the world's layout")

    mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1, "sp": 1})
    dp_comm = Communicator(mesh.get_group("dp"), name="dp")
    tp_comm = world.split([0], name="tp")
    sp_comm = Communicator(mesh.get_group("sp"), name="sp_mesh").dup(name="sp")
    one = torch.ones(4, device="cuda")
    for comm in (dp_comm, tp_comm, sp_comm):
        if comm.allreduce(one).tolist() != [1.0] * 4 or comm.backend != "nccl":
            raise SystemExit(f"{comm.name}: a one-rank NCCL allreduce went wrong")

    # the monitored train step
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    params, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    L = cfg.n_layers
    n_dp = len(params) + 1                                   # grads, loss
    n_tp = len(tfm._TP_REPLICATED & set(params)) + 1 + 4 * L  # + f/g pair
    want_calls = {"coll_allreduce_calls": n_dp + n_tp,
                  "comm_dp_coll_calls": n_dp, "comm_tp_coll_calls": n_tp}
    counted = _kernel_counters(fused_norm, fa)
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    losses = []
    for i in range(3):
        for fn in counted.values():
            fn.launches = 0
        before = spc.snapshot()
        params, loss = step(params, tokens, targets)
        loss = float(loss)
        after = spc.snapshot()
        launches = {name: fn.launches for name, fn in counted.items()}
        calls = {k: after.get(k, 0) - before.get(k, 0) for k in want_calls}
        print(f"runtime step {i}: loss {loss}, launches {launches} (expected "
              f"{want}), allreduce calls {calls} (expected {want_calls})")
        if launches != want:
            raise SystemExit("the monitored step did not launch the kernels as expected")
        if calls != want_calls:
            raise SystemExit("coll_allreduce_calls did not rise by the step's "
                             "Communicator.allreduce calls")
        losses.append(loss)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"runtime: the loss did not fall with finite values: {losses}")
    del params
    mca_var.unset("coll_monitoring_enable")

    # ULFM on CUDA tensors
    rv = world.dup(name="rv")
    rv.set_errhandler(errh.ERRORS_RETURN)
    rv.allreduce(one)
    rv.revoke()
    try:
        rv.allreduce(one)
        raise SystemExit("an allreduce on a revoked communicator did not raise")
    except errors.Revoked as e:
        print(f"revoked: allreduce raised Revoked ({e})")
    shrunk = rv.shrink(failed=[])
    got = shrunk.allreduce(torch.full((4,), 2.0, device="cuda")).tolist()
    agreed = (rv.agree(True), shrunk.agree(True), shrunk.agree(False))
    print(f"shrink(failed=[]): allreduce {got}, revoked {shrunk.is_revoked()}; "
          f"agree True/True/False on revoked/shrunk/shrunk: {agreed}")
    if got != [2.0] * 4 or shrunk.is_revoked() or agreed != (True, True, False):
        raise SystemExit("shrink or agree went wrong on CUDA tensors")

    # the device probe
    probes = {}
    t0 = time.perf_counter()
    kind, detail = mesh_mod.probe_device_plane()
    probes["ok"] = (kind, detail, time.perf_counter() - t0)
    for wedge in ("all", str(world.rank)):
        t0 = time.perf_counter()
        env = dict(os.environ, ZMPI_DEVICE_WEDGE=wedge)
        kind, detail = mesh_mod.probe_device_plane(timeout=30, deadline=12, env=env,
                                                   rank=world.rank)
        probes[f"wedge={wedge}"] = (kind, detail, time.perf_counter() - t0)
    print(json.dumps({"device_probe": probes, "card": card_line}))
    if probes["ok"][0] != "ok":
        raise SystemExit(f"probe_device_plane() did not answer: {probes['ok']}")
    print(f"device probe: ok in {probes['ok'][2]} s; the child's seconds by stage "
          f"{json.loads(probes['ok'][1])['seconds']}")
    for key, (kind, _, secs) in probes.items():
        if key != "ok" and (kind not in ("deadline", "hung") or secs > 35):
            raise SystemExit(f"the wedged probe ({key}) was not caught: {kind}")

    # the bench, on fresh communicators with monitoring off
    b_dp, b_tp = bench.mesh_comms()
    name = bench.card_name(torch.cuda.current_device())
    peak, known = bench.card_peak(name)
    t0 = time.perf_counter()
    result = bench.run(b_dp, b_tp, peak, known)
    result["card"] = card_line
    result["bench_s"] = time.perf_counter() - t0
    print(json.dumps({"bench": result}))
    for r in (result, result["remat_off"]):
        print(f"bench remat={r is result}: framework {r['step_ms']} ms "
              f"({r['value']} tokens/s), plain {r['plain_step_ms']} ms "
              f"({r['plain_tokens_per_s']} tokens/s), vs_baseline "
              f"{r['vs_baseline']}, mfu {r['mfu']} on {card_line}")
        if not (math.isfinite(r["vs_baseline"]) and 0 < r["mfu"] < 1 and known):
            raise SystemExit("the bench's measurement is not sane")
    # one long-context step (the bench's configuration) between counts
    lc_cfg = tfm.Config(**{**HEADLINE, "seq": bench.LONG_CONTEXT["seq"]},
                        dtype=torch.bfloat16, ce_chunk=CE_CHUNK, remat=True)
    lc_step, _ = tfm.make_train_step(lc_cfg, b_dp, b_tp, lr=bench.LR)
    lc_params, lc_tok, lc_tgt = _train_inputs(torch, np, tfm, lc_cfg,
                                              batch=bench.LONG_CONTEXT["batch"])
    for fn in counted.values():
        fn.launches = 0
    _, lc_loss = lc_step(lc_params, lc_tok, lc_tgt)
    lc_loss = float(lc_loss)
    lc_launches = {name: fn.launches for name, fn in counted.items()}
    lc_want = {"layernorm_fwd": 4 * L + 1, "layernorm_bwd": 2 * L + 1,
               "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
               "flash_attention_bwd_dkv": L}
    print(f"long-context step (seq {lc_cfg.seq}, batch {bench.LONG_CONTEXT['batch']}, "
          f"remat): loss {lc_loss}, launches {lc_launches} (expected {lc_want})")
    if lc_launches != lc_want or not math.isfinite(lc_loss):
        raise SystemExit("the long-context step did not launch the kernels as expected")
    del lc_params
    print(f"bench long context: seq {result['long_ctx_seq']}, "
          f"{result['long_ctx_step_ms']} ms, {result['long_ctx_tokens_per_s']} "
          f"tokens/s, mfu {result['long_ctx_mfu']} on {card_line}")

    fin_err = io.StringIO()
    with contextlib.redirect_stderr(fin_err):
        rt.finalize()
    for ln in fin_err.getvalue().splitlines():
        if "comm_method" in ln:
            print(f"hook: {ln}")
    mca_var.unset("hook_comm_method_enable")
    if dist.is_initialized() or not rt.is_finalized():
        raise SystemExit("finalize() left the process group up")
    return launches, lc_launches, {"init_ms": init_ms,
                                   "allreduce_calls_per_step": want_calls,
                                   "bench": result}


def bench_after_profiling(torch, tfm, dp_comm, tp_comm, runtime, card_line):
    """The bench's remat-off pair once more, in this process after the
    profiled phases, beside phase 5's reading taken before them: how much
    the process's history moves the host-bound step."""
    from zhpe_ompi_tpu_torch import bench

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    peak, known = bench.card_peak(bench.card_name(torch.cuda.current_device()))
    late = bench.measure_pair(cfg, dp_comm, tp_comm, BATCH, peak, known)
    early = runtime["bench"]["remat_off"]
    print(f"bench remat off after the profiled phases: framework {late['step_ms']} ms, "
          f"plain {late['plain_step_ms']} ms, vs_baseline {late['vs_baseline']} "
          f"(before them: {early['step_ms']}, {early['plain_step_ms']}, "
          f"{early['vs_baseline']}) on {card_line}")
    return {k: late[k] for k in ("step_ms", "plain_step_ms", "vs_baseline",
                                 "pair_ratios")}


def check_ring_recurrence(torch, ra):
    """The ring's block recurrence at full width on the card: the sequence
    split into RING_BLOCKS blocks; for each virtual rank, the port's own
    step update (``_contiguous_step``) over the blocks in the order the
    ring delivers them (``_ring_sources``), then the normalisation,
    against ``_block_attention_single`` on the whole sequence; the same
    for the zigzag layout (``_zigzag_step``)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h
    n = RING_BLOCKS
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    want = ra._block_attention_single(q, k, v, True)
    sl = S // n
    # the port's own per-step updates, in the order the ring delivers the
    # blocks (models/ring_attention.py)

    def contiguous(r):
        qf = q[:, r * sl:(r + 1) * sl].float() * hd ** -0.5
        state = ra._init(q, sl)
        for src in ra._ring_sources(r, n):
            state = ra._contiguous_step(qf, k[:, src * sl:(src + 1) * sl],
                                        v[:, src * sl:(src + 1) * sl], state, r, src,
                                        True)
        return ra._finish(*state[1:]).to(q.dtype)

    qz, kz, vz = (ra.zigzag_shard(t, n) for t in (q, k, v))
    c = sl // 2
    diag = torch.tril(torch.ones((c, c), dtype=torch.bool, device="cuda"))

    def zigzag(r):
        qf = qz[r].float() * hd ** -0.5
        sa, sb = ra._init(q, c), ra._init(q, c)
        for src in ra._ring_sources(r, n):
            sa, sb = ra._zigzag_step(qf[:, :c], qf[:, c:], kz[src], vz[src], sa, sb,
                                     r, src, diag)
        return torch.cat([ra._finish(*sa[1:]), ra._finish(*sb[1:])], 1).to(q.dtype)

    want_z = ra.zigzag_shard(want, n)
    result = {}
    for layout, fn, ref in (("contiguous", contiguous,
                             lambda r: want[:, r * sl:(r + 1) * sl]),
                            ("zigzag", zigzag, lambda r: want_z[r])):
        errs, ms = [], []
        for r in range(n):
            errs.append(_max_err(fn(r), ref(r)))
            ms.append(_event_ms(torch, lambda: fn(r)))
        print(f"ring recurrence {layout} at {(B, S, h, hd)} bf16 causal, {n} blocks: "
              f"max|ring - single| per rank {errs} (tol {RING_TOL}), "
              f"ms per rank (CUDA events, host issue included) {ms}")
        if not max(errs) <= RING_TOL:
            raise SystemExit(f"the {layout} ring recurrence disagrees with "
                             "_block_attention_single")
        result[layout] = {"max_abs_err": max(errs), "ms_per_rank": ms}
    return result


def _one_rank_answer(torch, opname, x):
    """What each collective gives at one rank, from its MPI definition (an
    exscan's rank 0 result, undefined in MPI, is zeros here)."""
    if opname == "barrier":
        return torch.zeros((), dtype=torch.int32, device=x.device)
    if opname == "exscan":
        return torch.zeros_like(x)
    if opname == "scatter":
        return x.reshape(-1)
    return x


def check_collectives(torch, comm, zmpi, tuned, nccl, mca_var):
    """Every entry of ``comm.coll``, and every algorithm of
    coll/algorithms.py forced through ZMPI_MCA_coll_tuned_<op>_algorithm,
    on a one-rank NCCL communicator with CUDA tensors of f32, bf16 and
    int32: each must give the one-rank MPI answer.  Then the host µs per
    call of ``comm.allreduce`` (tuned, then nccl) and of the nccl
    component's allreduce alone."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    base = torch.randn((4, 6), generator=gen, device="cuda")
    checked = 0

    def run(opname, x, dtype):
        nonlocal checked
        if opname in ("allreduce", "reduce", "reduce_scatter",
                      "reduce_scatter_block", "scan", "exscan"):
            outs = [getattr(comm, opname)(x, op) for op in (zmpi.SUM, zmpi.PROD,
                                                            zmpi.MAX)]
        elif opname == "barrier":
            outs = [comm.barrier()]
        elif opname == "alltoallv":
            outs = [comm.alltoallv(x[None], [[x.shape[0]]])[0]]
        elif opname == "allgatherv":
            outs = [comm.allgatherv(x, [x.shape[0]])]
        elif opname in ("bcast", "gather", "scatter"):
            outs = [getattr(comm, opname)(x, root=0)]
        else:
            outs = [getattr(comm, opname)(x)]
        want = _one_rank_answer(torch, opname, x)
        for got in outs:
            if not (got.device == x.device and got.shape == want.shape
                    and torch.equal(got, want)):
                raise SystemExit(f"{opname} on {dtype} at one rank gave {got}, "
                                 f"not {want}")
            checked += 1

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = (base * 4).to(dtype)
        for opname in comm.coll:
            run(opname, x, dtype)
        for opname, table in tuned._ALG_TABLES.items():
            var = f"coll_tuned_{opname}_algorithm"
            for algname in table:
                os.environ["ZMPI_MCA_" + var] = algname
                mca_var.unset(var)  # re-resolve the variable from the environment
                if mca_var.get(var) != algname:
                    raise SystemExit(f"{var} did not take {algname} from the environment")
                run(opname, x, dtype)
            del os.environ["ZMPI_MCA_" + var]
            mca_var.unset(var)
    print(f"collectives: {checked} one-rank results checked (every coll entry and "
          f"every forced algorithm, f32, bf16 and int32)")
    # tuned's own host cost: the same allreduce through ``comm`` and through
    # a communicator composed without tuned (nccl serves it straight, the
    # route before tuned existed), in turns, each side first in every
    # other round, so that both see the same host
    mca_var.set_var("coll", "^tuned")
    try:
        direct = comm.dup(name="direct")
        if direct.coll["allreduce"][1] != "nccl":
            raise SystemExit(f"excluding tuned left {direct.coll['allreduce'][1]}")
    finally:
        mca_var.unset("coll")
    small = [torch.ones(1024, device="cuda") for _ in range(4)]
    sides = {"comm.allreduce (tuned -> nccl)": comm, "comm.allreduce without tuned": direct}
    turns = {name: [] for name in sides}
    for i in range(HOST_US_TURNS):
        for name in (list(sides) if i % 2 == 0 else list(sides)[::-1]):
            c = sides[name]
            turns[name].append(host_us_per_call(torch, lambda j: c.allreduce(small[j]), 4))
    tuned_us, direct_us = turns.values()
    host = {name: _quartiles(us) for name, us in turns.items()}
    host["tuned_faster_in_turns"] = sum(a < b for a, b in zip(tuned_us, direct_us))
    host["turns"] = HOST_US_TURNS
    host["nccl.allreduce alone"] = host_us_per_call(
        torch, lambda i: nccl.allreduce(comm, small[i], zmpi.SUM), 4)
    print(json.dumps({"allreduce_host_us_per_call": host,
                      "card": torch.cuda.get_device_name(0)}))
    return checked, host


def comm_allreduce_host_us(torch, zmpi, dist):
    """Host µs per call of ``Communicator.allreduce`` of 1024 floats on a
    one-rank NCCL communicator of the port found on sys.path."""
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            comm = zmpi.Communicator(name="host_us")
            small = [torch.ones(1024, device="cuda") for _ in range(4)]
            return host_us_per_call(torch, lambda i: comm.allreduce(small[i]), 4)
        finally:
            dist.destroy_process_group()


def _quartiles(xs) -> dict:
    xs = sorted(xs)
    n = len(xs)
    return {"median": xs[n // 2], "q1": xs[n // 4], "q3": xs[(3 * n) // 4],
            "min": xs[0], "max": xs[-1], "n": n}


def compare_host_us(other_root: str, pairs: int) -> dict:
    """``--wrapper-host-us`` for ``other_root`` and for the port beside
    this script, in ``pairs`` alternating pairs of processes; each
    version's median and quartiles of every number."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"other": os.path.abspath(other_root), "this": here}
    readings = {"other": [], "this": []}
    for i in range(pairs):
        for which in (("other", "this") if i % 2 == 0 else ("this", "other")):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--wrapper-host-us",
                 roots[which]], capture_output=True, text=True, check=False)
            if run.returncode != 0:
                raise SystemExit(f"--wrapper-host-us {roots[which]} failed:\n"
                                 f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            readings[which].append({"comm_allreduce": reading["comm_allreduce_host_us"],
                                    **reading["wrapper_host_us"]})
    this_faster = sum(t["comm_allreduce"] < o["comm_allreduce"]
                      for t, o in zip(readings["this"], readings["other"]))
    return ({which: {key: _quartiles([r[key] for r in rs]) for key in rs[0]}
             for which, rs in readings.items()}
            | {"comm_allreduce_this_faster_in_pairs": this_faster,
               "readings": readings, "roots": roots, "pairs": pairs})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    bench_after = args == ["--bench-after"]
    if bench_after:
        args = []
    if args and args[0] == "--compare-host-us" and len(args) in (2, 3):
        result = compare_host_us(args[1], int(args[2]) if len(args) == 3 else 10)
        print(json.dumps({"host_us_pairs": result, "card": _card_line()}))
        return 0
    if args == ["--host-moe-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return host_moe_child()
    if args == ["--host-plane"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        check_host_plane(torch, np, card_line)
        drive_host_moe_both(torch, card_line)
        print(card_line)
        return 0
    if args and (args[0] != "--wrapper-host-us" or len(args) != 2):
        print("usage: chip_smoke.py [--bench-after | --wrapper-host-us PORT_ROOT "
              "| --compare-host-us OTHER_ROOT [PAIRS] | --host-plane "
              "| --host-moe-child]", file=sys.stderr)
        return 2
    if args:
        # the wrappers' and the communicator's host cost of the port found
        # under PORT_ROOT (for example an unpacked older commit), on this card
        sys.path.insert(0, os.path.abspath(args[1]))
        _take_widths()
        import torch.distributed as dist

        import zhpe_ompi_tpu_torch as zmpi
        from zhpe_ompi_tpu_torch.ops import flash_attention as fa
        print(json.dumps({"wrapper_host_us": wrapper_host_us(torch, fa),
                          "comm_allreduce_host_us": comm_allreduce_host_us(
                              torch, zmpi, dist),
                          "port_root": args[1], "card": _card_line()}))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    _take_widths()
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.coll import nccl, tuned
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.models import ring_attention as ra
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_ce, fused_norm

    # the reference comparisons run f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card_line = _card_line()
    print(f"card: {card_line}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"kernel build: {time.perf_counter() - t0} s wall, per source {seconds}")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error",
                                       "warning")):
                print(f"  nvcc {name}: {line.strip()}")

    kernels = [check_layernorm(torch, F, fused_norm),
               check_layernorm_bwd(torch, fused_norm),
               check_flash(torch, F, fa), *check_flash_bwd(torch, F, fa)]
    ring = check_ring_recurrence(torch, ra)
    host_us = wrapper_host_us(torch, fa)
    print(json.dumps({"wrapper_host_us": host_us, "card": card_line}))
    for k in kernels:
        if k["name"] == "flash_attention_fwd":
            k["host_us_per_call"] = host_us["flash_fwd"]
        elif k["name"] == "flash_attention_bwd_dq":
            k["host_us_per_call"] = host_us["flash_bwd_dq"]
        elif k["name"] == "flash_attention_bwd_dkv":
            k["host_us_per_call"] = host_us["flash_bwd_dkv"]

    # the MPI entry point first: no process group is up yet, and the bench
    # it runs times steps in a process no profiler session has touched
    rt_launches, lc_launches, runtime = drive_runtime(torch, np, dist, tfm, fused_norm,
                                                      fa, card_line)
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            tp_comm = zmpi.Communicator(name="tp")
            dp_comm = tp_comm.dup(name="dp")
            sp_comm = tp_comm.dup(name="sp")
            probe = torch.ones(4, device="cuda")
            for comm in (tp_comm, dp_comm, sp_comm):
                # tuned serves every collective; its route for a SUM
                # allreduce is the native one, coll/nccl
                if ({c for _, c in comm.coll.values()} != {"tuned"}
                        or tuned.decide("allreduce", comm, probe, zmpi.SUM) != "xla"
                        or comm.backend != "nccl"):
                    raise SystemExit(f"{comm.name} did not compose tuned over "
                                     f"coll/nccl: {comm.coll}")
            checked, allreduce_host = check_collectives(torch, dp_comm, zmpi, tuned,
                                                        nccl, mca_var)
            fwd_launches, t_fwd, t_loss = drive_main_path(
                torch, np, tfm, fused_ce, fused_norm, fa, tp_comm)
            launches, steady, flash_loss = drive_train(torch, np, tfm, fused_norm, fa,
                                                       dp_comm, tp_comm)
            remat_launches, remat_steady = drive_remat(
                torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, steady)
            sp = drive_sp(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, sp_comm,
                          flash_loss)
            adam_launches, adam_steady, ckpt, adam_cmp = drive_adam(
                torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, steady, card_line)
            moe_pipe = check_moe_pipeline(torch, np, tp_comm, card_line)
            device_plane = check_device_plane(torch, np, dp_comm, card_line)
            late = (bench_after_profiling(torch, tfm, dp_comm, tp_comm, runtime,
                                          card_line) if bench_after else None)
        finally:
            dist.destroy_process_group()
    host_plane = check_host_plane(torch, np, card_line)
    host_moe = drive_host_moe_both(torch, card_line)
    for k in kernels:
        # ``launches``: per training step; the other paths beside it
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {
            "forward": fwd_launches[k["name"]] // (2 * N_BATCHES),
            "train": launches[k["name"]], "remat": remat_launches[k["name"]],
            **{label: sp[label][0][k["name"]] for label in sp},
            "runtime": rt_launches[k["name"]],
            "long_context": lc_launches[k["name"]],
            "adam": adam_launches[k["name"]]}
    steps = {"train": steady, "remat": remat_steady,
             **{label: sp[label][1] for label in sp}, "adam": adam_steady}
    print(json.dumps({"steps": steps, "card": card_line}))
    print(json.dumps({"kernels": kernels, "card": card_line,
                      "forward_s": t_fwd, "loss_fn_s": t_loss,
                      "train_step_median_ms": steady["median_ms"],
                      "ring_recurrence": ring, "collectives_checked": checked,
                      "allreduce_host_us_per_call": allreduce_host,
                      "runtime": runtime, "bench_after_profiling": late,
                      "checkpoint": ckpt, "adam_vs_plain": adam_cmp,
                      "moe_pipeline": moe_pipe, "device_plane": device_plane,
                      "host_plane": host_plane, "host_moe": host_moe,
                      "smoke_s": time.perf_counter() - t_start}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
