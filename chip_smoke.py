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
4. Drive the forward path at the flagship width (vocab 8192, d_model 1024,
   16 heads, d_ff 4096, 4 layers, seq 512, bf16, ce_chunk 1024, batch 16):
   numpy parameters in the JAX package's layout from a seed,
   ``params_from_numpy`` onto the card, a one-rank NCCL ``Communicator``
   as ``tp_comm``, and three batches scored through ``forward`` and
   ``loss_fn``.  The kernels' launch counts are set to 0 just before and
   read just after; each forward must launch the layernorm kernel 9 times
   and the flash kernel 4 times.  The losses must be finite and near
   ln(8192), and match the same forward with ``fused_ln=False,
   flash=False``; the logits product (bf16 operands, f32 result) must
   match both operands upcast to f32.  Then steady-state times of
   ``forward`` and ``loss_fn`` and a torch.profiler breakdown of
   ``loss_fn`` are printed.
5. Drive the training path at the same width: ``make_train_step`` with
   one-rank NCCL communicators as ``dp_comm`` and ``tp_comm``, five SGD
   steps on one repeated batch.  The launch counts are set to 0 just
   before each step and read just after; each step must launch the
   layernorm forward and backward kernels 9 times each and the flash
   forward, dq and dk/dv kernels 4 times each.  The losses must be finite
   and the last below the first.  One step on the kernel path and one on
   the plain path (``fused_ln=False, flash=False``) from the same
   parameters and batch must agree in loss and in every parameter's
   update.  Then the steady step time (median, quartiles) and tokens
   trained per second, the peak device memory, and a torch.profiler
   breakdown of one step are printed.
6. Print one ``{"kernels": [...]}`` line (``launches``: per training
   step), the card's line, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, with no result line, when no CUDA
device is present or when the port's package is not beside this script.

    python3 chip_smoke.py --wrapper-host-us PORT_ROOT

prints only the wrappers' host µs per call of the port under PORT_ROOT
(for example an older commit unpacked there), to compare two versions on
one card.
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

# flagship width (bench.py's headline config) and its batch per chip
HEADLINE = dict(vocab=8192, d_model=1024, n_heads=16, d_ff=4096, n_layers=4,
                seq=512)
BATCH = 16
CE_CHUNK = 1024
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

# Shapes at the flash kernels' edges, (shape, causal, strided): a long
# sequence, so the ring's mbarrier phases wrap many times (64 key or query
# tiles a block), and an S that is not a multiple of the forward's 128-row
# block nor of the dk/dv kernel's 128-key block.
EDGE_CASES = [((1, 4096, 2, 64), True, False), ((1, 4096, 2, 64), False, False),
              ((2, 192, 3, 64), True, False)]


# device function names of the port's kernels, as the profiler lists them
PORT_KERNELS = ("ln_fwd_", "ln_bwd_", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")


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


def _numpy_params(np, cfg, seed):
    """Parameters in the JAX package's init_params layout and scales,
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
    params = tfm.params_from_numpy(_numpy_params(np, cfg, seed=0), cfg)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                rng.integers(0, cfg.vocab, (BATCH, cfg.seq)))
               for _ in range(N_BATCHES)]
    results = []
    fused_norm.ln_fwd.launches = 0
    fa.flash_fwd.launches = 0
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
    launches = {"layernorm_fwd": fused_norm.ln_fwd.launches,
                "flash_attention_fwd": fa.flash_fwd.launches}
    n_forward = 2 * N_BATCHES
    want = {"layernorm_fwd": (2 * cfg.n_layers + 1) * n_forward,
            "flash_attention_fwd": cfg.n_layers * n_forward}
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


def drive_train(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm):
    """The training path: make_train_step at the headline width."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    plain_step, _ = tfm.make_train_step(
        replace(cfg, fused_ln=False, flash=False), dp_comm, tp_comm, lr=TRAIN_LR)
    params0 = tfm.params_from_numpy(_numpy_params(np, cfg, seed=0), cfg)
    rng = np.random.default_rng(2)
    tokens, targets = (torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                                       device="cuda") for _ in range(2))
    counted = {"layernorm_fwd": fused_norm.ln_fwd, "layernorm_bwd": fused_norm.ln_bwd,
               "flash_attention_fwd": fa.flash_fwd,
               "flash_attention_bwd_dq": fa.flash_bwd_dq,
               "flash_attention_bwd_dkv": fa.flash_bwd_dkv}
    L = cfg.n_layers
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    card = torch.cuda.get_device_name(0)

    params, losses = params0, []
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
        print(f"train step {i}: loss {loss} in {dt * 1e3} ms, launches {launches} "
              f"(expected {want}) on {card}")
        if launches != want:
            raise SystemExit("a training step did not launch every kernel as expected")
        losses.append(loss)
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if not (all(math.isfinite(x) for x in losses) and finite and losses[-1] < losses[0]):
        raise SystemExit(f"training did not lower the loss with finite values: {losses}")

    # one step on each path from the same parameters and batch
    new_k, loss_k = step(params0, tokens, targets)
    new_p, loss_p = plain_step(params0, tokens, targets)
    lerr = abs(float(loss_k) - float(loss_p))
    rel = {name: float((new_k[name] - p0 - (new_p[name] - p0)).norm()
                       / (new_p[name] - p0).norm())
           for name, p0 in params0.items()}
    print(f"train step, kernel path vs plain path: |loss diff| {lerr} "
          f"(tol {TRAIN_LOSS_TOL}), relative update difference {rel} "
          f"(tol {UPDATE_REL_TOL})")
    if not (lerr <= TRAIN_LOSS_TOL and all(r <= UPDATE_REL_TOL for r in rel.values())):
        raise SystemExit("the kernel path's training step disagrees with the plain path")
    del new_k, new_p

    # steady state: synchronized steps after two warm-up steps
    for _ in range(2):
        params, _ = step(params, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(STEADY_STEPS):
        t0 = time.perf_counter()
        params, loss = step(params, tokens, targets)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms.sort()
    n = len(ms)
    steady = {"steps": n, "median_ms": ms[n // 2], "q1_ms": ms[n // 4],
              "q3_ms": ms[3 * n // 4], "min_ms": ms[0], "max_ms": ms[-1],
              "tokens_per_s_trained": BATCH * cfg.seq / (ms[n // 2] / 1e3),
              "max_memory_allocated_bytes": peak}
    print(json.dumps({"train_steady_state": steady, "losses": losses,
                      "lr": TRAIN_LR, "card": card}))
    holder = {"params": params}

    def one_step():
        holder["params"], _ = step(holder["params"], tokens, targets)

    prof = profile_calls(torch, one_step, reps=2)
    print(json.dumps({"profile_train_step": prof, "card": card}))
    return launches, steady


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args and (args[0] != "--wrapper-host-us" or len(args) != 2):
        print("usage: chip_smoke.py [--wrapper-host-us PORT_ROOT]", file=sys.stderr)
        return 2
    if args:
        # the wrappers' host cost of the port found under PORT_ROOT (for
        # example an unpacked older commit), on this card
        sys.path.insert(0, os.path.abspath(args[1]))
        from zhpe_ompi_tpu_torch.ops import flash_attention as fa
        print(json.dumps({"wrapper_host_us": wrapper_host_us(torch, fa),
                          "port_root": args[1], "card": _card_line()}))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_ce, fused_norm

    # the reference comparisons run f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    host_us = wrapper_host_us(torch, fa)
    print(json.dumps({"wrapper_host_us": host_us, "card": card_line}))
    for k in kernels:
        if k["name"] == "flash_attention_fwd":
            k["host_us_per_call"] = host_us["flash_fwd"]
        elif k["name"] == "flash_attention_bwd_dq":
            k["host_us_per_call"] = host_us["flash_bwd_dq"]
        elif k["name"] == "flash_attention_bwd_dkv":
            k["host_us_per_call"] = host_us["flash_bwd_dkv"]

    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            tp_comm = zmpi.Communicator(name="tp")
            dp_comm = tp_comm.dup(name="dp")
            for comm in (tp_comm, dp_comm):
                if comm.coll["allreduce"][1] != "nccl" or comm.backend != "nccl":
                    raise SystemExit(f"{comm.name} did not compose coll/nccl: {comm.coll}")
            fwd_launches, t_fwd, t_loss = drive_main_path(
                torch, np, tfm, fused_ce, fused_norm, fa, tp_comm)
            launches, steady = drive_train(torch, np, tfm, fused_norm, fa,
                                           dp_comm, tp_comm)
        finally:
            dist.destroy_process_group()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in fwd_launches:
            k["launches_forward_phase"] = fwd_launches[k["name"]]
    print(json.dumps({"kernels": kernels, "card": card_line,
                      "forward_s": t_fwd, "loss_fn_s": t_loss,
                      "train_step_median_ms": steady["median_ms"]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
