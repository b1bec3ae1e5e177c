"""``models/lfm2_moe`` (the port's LFM2-MoE) against its plain reference
``models/lfm2_moe_reference``, and the RMS form of ``ops/fused_norm``.

On the CPU, at a tiny size (D 64, 4 q and 2 kv heads of 16, 8 experts of
32 with top-2, layers conv, conv, attention, conv, the first dense), on
seeded random weights:

- the port in float32 (the norm and attention kernels' plain versions, the
  grouped products' loop) against the reference: logits, loss and the
  gradient of every leaf;
- the expert share: the MoE layer's outputs at ``ep_rank`` 0..3 of
  ``ep_size`` 4 add up to the reference layer holding all experts;
- dropless: with a selection bias that sends every token to the same held
  experts, every pair is computed;
- the training step with ``timings``: every phase, and the MoE counters;
- the refusals of tensor and sequence parallelism;
- the grouped products with an empty group, and a held expert that no
  token selects: its weight gradients are zeros.

Tolerances.  Both sides compute in float32 and differ by the order of
their sums alone (the grouped products against per-expert products, the
plain flash recurrence against a softmax, the chunk-free loss): 2e-5 of the
largest magnitude for logits and each gradient, 1e-5 absolute for a loss of
order ln(V).  The same port computing in bfloat16 (8 mantissa bits, a
relative rounding of 2^-9 at each product) misses them by orders of
magnitude, which ``test_bf16_fails_the_tolerances`` checks, so they would
catch a loss of precision.

The ``cuda``-marked tests skip without a card: the RMS kernels against
their plain versions, forward and backward, a step whose backward reads
nothing to the host, and the empty-group cases on ``torch._grouped_mm``.  This file imports torch and the port only,
never jax::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_lfm2_moe.py
"""

import os
import tempfile
import types

import pytest
import torch
import torch.distributed as dist

from zhpe_ompi_tpu_torch.comm import communicator as comm_mod
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.models import lfm2_moe as lm
from zhpe_ompi_tpu_torch.models import lfm2_moe_reference as ref
from zhpe_ompi_tpu_torch.ops import fused_norm as fn
from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod

CFG = lm.Config(vocab=96, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                layer_types=("conv", "conv", "full_attention", "conv"), n_dense=1,
                d_ff=96, d_expert=32, n_experts=8, top_k=2, seq=16,
                dtype=torch.float32, fused_norm=True, flash=True, ce_chunk=32)
BATCH = 3
#: relative to the largest magnitude: float32 summation order
REL = 2e-5
#: absolute, on the loss (order ln V): float32 summation order
LOSS_ABS = 1e-5
PHASES = ("forward", "loss", "backward", "sync", "optimizer")


def _shapes(cfg):
    V, D, H, Hkv, hd = cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = len(cfg.layer_types)
    c = cfg.counts()
    F, Fe, E, held = cfg.d_ff, cfg.d_expert, cfg.n_experts, cfg.held
    return {
        "embed": ((V, D), 0.02), "op_norm": ((L, D), None), "ffn_norm": ((L, D), None),
        "final_norm": ((D,), None),
        "conv_in": ((c["conv"], D, 3 * D), D ** -0.5),
        "conv_w": ((c["conv"], D, cfg.conv_kernel), cfg.conv_kernel ** -0.5),
        "conv_out": ((c["conv"], D, D), D ** -0.5),
        "wq": ((c["attn"], D, H * hd), D ** -0.5), "wk": ((c["attn"], D, Hkv * hd), D ** -0.5),
        "wv": ((c["attn"], D, Hkv * hd), D ** -0.5),
        "wo": ((c["attn"], H * hd, D), (H * hd) ** -0.5),
        "q_norm": ((c["attn"], hd), None), "k_norm": ((c["attn"], hd), None),
        "dense_w13": ((c["dense"], D, 2 * F), D ** -0.5),
        "dense_w2": ((c["dense"], F, D), F ** -0.5),
        "router": ((c["moe"], D, E), D ** -0.5),
        "moe_w13": ((c["moe"], held, D, 2 * Fe), D ** -0.5),
        "moe_w2": ((c["moe"], held, Fe, D), Fe ** -0.5),
    }


def _params(cfg=CFG, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name in lm.LEAVES:
        shape, scale = _shapes(cfg)[name]
        if scale is None:  # gains near 1, so a wrong gain shows
            out[name] = 1 + 0.1 * torch.randn(shape, generator=g)
        else:
            out[name] = torch.randn(shape, generator=g) * scale
    return out


def _batch(cfg=CFG, seed=1):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (BATCH, cfg.seq), generator=g)
    return tok, torch.randint(0, cfg.vocab, (BATCH, cfg.seq), generator=g)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _port_and_ref(cfg):
    """(port, reference) readings of logits, loss and leaf gradients."""
    p = _params()
    tok, tgt = _batch()
    out = []
    for side in ("port", "ref"):
        leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
        if side == "port":
            logits = lm.forward(leaves, tok, cfg)
            loss = lm.loss_fn(leaves, tok, tgt, cfg)
        else:
            logits = ref.forward(leaves, tok, cfg)
            loss = ref.loss(leaves, tok, tgt, cfg)
        grads = torch.autograd.grad(loss, [leaves[n] for n in lm.LEAVES])
        out.append((logits.detach(), float(loss.detach()), dict(zip(lm.LEAVES, grads))))
    return out


def _gaps(cfg):
    (lp, sp, gp), (lr, sr, gr) = _port_and_ref(cfg)
    gaps = {"logits": _rel(lp, lr), "loss": abs(sp - sr)}
    gaps.update({f"grad {n}": _rel(gp[n], gr[n]) for n in lm.LEAVES})
    return gaps


def _misses(gaps):
    return {k: v for k, v in gaps.items() if v > (LOSS_ABS if k == "loss" else REL)}


def test_port_matches_reference():
    gaps = _gaps(CFG)
    assert not _misses(gaps), gaps


def test_reference_path_of_norm_and_attention_matches_reference():
    gaps = _gaps(lm.Config(**dict(vars(CFG), fused_norm=False, flash=False)))
    assert not _misses(gaps), gaps


def test_bf16_fails_the_tolerances():
    gaps = _gaps(lm.Config(**dict(vars(CFG), dtype=torch.bfloat16)))
    assert _misses(gaps)
    assert gaps["logits"] > 10 * REL


def _moe_inputs(seed=2):
    g = torch.Generator().manual_seed(seed)
    D, Fe, E = CFG.d_model, CFG.d_expert, CFG.n_experts
    h = torch.randn(BATCH, CFG.seq, D, generator=g)
    router = torch.randn(D, E, generator=g) * D ** -0.5
    w13 = torch.randn(E, D, 2 * Fe, generator=g) * D ** -0.5
    w2 = torch.randn(E, Fe, D, generator=g) * Fe ** -0.5
    return h, router, w13, w2


def _share(cfg, h, router, w13, w2, bias=None, tally=None):
    held = cfg.held
    lo = cfg.ep_rank * held
    w = {"router": router, "moe_w13": w13[lo:lo + held], "moe_w2": w2[lo:lo + held]}
    return lm.moe_ffn(h, w, cfg, bias, tally)


def test_expert_shares_add_up_to_the_whole_layer():
    h, router, w13, w2 = _moe_inputs()
    whole = ref.moe_layer(h, router, w13, w2, CFG)
    parts = [_share(lm.Config(**dict(vars(CFG), ep_size=4, ep_rank=r)), h, router, w13, w2)
             for r in range(4)]
    assert _rel(sum(parts), whole) <= REL
    # each share is the reference's share too
    for r, part in enumerate(parts):
        cfg = lm.Config(**dict(vars(CFG), ep_size=4, ep_rank=r))
        lo = r * cfg.held
        want = ref.moe_layer(h, router, w13[lo:lo + cfg.held], w2[lo:lo + cfg.held], cfg)
        assert _rel(part, want) <= REL


def test_dropless_when_every_token_picks_the_same_held_experts():
    cfg = lm.Config(**dict(vars(CFG), ep_size=4, ep_rank=0))
    h, router, w13, w2 = _moe_inputs()
    bias = torch.zeros(cfg.n_experts)
    bias[:cfg.top_k] = 100.0  # experts 0 and 1, both held by rank 0
    tally = lm.MoeTally(torch.device("cpu"))
    out = _share(cfg, h, router, w13, w2, bias, tally)
    T = BATCH * cfg.seq
    timings = {}
    tally.close(timings)
    assert timings["moe_rows"] == T * cfg.top_k  # every pair, none dropped
    assert timings["moe_rows_max"] == T
    assert timings["moe_host_reads"] == 1
    want = ref.moe_layer(h, router, w13[:cfg.held], w2[:cfg.held], cfg, bias)
    assert _rel(out, want) <= REL


def test_ep_share_gradients_match_reference():
    cfg = lm.Config(**dict(vars(CFG), ep_size=4, ep_rank=1))
    h, router, w13, w2 = _moe_inputs()
    lo = cfg.held
    grads = []
    for side in ("port", "ref"):
        leaves = [t.clone().requires_grad_(True)
                  for t in (h, router, w13[lo:lo + cfg.held], w2[lo:lo + cfg.held])]
        if side == "port":
            out = lm.moe_ffn(leaves[0], dict(zip(("router", "moe_w13", "moe_w2"), leaves[1:])),
                             cfg)
        else:
            out = ref.moe_layer(*leaves, cfg)
        grads.append(torch.autograd.grad((out * out).sum(), leaves))
    for gp, gr in zip(*grads):
        assert _rel(gp, gr) <= REL


@pytest.fixture
def gloo_mesh():
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            yield mesh_mod.make_mesh({"dp": 1, "tp": 1})
        finally:
            dist.destroy_process_group()


def test_train_step_times_phases_and_counts_the_experts(gloo_mesh):
    dp = comm_mod.Communicator(gloo_mesh.get_group("dp"), name="lfm2_dp")
    tp = comm_mod.Communicator(gloo_mesh.get_group("tp"), name="lfm2_tp")
    cfg = lm.Config(**dict(vars(CFG), ep_size=4, ep_rank=0))
    timings = {}
    init, step, specs = lm.make_train_step_optax(cfg, dp, tp, timings=timings)
    assert set(specs) == set(lm.LEAVES)
    params = {n: t for n, t in _params().items()}
    for n in ("moe_w13", "moe_w2"):
        params[n] = params[n][:, :cfg.held].contiguous()
    opt = init(params)
    tok, tgt = _batch()
    before = {n: t.clone() for n, t in params.items()}
    losses = [float(step(params, opt, tok, tgt)[2]) for _ in range(2)]
    assert all(v == v for v in losses)
    for p in PHASES:
        assert timings[p] > 0, p
    assert timings["local"] == pytest.approx(
        sum(timings[p] for p in ("forward", "loss", "backward", "sync")))
    n_moe = cfg.counts()["moe"]
    T = BATCH * cfg.seq
    assert timings["moe_host_reads"] == 2 * n_moe  # one a layer, forward only
    assert 0 < timings["moe_rows"] <= 2 * n_moe * T * cfg.top_k
    assert timings["moe_rows_max"] <= timings["moe_rows"]
    assert timings["moe_route_s"] > 0
    # one dp allreduce a leaf and one for the loss over dp and tp
    assert timings["coll_calls"] == 2 * (len(lm.LEAVES) + 2)
    assert all(not torch.equal(before[n], params[n]) for n in lm.LEAVES)


def test_train_step_without_timings_matches_one_with(gloo_mesh):
    dp = comm_mod.Communicator(gloo_mesh.get_group("dp"), name="lfm2_dp2")
    tok, tgt = _batch()
    out = []
    for timings in (None, {}):
        init, step, _ = lm.make_train_step_optax(CFG, dp, timings=timings)
        params = _params()
        opt = init(params)
        loss = step(params, opt, tok, tgt)[2]
        out.append((float(loss), params["moe_w13"].clone()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


def test_refuses_tensor_and_sequence_parallelism():
    one, two = types.SimpleNamespace(size=1), types.SimpleNamespace(size=2)
    with pytest.raises(errors.ArgError, match="tensor parallelism"):
        lm.make_train_step_optax(CFG, one, tp_comm=two)
    with pytest.raises(errors.ArgError, match="sequence parallelism"):
        lm.make_train_step_optax(CFG, one, sp_comm=one)
    with pytest.raises(errors.ArgError, match="expert exchange"):
        lm.make_train_step_optax(lm.Config(**dict(vars(CFG), ep_size=4)), two)


def test_refuses_bad_configs():
    for bad in (dict(layer_types=("conv", "mamba")), dict(n_kv_heads=3),
                dict(ep_size=3), dict(ep_size=4, ep_rank=4), dict(top_k=9)):
        with pytest.raises(errors.ArgError):
            lm.check_config(lm.Config(**dict(vars(CFG), **bad)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_plain_path_matches_rms_reference(dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 16, 128, generator=g) * 2 + 0.5).to(dtype)
    gain = 1 + 0.1 * torch.randn(128, generator=g)
    want = fn.rms_reference(x, gain)
    got = fn.rms_norm(x, gain, force=True)
    # both compute in float32 and round once: one ulp of the output dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(got, want) <= tol
    # the backward's plain version against autograd of the reference
    xs = [x.float().clone().requires_grad_(True) for _ in range(2)]
    gs = [gain.clone().requires_grad_(True) for _ in range(2)]
    dy = torch.randn(4, 16, 128, generator=g)
    for xi, gi, f in zip(xs, gs, (fn.rms_reference, lambda a, b: fn.rms_norm(a, b, force=True))):
        (f(xi, gi) * dy).sum().backward()
    assert _rel(xs[1].grad, xs[0].grad) <= 1e-5
    assert _rel(gs[1].grad, gs[0].grad) <= 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 1000, 2048, 4096])
def test_rms_kernels_match_plain_versions(cuda, width):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(4099, width, generator=g, device=cuda) * 2 + 0.5).to(torch.bfloat16)
    gain = 1 + 0.1 * torch.randn(width, generator=g, device=cuda)
    dy = torch.randn(4099, width, generator=g, device=cuda).to(torch.bfloat16)
    before = (fn.rms_fwd.launches, fn.rms_bwd.launches)
    y, r = fn.rms_fwd(x, gain)
    dx, dg = fn.rms_bwd(x, gain, dy, r)
    torch.cuda.synchronize()
    assert (fn.rms_fwd.launches, fn.rms_bwd.launches) == (before[0] + 1, before[1] + 1)
    yp, rp = fn.rms_fwd_plain(x, gain)
    dxp, dgp = fn.rms_bwd_plain(x, gain, dy, rp)
    # kernel and plain version compute in float32 and round once (one bf16
    # ulp); the float32 sums differ by order (1e-4)
    assert _rel(y, yp) <= 2.0 ** -7
    assert float(((r - rp) / rp).abs().max()) <= 1e-4
    assert _rel(dx, dxp) <= 2.0 ** -7
    assert _rel(dg, dgp) <= 1e-4


@pytest.mark.cuda
def test_step_backward_reads_nothing_to_the_host(cuda):
    cfg = lm.Config(**dict(vars(CFG), dtype=torch.bfloat16, fused_norm=None, flash=None,
                           d_model=128, head_dim=32, d_expert=64, seq=256))
    p = {n: t.to(cuda) for n, t in _params(cfg).items()}
    leaves = {n: t.requires_grad_(True) for n, t in p.items()}
    tok, tgt = (t.to(cuda) for t in _batch(cfg))
    tally = lm.MoeTally(cuda)
    loss = lm.loss_fn(leaves, tok, tgt, cfg, tally=tally)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.autograd.grad(loss, list(leaves.values()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tally.host_reads == cfg.counts()["moe"]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._grouped_mm has no CPU mode here)")
    return torch.device(name)


def _dirty(device):
    """Leave NaNs in the caching allocator's free blocks, so that an output
    the grouped products do not write reads as NaN, not as fresh zeros."""
    if device.type == "cuda":
        junk = torch.full((1 << 22,), float("nan"), device=device)
        del junk


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("device", DEVICES)
def test_grouped_products_with_an_empty_group(device):
    dev = _device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    g = torch.Generator().manual_seed(4)
    ends = [5, 5, 12, 20]  # group 1 has no rows
    a = torch.randn(20, 64, generator=g).to(dev, dtype)
    b = torch.randn(4, 64, 32, generator=g).to(dev, dtype)
    gy = torch.randn(20, 32, generator=g).to(dev, dtype)
    offs = torch.tensor(ends, dtype=torch.int32, device=dev)
    _dirty(dev)
    y = lm.grouped_mm(a, b, offs)
    _dirty(dev)
    dw = lm.grouped_mm_wgrad(a, gy, offs)
    starts = [0] + ends[:-1]
    # bfloat16 operands, float32 sums, one rounding of the output: one ulp
    for grp, (s0, s1) in enumerate(zip(starts, ends)):
        if s1 == s0:
            assert bool((dw[grp] == 0).all()), "an empty group's weight gradient"
            continue
        assert _rel(y[s0:s1], a[s0:s1].float() @ b[grp].float()) <= 2.0 ** -7
        assert _rel(dw[grp], a[s0:s1].float().t() @ gy[s0:s1].float()) <= 2.0 ** -7


@pytest.mark.parametrize("device", DEVICES)
def test_held_expert_with_no_rows_gets_zero_weight_gradients(device):
    dev = _device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = lm.Config(**dict(vars(CFG), ep_size=2, ep_rank=0, dtype=dtype,
                           d_model=64, d_expert=32))
    h, router, w13, w2 = (t.to(dev) for t in _moe_inputs())
    bias = torch.zeros(cfg.n_experts, device=dev)
    bias[2] = -100.0  # held expert 2 is never selected
    leaves = [t.clone().to(dtype).requires_grad_(True)
              for t in (w13[:cfg.held], w2[:cfg.held])]
    _dirty(dev)
    out = lm.moe_ffn(h.to(dtype), {"router": router, "moe_w13": leaves[0],
                                   "moe_w2": leaves[1]}, cfg, bias)
    dw13, dw2 = torch.autograd.grad(out.float().square().sum(), leaves)
    for dw in (dw13, dw2):
        assert bool((dw[2] == 0).all())
        assert bool(torch.isfinite(dw).all())
        assert all(float(dw[e].abs().max()) > 0 for e in range(cfg.held) if e != 2)
