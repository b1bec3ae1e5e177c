"""The lfm2_moe architecture in the harness: a tiny LFM2-MoE cell trains
through ``models/lfm2_moe.make_train_step_optax`` on the CPU and agrees
with ``reference/lfm2_moe.py``; the work counts against hand counts; the
readers of its three metrics on hand-built records; and the published
configuration against its source."""

import json
import time

import pytest
import torch

from gpubench import cells, flops, harness, inputs, trace
from gpubench.reference import common
from gpubench.reference import lfm2_moe as reference

from .conftest import DATA

CELL = "lfm2-8b-a1b.train-s8192"
NEW = ("moe_gemm_roofline", "conv_roofline", "moe_route_ms")


@pytest.fixture
def tiny_lfm2():
    return cells.load_cell("tiny-lfm2.tiny-s16", DATA)


def test_tiny_cell_trains_and_agrees_with_its_reference(tiny_lfm2):
    r = harness.run(tiny_lfm2, 2**31 + 7, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["metrics"]) == tiny_lfm2.workload["end_to_end"]


def test_tiny_cell_traced_reads_the_route_span(tiny_lfm2):
    r = harness.run(tiny_lfm2, 2**31 + 8, 0.2, True, "cpu", time.perf_counter())
    m = r["metrics"]
    assert r["correct"] is True
    assert m["moe_route_ms"]["value"] > 0
    # no device trace on the CPU: the rooflines read nothing
    assert "moe_gemm_roofline" not in m and "conv_roofline" not in m
    # one dp allreduce a leaf, and the loss over dp and tp
    assert m["coll_seam_calls_per_step"]["value"] == len(tiny_lfm2.arch.LEAVES) + 2


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_matches_the_port_in_f32(tiny_lfm2, seed):
    from zhpe_ompi_tpu_torch.models import lfm2_moe

    model = dict(tiny_lfm2.model, dtype="float32")
    leaves = inputs.Leaves(tiny_lfm2.arch, model, seed, "cpu")
    tokens, targets = inputs.make_batches(tiny_lfm2.traffic, model["vocab"], seed)[0]
    p = {n: t.requires_grad_(True) for n, t in leaves.all().items()}
    loss = reference.loss_backward(p, tokens, targets, model, common.Precision("f32"))
    q = {n: t.requires_grad_(True) for n, t in leaves.all().items()}
    fields = {k: v for k, v in model.items() if k not in ("remat", "warmup_steps")}
    cfg = lfm2_moe.Config(**dict(fields, layer_types=tuple(model["layer_types"]),
                                 dtype=torch.float32))
    port = lfm2_moe.loss_fn(q, tokens, targets, cfg)
    port.backward()
    assert loss == pytest.approx(float(port.detach()), rel=1e-6)
    for n in leaves.names:
        torch.testing.assert_close(p[n].grad, q[n].grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("warmup", [1, 3])
def test_two_steps_with_the_warmup_match_the_reference(tiny_lfm2, warmup):
    """Two Adam steps of the port in float32 (with the architecture's
    warmup) against the reference's."""
    from zhpe_ompi_tpu_torch.comm.communicator import Communicator
    from zhpe_ompi_tpu_torch.models import lfm2_moe
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
    from zhpe_ompi_tpu_torch.runtime import init as rt

    seed = 5
    model = dict(tiny_lfm2.model, dtype="float32", warmup_steps=warmup)
    leaves = inputs.Leaves(tiny_lfm2.arch, model, seed, "cpu")
    batches = inputs.make_batches(tiny_lfm2.traffic, model["vocab"], seed)[:2]
    ref = reference.readings(model, leaves, batches, 2)
    fields = {k: v for k, v in model.items() if k not in ("remat", "warmup_steps")}
    cfg = lfm2_moe.Config(**dict(fields, layer_types=tuple(model["layer_types"]),
                                 dtype=torch.float32))
    rt.init(device="cpu")
    try:
        mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1})
        dp = Communicator(mesh.get_group("dp"), name="lfm2_ref_dp")
        init, step, _ = lfm2_moe.make_train_step_optax(
            cfg, dp, optimizer=tiny_lfm2.arch.warmup_adam(model))
        params = leaves.all()
        opt = init(params)
        port = [float(step(params, opt, t, g)[2]) for t, g in batches]
    finally:
        rt.finalize()
    assert port == pytest.approx(ref["losses"], rel=1e-5)
    for n in leaves.names:
        assert float((params[n] - leaves.draw(n)).norm()) == pytest.approx(
            ref["change_norms"][n], rel=1e-3)


def test_warmup_learning_rate():
    arch = cells.load_cell(CELL).arch
    model = {"warmup_steps": 4}
    opt = arch.warmup_adam(model)([torch.nn.Parameter(torch.ones(2))])
    seen = []
    for _ in range(6):
        opt.param_groups[0]["params"][0].grad = torch.ones(2)
        opt.step()
        seen.append(opt.param_groups[0]["lr"])
    assert seen == pytest.approx([2.5e-4, 5e-4, 7.5e-4, 1e-3, 1e-3, 1e-3])


def test_published_config_counts_by_hand():
    cell = cells.load_cell(CELL)
    m, B = cell.model, cell.batch
    assert cell.arch.layer_counts(m) == {"conv": 18, "attn": 6, "dense": 2, "moe": 22}
    # per token: attention 4 x 2048^2 + 2 x 2048 x 512; conv 4 x 2048^2;
    # dense 3 x 2048 x 7168; MoE 2048 x 32 + one expert's 3 x 2048 x 1792;
    # the tied head 65536 x 2048
    per_token = (6 * 10_485_760 + 18 * 16_777_216 + 2 * 44_040_192
                 + 22 * (65_536 + 11_010_048) + 134_217_728)
    assert cell.arch.product_params_per_token(m) == per_token
    attn = 6 * 12 * 2048 * (8192 * 8193 // 2) * B
    assert cell.model_flops_per_step() == 6 * per_token * B * 8192 + attn
    assert 91.4e12 < cell.model_flops_per_step() < 91.7e12
    # this card's parameters: 2.527B
    leaves = cell.arch.LEAVES
    n = sum(torch.Size(cell.arch.leaf_shape_scale(k, m)[0]).numel() for k in leaves)
    assert n == pytest.approx(2.5265e9, rel=1e-4)


def test_work_counts_by_hand():
    cell = cells.load_cell(CELL)
    m = cell.model
    rows = 22 * 16384  # every token's 4 selections, a quarter held here
    w = cell.arch.moe_gemm_work(m, rows)
    assert w.flops == 18 * rows * 2048 * 1792
    weights = 22 * 8 * 3 * 2048 * 1792 * 2
    assert w.bytes == 3 * (weights + rows * (2048 + 3584 + 1792 + 2048) * 2)
    c = cell.arch.conv_work(m, cell.batch)
    assert c.bytes == 18 * 6 * 16384 * 2048 * 2
    assert c.flops == 18 * 3 * 2 * 3 * 16384 * 2048
    # the products are compute-bound on an H100, the conv bytes-bound
    assert w.flops / 989e12 > w.bytes / 3.35e12
    assert c.bytes / 3.35e12 > c.flops / 989e12


def _record(timings=None, kernels=None, profiled=(2, 3), arch=True):
    cell = cells.load_cell(CELL)
    if not arch:
        cell = cells.Cell(cell.name, cell.workload, cell.config, cell.traffic,
                          cells.load_code("arch", "gpt"))
    w = harness.Window(times=[0.5] * 10, timings=timings, profiled=set(profiled))
    if kernels is not None:
        w.trace = trace.Trace(kernels=kernels, busy_s=0.9, window_s=1.0)
    return harness.RunRecord(cell, w, (989e12, 3.35e12))


GEMM = "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape"
CONV = "void at::native::conv_depthwise2d_forward_kernel_generic<c10::BFloat16, int>"


def test_readers_give_none_where_they_find_nothing():
    readers = cells.metric_readers()
    empty = (_record(), _record(timings={}, kernels={}),
             _record(timings={"moe_rows": 0}, kernels={GEMM: [0.1, 4]}),
             _record(timings={"forward": 1.0}, kernels={"nvjet_tst": [0.1, 4]}),
             _record(timings={"moe_rows": 10.0, "moe_route_s": 1.0},
                     kernels={GEMM: [0.1, 4], CONV: [0.1, 4]}, arch=False))
    for rec in empty:
        for name in ("moe_gemm_roofline", "conv_roofline"):
            assert readers[name].read(rec) is None, name
    assert readers["moe_route_ms"].read(_record(timings={"forward": 1.0})) is None
    assert readers["moe_route_ms"].read(_record()) is None


def test_readers_values():
    readers = cells.metric_readers()
    cell = cells.load_cell(CELL)
    rows = 22 * 16384
    rec = _record(timings={"moe_rows": 10 * rows, "moe_route_s": 0.3},
                  kernels={GEMM: [0.1, 200], "prepare_grouped_gemm_data": [0.001, 200],
                           CONV: [0.02, 36]})
    least = cell.arch.moe_gemm_work(cell.model, rows).flops / 989e12
    assert readers["moe_gemm_roofline"].read(rec) == pytest.approx(100 * 2 * least / 0.101)
    least = cell.arch.conv_work(cell.model, cell.batch).bytes / 3.35e12
    assert readers["conv_roofline"].read(rec) == pytest.approx(100 * 2 * least / 0.02)
    assert readers["moe_route_ms"].read(rec) == pytest.approx(30.0)
    for name in NEW:
        assert readers[name].read(rec) > 0


def test_config_follows_its_source():
    cfg = json.loads((cells.ROOT / "configs" / "lfm2-8b-a1b.json").read_text())
    bench = {c["name"]: c for c in json.loads(
        (cells.ROOT.parent / "BENCHMARK.json").read_text())["configs"]}["lfm2-8b-a1b"]
    assert bench["source"] == cfg["source"] and bench["reduced"] == cfg["reduced"] == ["num_experts"]
    pub, run = cfg["published"], cfg["as_run"]
    # the source's numbers at the top level, but the experts held here
    for key, value in pub.items():
        assert cfg[key] == (run["n_experts"] // run["ep_size"] if key == "num_experts" else value)
    for field, key in cfg["from_source"].items():
        assert run[field] == pub[key], (field, key)
    assert run["n_experts"] == pub["num_experts"] and cfg["num_experts"] == 8
    assert run["d_model"] == run["n_heads"] * run["head_dim"]
    assert run["vocab"] % run["ce_chunk"] == 0
    for key in ("assumed", "departures", "deployment"):
        assert cfg[key]


def test_control_rounds_the_conv_taps_to_float8():
    g = torch.Generator().manual_seed(9)
    w = torch.randn(8, generator=g, requires_grad=True)
    u = torch.randn(2, 5, 8, generator=g, requires_grad=True)
    gy = torch.randn(2, 5, 8, generator=g)
    f32, fp8 = common.Precision("f32"), common.Precision("fp8")
    assert torch.equal(reference._taps(w, u, f32), w * u)
    y = reference._taps(w, u, fp8)
    assert torch.equal(y, common._act(w) * common._act(u))
    assert not torch.equal(y, w * u)
    dw, du = torch.autograd.grad(y, (w, u), gy)
    gq = common._grad(gy)
    assert torch.equal(dw, (gq * common._act(u)).sum((0, 1)))
    assert torch.equal(du, gq * common._act(w))
