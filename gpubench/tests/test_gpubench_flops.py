"""Work counts against hand counts, and the arithmetic of the metrics that
read them."""

import pytest

from gpubench import cells, flops, harness, peaks, trace
from gpubench.cells import Cell


def test_matmul_params_gpt2_xl_and_mpt_stage():
    # GPT-2 XL: 48 x (4 * 1600^2 + 2 * 1600 * 6400) + 50257 * 1600
    assert flops.matmul_params(50257, 1600, 6400, 48) == 48 * 30_720_000 + 80_411_200
    # eight MPT layers: 8 x 12 * 4096^2 + 50432 * 4096
    assert flops.matmul_params(50432, 4096, 16384, 8) == 8 * 201_326_592 + 206_569_472


@pytest.mark.parametrize("B,S,h,kv,hd", [(12, 1024, 25, 25, 64), (1, 32768, 32, 32, 128),
                                         (2, 4096, 32, 8, 64)])
def test_flash_counts_by_hand(B, S, h, kv, hd):
    pairs = S * (S + 1) // 2
    fwd = flops.flash_fwd(B, S, h, kv, hd)
    assert fwd.flops == B * h * pairs * (2 * hd + 2 * hd)
    # q and o at h heads, k and v at kv heads, lse per query row
    assert fwd.bytes == B * S * (2 * h + 2 * kv) * hd * 2 + B * h * S * 4
    bwd = flops.flash_bwd(B, S, h, kv, hd)
    assert bwd.flops == B * h * pairs * 5 * 2 * hd
    assert bwd.bytes == B * S * (4 * h + 4 * kv) * hd * 2 + B * h * S * 4
    # the backward's five products are 2.5 forwards
    assert bwd.flops == 2.5 * fwd.flops


@pytest.mark.parametrize("N,D", [(12288, 1600), (32768, 4096)])
def test_ln_counts_by_hand(N, D):
    assert flops.ln_fwd(N, D).bytes == N * D * 2 * 2 + D * 4 + N * 8
    assert flops.ln_bwd(N, D).bytes == N * D * 2 * 3 + D * 8 + N * 8


def test_model_flops_gpt2_xl_per_token():
    per_step = flops.model_flops_per_step(50257, 1600, 6400, 48, 12, 1024)
    per_token = per_step / (12 * 1024)
    # 6 N_matmul plus 6 L D (S + 1) causal attention
    assert per_token == pytest.approx(6 * 1_554_971_200 + 6 * 48 * 1600 * 1025)
    assert 9.7e9 < per_token < 9.9e9


def test_least_seconds_takes_the_larger_bound():
    w = flops.Work(flops=989e12, bytes=3.35e12 / 2)
    assert w.least_seconds(989e12, 3.35e12) == pytest.approx(1.0)
    w = flops.Work(flops=1.0, bytes=3.35e12)
    assert w.least_seconds(989e12, 3.35e12) == pytest.approx(1.0)


def test_card_peaks():
    assert peaks.card_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert peaks.card_peaks("NVIDIA H100 PCIe")[0] == 756e12
    assert peaks.card_peaks("NVIDIA A100-SXM4-80GB") is None


def _record(times, profiled, kernels=None):
    cfg = {"as_run": {"vocab": 50257, "d_model": 1600, "n_heads": 25, "d_ff": 6400,
                      "n_layers": 48, "ce_chunk": 1733, "dtype": "bfloat16"}}
    cell = Cell("c", {}, cfg, {"seq": 1024, "batch": 12, "remat": False},
                cells.load_code("arch", "gpt"))
    w = harness.Window(times=times, profiled=profiled)
    if kernels is not None:
        w.trace = trace.Trace(kernels=kernels, busy_s=0.9, window_s=1.0)
    return harness.RunRecord(cell, w, (989e12, 3.35e12))


def test_mfu_over_the_unprofiled_steps():
    from gpubench.cells import metric_readers

    mfu = metric_readers()["mfu_pct"]
    per_step = flops.model_flops_per_step(50257, 1600, 6400, 48, 12, 1024)
    rec = _record([0.4, 0.4, 9.0, 9.0, 0.4, 0.4], {2, 3})
    assert mfu.read(rec) == pytest.approx(100 * per_step / 0.4 / 989e12)


def test_roofline_and_idle_arithmetic():
    from gpubench.cells import metric_readers

    readers = metric_readers()
    fwd = flops.flash_fwd(12, 1024, 25, 25, 64).least_seconds(989e12, 3.35e12)
    # 96 launches that took twice their least time each: 50%
    rec = _record([0.4] * 6, {2, 3}, {"void flash_fwd_kernel<64>(...)": [2 * 96 * fwd, 96]})
    assert readers["flash_fwd_roofline"].read(rec) == pytest.approx(50.0)
    assert readers["device_idle_pct"].read(rec) == pytest.approx(10.0)
    # a kernel that did not run reads nothing, never 0
    assert readers["flash_bwd_roofline"].read(rec) is None
    assert readers["ln_roofline"].read(rec) is None
    bwd = flops.flash_bwd(12, 1024, 25, 25, 64).least_seconds(989e12, 3.35e12)
    rec = _record([0.4] * 6, {2, 3}, {"flash_bwd_dq_kernel<64>": [96 * bwd, 96],
                                      "flash_bwd_dkv_kernel<64>": [3 * 96 * bwd, 96]})
    assert readers["flash_bwd_roofline"].read(rec) == pytest.approx(25.0)


def test_trace_merge_gaps():
    t = trace.Trace()
    merged = trace._merge([(5, 7), (0, 2), (1, 3)])
    assert merged == [[0, 3], [5, 7]]
    assert t.kernel("nothing") is None


class _Ev:
    def __init__(self, name, a, b, cuda, annotation=False):
        from torch.autograd import DeviceType

        self.name, self.is_user_annotation = name, annotation
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": a, "end": b})()


def test_reduce_profile_busy_gaps_and_annotations():
    evs = [
        _Ev("gpubench.profiled", 0, 1000, False),
        _Ev("gpubench.step", 0, 1000, False),
        _Ev("aten::mm", 100, 150, False),
        _Ev("cudaStreamSynchronize", 600, 900, False),
        _Ev("Optimizer.step#Adam.step", 950, 1000, False),
        # device side of host ranges: left out
        _Ev("gpubench.step", 0, 1000, True, annotation=True),
        _Ev("Optimizer.step#Adam.step", 950, 1000, True),
        _Ev("gemm_kernel", 100, 300, True),
        _Ev("add_kernel", 250, 400, True),
        _Ev("add_kernel", 950, 1100, True),
    ]
    prof = type("P", (), {"events": lambda self: evs})()
    tr = trace.reduce_profile(prof, "gpubench.profiled")
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(350e-6)
    assert set(tr.kernels) == {"gemm_kernel", "add_kernel"}
    assert tr.kernel("add_kernel") == (pytest.approx(300e-6), 2)
    # the gaps 400-950 (its middle in the sync) and 0-100
    assert tr.gaps[0] == (pytest.approx(550e-6), "cudaStreamSynchronize")
    assert tr.gaps[1] == (pytest.approx(100e-6), "gpubench.step")
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "add_kernel" and len(b["idle_gaps"]) == 2
