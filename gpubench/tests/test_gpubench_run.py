"""A run end to end on the CPU at a tiny width (the harness's own tests:
the benchmark itself refuses to run without a card): the last line's
shape, the refusal without a card, no JAX in the process, and ``correct``
false with the timed path broken underneath."""

import json
import subprocess
import sys
import time

import pytest

from gpubench import harness, run

from .conftest import DATA, REPO


def _run(cell, trace, seed=2**31 + 5):
    return harness.run(cell, seed, 0.3, trace, "cpu", time.perf_counter())


def test_last_line_shape(tiny):
    r = _run(tiny, False)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["metrics"]) == tiny.workload["end_to_end"]
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_line_shape(tiny):
    r = _run(tiny, True)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True
    assert r["attempted"] >= harness.PROFILE_AFTER + harness.PROFILE_STEPS
    m = r["metrics"]
    # 4 collectives a layer through the f/g pair, 8 + 4 gradients, 2 losses
    assert m["coll_calls_per_step"]["value"] == 4 * 2 + 14
    assert m["step_local_ms"]["value"] > 0 and m["step_opt_ms"]["value"] > 0
    # a device reading from a CPU run is never reported
    for name in ("mfu_pct", "device_idle_pct", "flash_fwd_roofline"):
        assert name not in m


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "gpt2-xl.train-s1024", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_no_jax_after_a_dry_run():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from gpubench import cells, harness\n"
        f"cell = cells.load_cell('tiny.tiny-s16', __import__('pathlib').Path({str(DATA)!r}))\n"
        "harness.run(cell, 7, 0.2, True, 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=str(REPO / "gpubench"))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "zhpe_ompi_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "zhpe_ompi_tpu"}


def _broken(kind):
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    real = tfm.make_train_step_optax

    def make(*args, **kw):
        init, step, specs = real(*args, **kw)

        def bad(params, opt_state, tokens, targets):
            if kind == "unchanged":
                copy = {n: p.clone() for n, p in params.items()}
                _, _, loss = step(copy, init(copy), tokens, targets)
                return params, opt_state, loss
            half = tokens.shape[0] // 2
            return step(params, opt_state, tokens[:half], targets[:half])

        return init, bad, specs

    return make


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, kind):
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    monkeypatch.setattr(tfm, "make_train_step_optax", _broken(kind))
    r = _run(tiny, False)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
