"""One run of one cell: set-up, the program's first steps (the readings the
comparison takes), the measured window, then the reference.

The path every cell drives: ``runtime.init()``, a ``{"dp": 1, "tp": 1}``
mesh from ``parallel/mesh.make_mesh``, framework ``Communicator``s over its
``dp`` and ``tp`` groups, and the step that the cell's architecture builds
over them (``arch/<name>.py``: the port's training entry point with its
default Adam).  The window calls ``step(params, opt_state, tokens,
targets)`` again and again, each step ending with the host reading the
loss, as a training loop that logs it does.  Set-up builds the step once
and drives it through its first ``checked_steps`` steps (which also warm
up every shape), and the window goes on with that same step, parameters
and optimizer state.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import cells, check, commspan, inputs, peaks, watch
from . import trace as trace_mod

#: top-level module names that the process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "zhpe_ompi_tpu")
#: window steps before the profiled ones, and how many are profiled
PROFILE_AFTER, PROFILE_STEPS = 2, 2
PROFILED_SPAN = "gpubench.profiled"
STEP_SPAN = "gpubench.step"
ADAM_B1 = 0.9


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Program:
    """The system under test as one run holds it."""

    step: object
    params: dict
    opt_state: object
    batches: list
    timings: dict | None
    tally: dict | None
    next_batch: int = 0
    #: host clock when the last step's call returned, before its loss was read
    issued: float = 0.0

    def run_step(self, part=None) -> float:
        tokens, targets = self.batches[self.next_batch % len(self.batches)]
        self.next_batch += 1
        if part is not None:
            tokens, targets = part(tokens), part(targets)
        self.params, self.opt_state, loss = self.step(
            self.params, self.opt_state, tokens, targets)
        self.issued = time.perf_counter()
        return loss.item()


def build(cell: cells.Cell, seed: int, device, trace: bool,
          marks: dict | None = None) -> Program:
    """Make the communicators, the step, the weights, the optimizer state
    and the batches of ``cell`` from ``seed``.  ``runtime.init`` must have
    run.  In the traced run the communicators are wrapped to count and the
    step keeps ``timings``.  ``marks`` gets the seconds from the first
    line of ``run.py`` at which each part was done."""
    from zhpe_ompi_tpu_torch.comm.communicator import Communicator
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1})
    dp_comm = Communicator(mesh.get_group("dp"), name="gpubench_dp")
    tp_comm = Communicator(mesh.get_group("tp"), name="gpubench_tp")
    tally = timings = None
    if trace:
        tally, timings = {"calls": 0, "host_s": 0.0}, {}
        dp_comm = commspan.CountingComm(dp_comm, tally)
        tp_comm = commspan.CountingComm(tp_comm, tally)
    _mark(marks, "communicators")
    init_opt_state, step = cell.arch.build(cell.model, dp_comm, tp_comm, timings)
    params = cell.leaves(seed, device).all()
    if device.type == "cuda":
        torch.cuda.synchronize()
    _mark(marks, "weights")
    batches = inputs.make_batches(cell.traffic, cell.model["vocab"], seed)
    _mark(marks, "batches")
    return Program(step, params, init_opt_state(params), batches, timings, tally)


def _mark(marks, name):
    if marks is not None:
        marks[name] = time.perf_counter() - marks["t_start"]


def first_steps(prog: Program, cell: cells.Cell, seed: int, device,
                part=None, marks: dict | None = None) -> dict:
    """Drive the program through the cell's checked steps, on distinct
    batches, and read what the comparison takes: each step's loss, each
    leaf's first gradient as Adam got it, and each leaf's change once the
    last of these steps is done (before any later step writes over it).
    ``part``, a function of a (rows, seq) tensor, feeds the step part of
    each batch: a fault that the readings tool plants."""
    losses, grad_norms = [], {}
    for t in range(cell.checked_steps):
        losses.append(prog.run_step(part))
        if t == 0:
            _mark(marks, "first_step")
            for n, p in prog.params.items():
                st = prog.opt_state.state.get(p, {})
                m = st.get("exp_avg")
                grad_norms[n] = 0.0 if m is None else float(m.norm()) / (1 - ADAM_B1)
    change = {}
    leaves = cell.leaves(seed, device)
    with torch.no_grad():
        for n in leaves.names:
            w0 = leaves.draw(n)
            change[n] = float((prog.params[n] - w0).norm())
            del w0
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


@dataclass
class Window:
    """What the measured window recorded."""

    times: list = field(default_factory=list)
    #: host seconds of each step until its call returned, before its loss
    #: was read
    issue: list = field(default_factory=list)
    gc: watch.GcWatch = field(default_factory=watch.GcWatch)
    seconds: float = 0.0
    failed: int = 0
    peak_bytes: int = 0
    profiled: set = field(default_factory=set)
    trace: object = None
    timings: dict | None = None
    tally: dict | None = None


def window(prog: Program, seconds: float, trace: bool, cuda: bool) -> Window:
    """Steps until ``seconds`` have passed, each timed on the host clock
    to its loss on the host.  The traced run profiles steps
    ``PROFILE_AFTER`` .. ``PROFILE_AFTER + PROFILE_STEPS - 1`` and goes on
    until both the time is up and those are done."""
    w = Window()
    if prog.timings is not None:
        prog.timings.clear()
        prog.tally.update(calls=0, host_s=0.0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with w.gc:
        _steps(prog, w, seconds, trace, cuda)
    if cuda:
        w.peak_bytes = torch.cuda.max_memory_allocated()
    if prog.timings is not None:
        w.timings, w.tally = dict(prog.timings), dict(prog.tally)
    return w


def _steps(prog: Program, w: Window, seconds: float, trace: bool, cuda: bool):
    """The window's steps, recorded into ``w``."""
    prof = span = None
    t0 = time.perf_counter()
    while True:
        i = len(w.times)
        if trace and i == PROFILE_AFTER:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function(PROFILED_SPAN)
            span.__enter__()
        ts = time.perf_counter()
        if trace:
            with record_function(STEP_SPAN):
                loss = prog.run_step()
        else:
            loss = prog.run_step()
        te = time.perf_counter()
        w.times.append(te - ts)
        w.issue.append(prog.issued - ts)
        if not math.isfinite(loss):
            w.failed += 1
        if prof is not None and i == PROFILE_AFTER + PROFILE_STEPS - 1:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            w.profiled = set(range(PROFILE_AFTER, PROFILE_AFTER + PROFILE_STEPS))
            if cuda:
                w.trace = trace_mod.reduce_profile(prof, PROFILED_SPAN)
            prof = None
        if te - t0 >= seconds and (not trace or w.profiled):
            break
    w.seconds = te - t0


@dataclass
class RunRecord:
    """What a per-layer metric reader is handed."""

    cell: cells.Cell
    window: Window
    #: the card's (bf16 FLOP/s, bytes/s), or None
    peaks: tuple | None

    @property
    def steps(self) -> int:
        return len(self.window.times)

    @property
    def unprofiled_times(self) -> list:
        return [t for i, t in enumerate(self.window.times) if i not in self.window.profiled]

    def kernel_roofline(self, needles, work_per_call) -> float | None:
        """Percent of the least time of the kernels named by ``needles``
        over their device time in the trace; None where the trace has none
        of them or the card has no peaks."""
        tr = self.window.trace
        found = tr.kernel(*needles) if tr is not None else None
        if found is None or self.peaks is None:
            return None
        secs, calls = found
        return 100.0 * calls * work_per_call.least_seconds(*self.peaks) / secs


def _e2e(name: str, cell: cells.Cell, w: Window, setup_s: float) -> dict:
    tokens = cell.batch * cell.model["seq"]
    if name == "tokens_per_s":
        return {"value": len(w.times) * tokens / w.seconds, "unit": "tokens/s"}
    if name == "step_ms_p90":
        p90 = statistics.quantiles(w.times, n=10)[8] if len(w.times) > 1 else w.times[0]
        return {"value": p90 * 1e3, "unit": "ms"}
    if name == "peak_mem_gib":
        return {"value": w.peak_bytes / 2 ** 30, "unit": "GiB"}
    if name == "setup_s":
        return {"value": setup_s, "unit": "s"}
    raise ValueError(f"unknown end-to-end metric {name!r}")


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of ``cell``; returns the result object of the last line, its
    ``checks`` last.  ``device`` is ``"cuda"``; the CPU serves the
    harness's own tests alone."""
    from zhpe_ompi_tpu_torch.runtime import init as rt

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    marks = {"t_start": t_start}
    _mark(marks, "imports")
    rt.init(device=device)
    try:
        _mark(marks, "runtime_init")
        prog = build(cell, seed, dev, trace, marks)
        readings = first_steps(prog, cell, seed, dev, marks=marks)
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        setup_s = time.perf_counter() - t_start
        print("setup: " + ", ".join(f"{k} at {v:.2f} s" for k, v in marks.items()
                                    if k != "t_start")
              + f", {cell.checked_steps} checked steps done at {setup_s:.2f} s",
              file=sys.stderr)
        before = watch.card_state() if cuda else None
        proc_before = watch.process_state(cuda)
        w = window(prog, seconds, trace, cuda)
        proc_after = watch.process_state(cuda)
        after = watch.card_state() if cuda else None
        print("window: " + json.dumps(watch.summary(w.times, w.issue, w.gc, before, after,
                                                    proc_before, proc_after)),
              file=sys.stderr)
        print("window steps: " + json.dumps({"step_ms": watch.ms(w.times),
                                             "issue_ms": watch.ms(w.issue)}),
              file=sys.stderr)
        del prog
        gc.collect()
    finally:
        rt.finalize()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"JAX or the JAX package is loaded: {', '.join(found)}")
    ref = cell.reference.readings(cell.model, cell.leaves(seed, dev), inputs.make_batches(
        cell.traffic, cell.model["vocab"], seed), cell.checked_steps)
    ok, checks = check.verdict(check.numbers(readings, ref), cell.workload["limits"])
    ok = ok and w.failed == 0
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": max(setup_peak, w.peak_bytes)}
    result = {"correct": ok, "attempted": len(w.times), "failed": w.failed}
    if trace:
        record = RunRecord(cell, w, peaks.card_peaks(kind) if cuda else None)
        metrics = {}
        for name, mod in cells.metric_readers().items():
            value = mod.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        result["metrics"] = metrics
        if w.trace is not None:
            device_info.update(busy_s=w.trace.busy_s, window_s=w.trace.window_s)
            result["breakdown"] = w.trace.breakdown()
    else:
        result["metrics"] = {n: _e2e(n, cell, w, setup_s)
                             for n in cell.workload["end_to_end"]}
    result["device"] = device_info
    result["checks"] = checks
    return result
