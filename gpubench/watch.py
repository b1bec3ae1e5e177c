"""What surrounds the measured window, read beside every run so that a run
that reads far off can be explained: the card's SM clock, power and
temperature just before and just after the window (outside it), the
process's own state at both ends (CPU seconds by thread, context switches,
the CUDA caching allocator's calls to the driver), the interpreter's
garbage collections inside it, and the window's step times with the
host's share of each.  None of it is a metric; ``harness.run`` prints it on
standard error."""

from __future__ import annotations

import gc
import os
import resource
import statistics
import subprocess
import time
from pathlib import Path

#: ``nvidia-smi --query-gpu`` fields, and the names they are printed under
CARD_FIELDS = (("clocks.sm", "sm_mhz"), ("power.draw", "power_w"),
               ("temperature.gpu", "temp_c"), ("pstate", "pstate"))


def card_state(index: int = 0) -> dict | None:
    """The card's SM clock, power draw, temperature and performance state,
    read once by ``nvidia-smi``; None where it cannot be read."""
    query = ",".join(f for f, _ in CARD_FIELDS)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    values = [v.strip() for v in out.stdout.strip().split(",")]
    if out.returncode or len(values) != len(CARD_FIELDS):
        return None
    state = {}
    for (_, name), v in zip(CARD_FIELDS, values):
        try:
            state[name] = float(v)
        except ValueError:
            state[name] = v
    return state


#: the CUDA caching allocator's counters read at both ends of the window
ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
               "num_sync_all_streams")


def process_state(cuda: bool) -> dict:
    """This process's CPU seconds (in all and by thread, named as the
    thread names itself), context switches, and the allocator's counters."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    state = {"cpu_s": ru.ru_utime + ru.ru_stime, "vol_csw": ru.ru_nvcsw,
             "invol_csw": ru.ru_nivcsw, "threads": {}}
    tick = os.sysconf("SC_CLK_TCK")
    for task in Path("/proc/self/task").iterdir():
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        cpu = (int(fields[11]) + int(fields[12])) / tick
        state["threads"][f"{name}/{task.name}"] = cpu
    if cuda:
        import torch

        stats = torch.cuda.memory_stats()
        state.update({k: stats.get(k) for k in ALLOC_STATS},
                     reserved_gib=stats.get("reserved_bytes.all.current", 0) / 2 ** 30)
    return state


def _delta(before: dict, after: dict) -> dict:
    """What changed in ``process_state`` over the window: CPU seconds,
    switches and allocator counts; the busiest threads by CPU seconds."""
    out = {k: round(after[k] - before[k], 3) for k in after
           if k != "threads" and isinstance(after[k], (int, float))
           and isinstance(before.get(k), (int, float))}
    busy = sorted(((after["threads"][t] - before["threads"].get(t, 0.0), t)
                   for t in after["threads"]), reverse=True)
    out["busiest_threads_s"] = [[t, round(c, 2)] for c, t in busy[:6]]
    out["threads"] = len(after["threads"])
    return out


class GcWatch:
    """Counts and host seconds of the interpreter's collections, by
    generation, while it is entered (through ``gc.callbacks``)."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def ms(xs) -> list:
    return [round(1e3 * x, 2) for x in xs]


def summary(times: list, issue: list, gcw: GcWatch, before, after,
            proc_before: dict, proc_after: dict) -> dict:
    """One run's window: its step times (quartiles, the slowest, the first
    and last five steps' medians), the median host time to issue a step
    (the step's call until it returns, before the loss is read), the
    collections, the card before and after, and what changed in the
    process."""
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    return {
        "steps": len(times),
        "step_ms_q1_median_q3_max": ms([q[0], q[1], q[2], max(times)]),
        "first5_last5_ms": ms([statistics.median(times[:5]),
                               statistics.median(times[-5:])]),
        "issue_ms_median": ms([statistics.median(issue)])[0],
        "gc_count": gcw.count,
        "gc_ms": ms(gcw.seconds),
        "card_before": before,
        "card_after": after,
        "process": _delta(proc_before, proc_after),
    }
