"""Deadline-armed killable probes — the one probe idiom (namesake:
``zhpe_ompi_tpu/utils/deadline.py``; the port's own copy).

Any check that can WEDGE — a hung CUDA context creation, a GPU participant
stuck mid-all-reduce — must run where it can be killed (a subprocess),
carry its own HARD internal deadline (a watchdog thread inside the child
that ``os._exit``\\ s, so a wedged call dies from the inside even if the
outer kill is delayed), and report a STRUCTURED outcome so no caller ever
sniffs free-form stderr.

The device liveness probe (``parallel/mesh.py::probe_device_plane``, whose
child source lives in ``coll/nccl.py``) arms this machinery around a
one-element NCCL all-reduce.  Two pieces:

- :func:`run_probe` — one killable child probe.  Returns ``(kind,
  detail)`` with kind in ``"ok"`` (child printed its result), ``"hung"``
  (outer kill fired), ``"deadline"`` (the child's internal watchdog
  expired), ``"error"`` (nonzero exit).  Never raises: every outcome
  feeds a retry/fallback/classification ladder.
- :class:`Watchdog` — the in-process half: a deadline armed around a
  region the CALLER's thread runs (a guarded device collective).  The
  region cannot be killed from outside, so expiry fires a callback on
  the watchdog thread.

Hygiene is observable: every watchdog registers itself
(:func:`live_watchdog_threads` must be [] once users disarm) and every
probe child is tracked from spawn to reap
(:func:`orphaned_probe_processes` must be [] — a probe that leaked its
subprocess would accumulate wedged children for the host's whole life).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Callable

#: exit code of a child whose INTERNAL watchdog expired — outside the
#: posix signal range and distinct from common tool rcs (the structured
#: "deadline" outcome)
PROBE_DEADLINE_RC = 3

#: environment variable the child preamble reads its deadline from
DEADLINE_ENV = "ZMPI_PROBE_DEADLINE"

_lock = threading.Lock()
_WATCHDOGS: list["Watchdog"] = []
_PROBE_PROCS: list[subprocess.Popen] = []


def watchdog_preamble(env: str = DEADLINE_ENV) -> str:
    """Child-source preamble arming the internal watchdog: reads the
    deadline (seconds) from ``env`` and ``os._exit(PROBE_DEADLINE_RC)``\\ s
    when it expires — a wedged import/collective below it dies from the
    inside.  0 / unset disarms (the child then relies on the outer
    kill alone)."""
    return (
        "import os,sys,threading,time\n"
        f"_dl=float(os.environ.get({env!r}) or 0)\n"
        "if _dl>0:\n"
        "    def _expire():\n"
        "        time.sleep(_dl)\n"
        "        sys.stderr.write('probe internal deadline "
        "(%.0fs)\\n'%_dl)\n"
        "        sys.stderr.flush()\n"
        f"        os._exit({PROBE_DEADLINE_RC})\n"
        "    threading.Thread(target=_expire,daemon=True).start()\n"
    )


def _tail(text: str, n: int = 800) -> str:
    text = (text or "").strip()
    return text[-n:]


def orphaned_probe_processes() -> list[str]:
    """Probe children still running — must be [] once every probe call
    returned (run_probe reaps ok/deadline/error children and KILLS a
    hung one before reporting it; a survivor here is a leak)."""
    with _lock:
        _PROBE_PROCS[:] = [p for p in _PROBE_PROCS if p.poll() is None]
        return [f"probe-pid-{p.pid}" for p in _PROBE_PROCS]


def run_probe(src: str, timeout_s: float, deadline_s: float,
              env: dict | None = None,
              interpreter: str | None = None) -> tuple[str, str]:
    """One killable child probe with an internal watchdog deadline.

    ``src`` is the probe body; :func:`watchdog_preamble` is prepended so
    the child self-destructs at ``deadline_s`` even if the outer kill
    (``timeout_s``, which should exceed it) is delayed.  Returns
    ``(kind, detail)``: ``"ok"``/stdout, ``"hung"``, ``"deadline"``,
    or ``"error"``/rc+stderr.  Never raises."""
    child_env = dict(os.environ if env is None else env)
    child_env[DEADLINE_ENV] = str(deadline_s)
    proc = subprocess.Popen(
        [interpreter or sys.executable, "-c",
         watchdog_preamble() + src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env,
    )
    with _lock:
        _PROBE_PROCS[:] = [p for p in _PROBE_PROCS if p.poll() is None]
        _PROBE_PROCS.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()  # reap: a hung probe must not orphan a child
        return "hung", f"probe hung {timeout_s:.0f}s (killed)"
    if proc.returncode == PROBE_DEADLINE_RC:
        return "deadline", (
            f"probe hit its internal deadline ({deadline_s:.0f}s)"
        )
    if proc.returncode != 0:
        return "error", (
            f"probe rc={proc.returncode}: {_tail(err, 400)}"
        )
    return "ok", out.strip()


# -- the in-process half ----------------------------------------------------


def live_watchdog_threads() -> list[str]:
    """ARMED watchdog threads still running — must be [] once every
    guard exited (disarm() stops the thread; a survivor here is a leak).  A DISARMED watchdog whose
    thread is still finishing one last probe call is not a leak: its
    outcome is dropped (the on_expire path re-checks the disarm) and
    the probe's own outer kill bounds its life — the guard must not
    stall a training step behind that join."""
    with _lock:
        _WATCHDOGS[:] = [w for w in _WATCHDOGS if w._thread.is_alive()]
        return [w._thread.name for w in _WATCHDOGS
                if not w._disarmed.is_set()]


class Watchdog:
    """A deadline armed around a region the caller's own thread runs.

    The region (a guarded device collective) cannot be killed from
    outside — the blocked collective holds the thread — so expiry runs
    ``on_expire()`` on the watchdog thread while the region still
    blocks.  ``disarm()`` (always reached when the region returns)
    stops the thread; a region that finishes in time costs one Event
    wait and no callback.

    Context-manager form::

        with Watchdog(deadline_s, on_expire):
            loss = step(...)          # may wedge; on_expire classifies
    """

    def __init__(self, deadline_s: float,
                 on_expire: Callable[[], None],
                 name: str | None = None):
        self.deadline_s = float(deadline_s)
        self._on_expire = on_expire
        self._disarmed = threading.Event()
        self.expired = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=name or "deadline-watchdog",
        )
        with _lock:
            _WATCHDOGS[:] = [w for w in _WATCHDOGS
                             if w._thread.is_alive()]
            _WATCHDOGS.append(self)

    def _run(self) -> None:
        if self._disarmed.wait(self.deadline_s):
            return  # the region finished in time: no callback
        self.expired = True
        self._on_expire()

    def arm(self) -> "Watchdog":
        self._thread.start()
        return self

    def disarm(self, join_timeout: float = 0.5) -> None:
        """Stop the watchdog.  The join is a SHORT tidy-up, not a
        correctness wait: a thread still inside a probe subprocess (up
        to the probe's outer kill) must not stall the guarded loop's
        next step — its outcome is dropped at the disarm re-check and
        the leak gate counts only armed watchdogs."""
        self._disarmed.set()
        if self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(join_timeout)

    def __enter__(self) -> "Watchdog":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()
