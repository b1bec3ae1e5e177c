"""Verbose-stream logging.

Re-design of ``opal_output`` (``opal/util/output.h:32-58``): named streams with
per-stream verbosity levels controlled by MCA variables
(``<framework>_base_verbose`` in the reference, ``<framework>_verbose`` here).
A message is emitted only when its level is <= the stream's verbosity, so hot
paths can carry rich diagnostics that compile away at default settings.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass

from . import var as mca_var


@dataclass
class Stream:
    stream_id: int
    name: str
    verbose_var: str

    @property
    def verbosity(self) -> int:
        return int(mca_var.get(self.verbose_var, 0) or 0)


class Output:
    def __init__(self) -> None:
        self._streams: dict[int, Stream] = {}
        self._by_name: dict[str, int] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def open_stream(self, name: str, verbose_var: str | None = None) -> int:
        """Open (or find) a named stream; returns its id."""
        with self._lock:
            if name in self._by_name:
                return self._by_name[name]
            sid = self._next_id
            self._next_id += 1
            vvar = verbose_var or f"{name}_verbose"
            mca_var.register(
                vvar, 0, f"Verbosity level for the {name} output stream", type=int
            )
            self._streams[sid] = Stream(sid, name, vvar)
            self._by_name[name] = sid
            return sid

    def verbose(self, level: int, stream: int | str, msg: str, *args) -> None:
        s = self._resolve(stream)
        if s is None or level > s.verbosity:
            return
        if args:
            msg = msg % args
        print(f"[zmpi:{s.name}] {msg}", file=sys.stderr)

    def output(self, stream: int | str, msg: str, *args) -> None:
        """Unconditional output on a stream."""
        s = self._resolve(stream)
        name = s.name if s is not None else "?"
        if args:
            msg = msg % args
        print(f"[zmpi:{name}] {msg}", file=sys.stderr)

    def _resolve(self, stream: int | str) -> Stream | None:
        if isinstance(stream, str):
            sid = self._by_name.get(stream)
            if sid is None:
                sid = self.open_stream(stream)
            return self._streams[sid]
        return self._streams.get(stream)


output = Output()
open_stream = output.open_stream
verbose = output.verbose
emit = output.output
