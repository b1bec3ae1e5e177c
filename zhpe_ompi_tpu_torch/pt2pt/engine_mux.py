"""Multiplexed channel engine — ONE reader thread per component
(namesake: ``zhpe_ompi_tpu/pt2pt/engine_mux.py``; the port's own copy).

Before this module, every framed connection owned a reader thread: a
TcpProc ran one accept thread plus one drain thread per socket, and
every ``FramedRpcServer`` (the PMIx store wire, the zprted control
port) spawned a thread per client connection.  At n ranks that is O(n)
threads **per rank** — the second of the three per-rank resources the
scale-out fabric bounds (sockets are the lazy connect ladder + flood
overlay, store traffic is the daemon tree).

:class:`ChannelEngine` replaces both seams with a ``selectors``-based
readiness loop: one daemon thread multiplexes a listener plus every
framed channel of its component.  The load-bearing contracts:

- **Sockets stay BLOCKING.**  Send paths on other threads share these
  exact sockets under per-socket framing locks; flipping them
  non-blocking would break every ``sendmsg``/``sendall`` in the
  transport.  The engine never blocks on them anyway: it calls
  ``recv_into`` only after the selector reports readability, and a
  readable stream socket returns the available bytes immediately.
- **One bounded recv per readiness event.**  A large frame is
  reassembled incrementally across events into ONE dedicated
  ``bytearray`` (``dss.unpack_from`` may alias it — the zero-copy
  receive contract ``_recv_exact_into`` established), and no channel
  can starve another by owning the loop.
- **Classify-on-reset parity.**  EOF/reset closes the channel exactly
  as a drain thread's silent return did: the engine unregisters, calls
  the channel's ``on_close``, and leaves death classification to the
  owner's lazy send-path/FT machinery.
- **Leak observability.**  Engines register weakly; the conftest
  session gate asserts :func:`live_engines` and
  :func:`leaked_channels` are both empty once every owner closed.

Registration mutations (add/discard/detach) may come from any thread;
each one pokes the waker socketpair so the selector observes it on the
next loop, and a stale readiness event for a just-discarded channel is
dropped by the channel's ``closed`` flag.
"""

from __future__ import annotations

import selectors
import socket
import struct
import threading
import weakref
from typing import Any, Callable

from ..mca import output as mca_output
from ..runtime import spc
from ..utils import lockdep

_stream = mca_output.open_stream("engine_mux")

_LEN = struct.Struct("<I")

# hygiene registry (consumed by the conftest session gate)
_live_engines: "weakref.WeakSet[ChannelEngine]" = weakref.WeakSet()


def live_engines() -> list[str]:
    """Engines whose reader thread has not been closed — must be []
    at session end (every TcpProc/FramedRpcServer closes its engine
    in its own teardown ladder)."""
    return [e.name for e in list(_live_engines) if not e.closed]


def leaked_channels() -> list[str]:
    """Channels still registered on ANY engine object alive at session
    end — a closed engine holds none, so anything here is a connection
    whose owner unregistered neither on close nor on detach."""
    out = []
    for e in list(_live_engines):
        out.extend(f"{e.name}:{name}" for name in e.channel_names())
    return out


class Channel:
    """One framed connection's reassembly state.  ``on_frame(chan,
    frame)`` fires with the completed frame's dedicated bytearray;
    handlers may retarget ``chan.on_frame`` (the hello→established
    transition) — the engine reads it per frame."""

    __slots__ = ("sock", "name", "on_frame", "on_close", "count_bytes",
                 "closed", "_hdr", "_body", "_got", "_need")

    def __init__(self, sock: socket.socket, name: str,
                 on_frame: Callable[["Channel", bytearray], None],
                 on_close: "Callable[[Channel], None] | None",
                 count_bytes: bool):
        self.sock = sock
        self.name = name
        self.on_frame = on_frame
        self.on_close = on_close
        self.count_bytes = count_bytes
        self.closed = False
        self._hdr = bytearray(_LEN.size)
        self._body: bytearray | None = None  # None = reading header
        self._got = 0
        self._need = _LEN.size

    def _pending_bytes(self) -> bytes:
        """The partial frame buffered so far (detach hand-off)."""
        if self._body is None:
            return bytes(self._hdr[:self._got])
        return bytes(self._hdr) + bytes(self._body[:self._got])

    def _advance(self) -> "bytearray | None":
        """One bounded recv; returns a completed frame body, or None.
        Raises OSError on EOF (normalized — the engine closes us)."""
        target = self._hdr if self._body is None else self._body
        if self._need:
            view = memoryview(target)[self._got:self._need]
            k = self.sock.recv_into(view)
            if not k:
                raise ConnectionResetError("peer closed")
            self._got += k
        if self._got < self._need:
            return None
        if self._body is None:
            (length,) = _LEN.unpack(self._hdr)
            # the body bytearray is DEDICATED to this frame: views
            # handed out by dss.unpack_from alias it safely
            self._body = bytearray(length)
            self._got, self._need = 0, length
            if length:
                return None
        body, length = self._body, self._need
        self._body, self._got, self._need = None, 0, _LEN.size
        if self.count_bytes:
            spc.record("tcp_bytes_recvd", length + _LEN.size)
        return body


class ChannelEngine:
    """The per-component readiness loop: a listener plus N framed
    channels served by ONE daemon thread."""

    def __init__(self, name: str):
        self.name = name
        self.closed = False
        self._sel = selectors.DefaultSelector()
        self._lock = lockdep.lock("engine_mux.ChannelEngine._lock")
        self._chans: dict[int, Channel] = {}  # keyed by fd at register
        self._listeners: dict[int, tuple[socket.socket, Any]] = {}
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"chaneng-{name}",
        )
        _live_engines.add(self)

    def start(self) -> None:
        self._thread.start()

    def channel_names(self) -> list[str]:
        with self._lock:
            return sorted(c.name for c in self._chans.values()
                          if not c.closed)

    def channel_count(self) -> int:
        with self._lock:
            return sum(1 for c in self._chans.values() if not c.closed)

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass  # closing: the loop is already exiting

    # -- registration (any thread) ------------------------------------

    def add_listener(self, sock: socket.socket,
                     on_accept: Callable[[socket.socket], None]) -> None:
        with self._lock:
            fd = sock.fileno()
            self._listeners[fd] = (sock, on_accept)
            self._sel.register(sock, selectors.EVENT_READ,
                               ("listener", fd))
        self._wake()

    def add_channel(self, sock: socket.socket, name: str,
                    on_frame, on_close=None,
                    count_bytes: bool = True) -> Channel:
        chan = Channel(sock, name, on_frame, on_close, count_bytes)
        with self._lock:
            if self.closed:
                chan.closed = True
                return chan
            fd = sock.fileno()
            self._chans[fd] = chan
            self._sel.register(sock, selectors.EVENT_READ,
                               ("chan", fd))
        self._wake()
        return chan

    def _unregister(self, sock: socket.socket, fd: int) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            # already gone (EOF path raced a discard) or fd closed
            # under us — the selector map scan tolerates both
            pass

    def discard(self, sock: socket.socket) -> bool:
        """Unregister ``sock`` (tolerant): the owner is about to close
        it, or hand it to other machinery.  Returns whether it was a
        registered channel."""
        with self._lock:
            fd = next((fd for fd, c in self._chans.items()
                       if c.sock is sock), None)
            if fd is None:
                return False
            chan = self._chans.pop(fd)
            chan.closed = True
            self._unregister(sock, fd)
        self._wake()
        return True

    def detach(self, sock: socket.socket) -> bytes:
        """Unregister ``sock`` and hand back any partially-buffered
        frame bytes — the streamed-op seam: a dedicated thread takes
        over BLOCKING reads on the socket (a detached channel is not a
        leak; its new owner's loop owns the lifecycle)."""
        with self._lock:
            fd = next((fd for fd, c in self._chans.items()
                       if c.sock is sock), None)
            if fd is None:
                return b""
            chan = self._chans.pop(fd)
            chan.closed = True
            self._unregister(sock, fd)
        self._wake()
        return chan._pending_bytes()

    # -- the loop ------------------------------------------------------

    def _close_chan(self, chan: Channel, fd: int) -> None:
        with self._lock:
            if self._chans.get(fd) is chan:
                del self._chans[fd]
            chan.closed = True
            self._unregister(chan.sock, fd)
        if chan.on_close is not None:
            try:
                chan.on_close(chan)
            except Exception as e:  # noqa: BLE001 - close hooks must
                # not kill the engine every other channel rides
                mca_output.emit(
                    _stream, "%s: on_close for %s failed: %s: %s",
                    self.name, chan.name, type(e).__name__, e,
                )

    def _loop(self) -> None:
        while not self.closed:
            try:
                events = self._sel.select(timeout=1.0)
            except OSError:
                continue  # fd churn mid-select: re-arm
            for key, _mask in events:
                data = key.data
                if data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                kind, fd = data
                if kind == "listener":
                    with self._lock:
                        entry = self._listeners.get(fd)
                    if entry is None:
                        continue
                    lsock, on_accept = entry
                    try:
                        conn, _ = lsock.accept()
                    except OSError:
                        continue  # closing listener: loop exits soon
                    try:
                        on_accept(conn)
                    except Exception as e:  # noqa: BLE001 - a failed
                        # hello/registration must not kill the engine
                        mca_output.emit(
                            _stream, "%s: accept handler failed: "
                            "%s: %s", self.name, type(e).__name__, e,
                        )
                        try:
                            conn.close()
                        except OSError:
                            pass
                    continue
                with self._lock:
                    chan = self._chans.get(fd)
                if chan is None or chan.closed:
                    continue  # stale event for a discarded channel
                try:
                    frame = chan._advance()
                except (socket.timeout, BlockingIOError,
                        InterruptedError):
                    continue  # raced another readiness consumer
                except OSError:
                    # EOF/reset: the drain-thread parity path — close
                    # silently, death is classified lazily by the
                    # owner's send/FT machinery
                    self._close_chan(chan, fd)
                    continue
                if frame is None:
                    continue  # partial: reassembly continues
                try:
                    chan.on_frame(chan, frame)
                except Exception as e:  # noqa: BLE001 - a failing
                    # frame callback must not kill the loop: every
                    # later frame on EVERY channel would vanish
                    mca_output.emit(
                        _stream,
                        "%s: frame callback failed on %s: %s: %s",
                        self.name, chan.name, type(e).__name__, e,
                    )

    def close(self, timeout: float = 5.0) -> None:
        """Stop the loop and drop every registration.  The owner has
        already shutdown() its sockets; joining here guarantees no
        reader is parked on an fd about to be freed (the fd-reuse
        byte-stealing hazard the old shutdown-then-join drain ladder
        documented)."""
        if self.closed:
            return
        self.closed = True
        self._wake()
        if self._thread.ident is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout)
        with self._lock:
            chans = list(self._chans.values())
            self._chans.clear()
            listeners = list(self._listeners.values())
            self._listeners.clear()
            for chan in chans:
                chan.closed = True
        for chan in chans:
            try:
                self._sel.unregister(chan.sock)
            except (KeyError, ValueError, OSError):
                pass
        for lsock, _cb in listeners:
            try:
                self._sel.unregister(lsock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError, OSError):
            pass
        self._sel.close()
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
