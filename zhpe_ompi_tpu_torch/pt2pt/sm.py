"""Shared-memory transport — the btl/sm analog of the host plane
(namesake: ``zhpe_ompi_tpu/pt2pt/sm.py``; the port's own copy of its
message half).

Same-host ranks of a ``TcpProc`` universe move their frames through
mmap'd ``/dev/shm`` rings instead of loopback sockets.  The layout (v3)
is the namesake's byte for byte — control header, ring directory, slot
header, and the DSS frame in the slot — so a port rank and a JAX-package
rank on one host produce into and consume from each other's rings.

Design (one CONTROL segment per proc, demand-mapped fixed-slot SPSC
rings per peer direction, each materialized ring its own file):

- **Segment**: each proc creates ONE control segment at construction
  holding the doorbell, the allocation bitmap and the per-source ring
  directory, and advertises ``(boot_id, segment_name)`` on its modex
  card plus a NUMA-domain token (``pynuma:``, sysfs-derived or the
  ``sm_numa_id`` override).  A sender maps the destination's control
  segment and produces into the ring indexed by its own rank; the owner
  is the only consumer of every ring in its namespace, so each ring is
  strictly SPSC and one doorbell covers all of them.
- **Demand mapping** (layout v3): a sender's first contact writes an
  allocation request (its peer class) into its directory entry and rings
  the doorbell; the owner's poll thread materializes the ring — a file of
  its own (``<segment>.r<src>``) sized to the peer class's geometry —
  sets the bitmap bit and flips the entry READY before the first payload
  byte moves.  A proc that never talks to a peer never pays its ring.
  The close-time audit (:func:`segment_audit_failures`) checks the
  bitmap, the directory and the tmpfs footprint agree.
- **Ring**: ``nslots`` slots of ``sm_max_frag`` payload bytes; capacity
  is per peer class — ``sm_ring_bytes`` for intra-domain peers,
  ``sm_leader_ring_bytes`` for cross-NUMA-domain pairs — and a tuned
  table's ``geometry`` line (``coll/ztable.table_geometry``) may size
  either while the var holds its default.  ``head``/``tail`` are
  monotonic slot counters on separate cache lines.  A message is one DSS
  frame written straight into slot memory; a message larger than a slot
  flows as a fragment pipeline, so one larger than the whole ring still
  streams through.
- **Receive**: the poll thread assembles each frame into a dedicated
  writable bytearray and hands it to ``on_frame``; ``dss.unpack_from``
  then decodes an array record to a CPU tensor viewing THAT buffer,
  never the slot (a slot is recycled the moment ``tail`` passes it).
  The final fragment's ``tail`` advance happens only after the frame
  reached the matching engine (the close-quiesce contract).
- **Doorbell**: the poll thread spins, yielding the GIL every pass,
  through ``sm_poll_hot_us`` after traffic, then announces sleep in the
  header and parks in ``futex(FUTEX_WAIT)`` (through ``ctypes``'s libc)
  on that word; producers wake it only when the flag is up.  Without the
  futex syscall it sleeps in short bounded steps.

Selection and fallback live in ``pt2pt/tcp.py`` (self → sm → tcp,
``sm_priority`` against ``tcp_priority``, per peer).

- **RMA regions** (the one-sided data plane): window/symmetric-heap
  backing buffers allocate as further per-purpose files
  (``<segment>.w<idx>``) via :meth:`SmSegment.alloc_rma_region`, in the
  namesake's layout byte for byte (``_RMA_MAGIC``, the ``_RH_*`` words,
  the holder table, ``_rma_hdr_len``), so a JAX-package origin maps a
  port-owned region and the reverse.  A region is a page of header — a
  **lock word** serializing fetch-atomics cross-process (the port's
  ``native/shm_amo.cpp`` ``__atomic`` CAS, the same domain as the
  namesake's native library; ``flock`` critical sections only when
  ``native_kernels``/``ZOMPI_NATIVE=0`` say so), shared/exclusive
  passive-target lock counts with a per-rank holder table, the futex
  generation word blocked lock waiters park on, and the PSCW post/
  complete doorbells — followed by the window's data bytes.  Header
  words are loaded and stored whole through a u32 view.  Same-host
  origins ``mmap`` the file and execute put/get as direct load/store;
  ``osc/direct.py`` is the consumer.  A died lock-holder's words are
  recovered at classification via :meth:`RmaMapping.recover_dead`.

Lifecycle: segments exist only while their proc lives, are unlinked at
close, and a stale segment left by a crashed job is unlinked at create
(``O_EXCL`` retry).  :func:`orphaned_ring_files`,
:func:`live_poll_threads` and :func:`segment_audit_failures` are the
hygiene registries tests assert empty.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import itertools
import mmap
import os
import platform
import socket
import struct
import sys
import tempfile
import threading
import time
import weakref

import numpy as np

from ..core import errors
from ..mca import output as mca_output
from ..mca import var as mca_var
from ..runtime import spc
from ..utils import dss
from ..utils import lockdep

_stream = mca_output.open_stream("btl_sm")

# Per-THREAD full-ring spin accumulator, alongside the process-global
# sm_ring_full_spins counter: the ztrace sm send span classifies
# ring-backpressure from the delta across ITS OWN call, and the global
# counter would cross-contaminate concurrent senders (thread ranks
# share one SPC table).
_thread_spins = threading.local()


def _note_full_spins(n: int) -> None:
    if n:
        _thread_spins.n = getattr(_thread_spins, "n", 0) + n


def thread_full_spins() -> int:
    """This thread's monotone full-ring spin total — sample before and
    after a send to attribute backpressure to that call alone."""
    return getattr(_thread_spins, "n", 0)

# category derivation (tools/mpit.py): the shared-memory plane's vars
# and counters — sm_*, btl_sm_* — are ONE family
mca_var.register_family("sm")
mca_var.register_family("btl_sm", "sm")

mca_var.register(
    "sm", 1,
    "Shared-memory transport for same-host Python ranks: 1 = create an "
    "mmap ring segment and ride it to same-boot peers, 0 = always TCP "
    "(asymmetric settings degrade the pair to TCP, the C plane's "
    "ZMPI_MCA_sm contract)",
    type=int,
)
mca_var.register(
    "sm_priority", 90,
    "Endpoint-selection priority of the sm transport (btl_sm_priority): "
    "sm is chosen for a same-host peer when this exceeds tcp_priority; "
    "set at/below it to force the wire path without disabling the rings",
    type=int,
)
mca_var.register(
    "sm_ring_bytes", 4 << 20,
    "Per-direction ring payload capacity in bytes (the C plane's "
    "SM_RING_BYTES twin; tmpfs pages allocate lazily, so untouched "
    "slots cost nothing); with sm_max_frag it fixes the slot count "
    "(nslots = sm_ring_bytes // sm_max_frag, floor 2) — the in-flight "
    "bound backpressure enforces",
    type=int,
)
mca_var.register(
    "sm_max_frag", 128 << 10,
    "Payload bytes per ring slot: messages above this fragment into a "
    "slot pipeline (consumer frees slots while the producer still "
    "copies, so messages larger than the whole ring stream through)",
    type=int,
)
mca_var.register(
    "sm_leader_ring_bytes", 2 << 20,
    "Ring payload capacity for the LEADER peer class (cross-NUMA-domain "
    "pairs on one host — the han dleader exchange): their traffic is "
    "the segmented eager exchange (coll_han_inter_segment pieces), so "
    "the ring can be shallower than the intra-domain class without "
    "losing throughput (frames larger than the ring still stream); "
    "sized separately so the demand-mapped footprint tracks the role",
    type=int,
)
mca_var.register(
    "sm_numa_id", "",
    "NUMA-domain identity override for the modex card (the pynuma: "
    "item): empty = derive from sysfs (/sys/devices/system/node "
    "cpulist vs this proc's affinity mask, single-domain when "
    "unreadable); set per rank to emulate multi-domain topologies "
    "exactly like the han bench's per-rank sm_boot_id",
)

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
# per-slot header: fragment length + total message length (a message is
# a contiguous run of fragments; only one can be in flight per ring, so
# continuation slots need no message id)
_SLOT = struct.Struct("<II")
_SLOT_HDR = 16  # _SLOT padded to 16 for payload alignment

_MAGIC = 0x335F4D5359505A00  # "\0ZPYSM_3" little-endian (v3: ring files)
_RING_HDR = 128              # head @+0, tail @+64 (cache-line separated)
# head and tail as u64 words of a native-order view of the ring header
# (the ring layout is little-endian; so are the hosts it runs on).  A
# word is stored and loaded whole: struct's pack_into zero-fills its
# bytes before writing them and unpack_from assembles bytes one by one,
# so a peer process racing either can read a torn value — a tail of 0
# read as "the ring is full" by a producer whose free slots are proven
_HEAD_WORD, _TAIL_WORD = 0, 64 // 8


def _ring_words(mv: memoryview, base: int = 0) -> memoryview:
    """The ring header at ``base`` as native u64 words (head, tail)."""
    return mv[base:base + _RING_HDR].cast("Q")
# control-segment header field offsets
_OFF_MAGIC = 0
_OFF_NRINGS = 12
_OFF_SPAN = 16       # u64: worst-class ring span (informational in v3)
_OFF_HDRLEN = 24     # u64: control header length (== file length in v3)
_OFF_DOORBELL = 64   # consumer sleep flag (futex word)
_OFF_STOPPED = 128   # owner's poll loop exited (peers stop quiescing)
_OFF_BITMAP = 256    # allocation bitmap: ceil(size/64) u64 words

# ring directory: one 64-byte entry per source rank, after the bitmap.
# state/klass are written by the (single) sender of that source rank,
# nslots/slot_bytes by the owner at materialization — no shared-word
# writers, so the handshake needs no cross-process atomics beyond the
# store-ordering fences already used by the rings themselves.
_DIRENT = 64
_DE_STATE = 0        # u32: _ST_EMPTY / _ST_REQUESTED / _ST_READY
_DE_CLASS = 4        # u32: requested peer class (sender-written)
_DE_NSLOTS = 8       # u32: final geometry (owner-written)
_DE_SLOT_BYTES = 12  # u32: final geometry (owner-written)
_ST_EMPTY, _ST_REQUESTED, _ST_READY = 0, 1, 2

# peer classes (ring sizing): same NUMA domain vs leader-to-leader
CLASS_INTRA = 0
CLASS_LEADER = 1


def _bitmap_words(size: int) -> int:
    return -(-size // 64)


def _dir_off(size: int) -> int:
    off = _OFF_BITMAP + _bitmap_words(size) * 8
    return (off + 63) & ~63


def _hdr_len(size: int) -> int:
    return (_dir_off(size) + size * _DIRENT + 4095) & ~4095

# poll cadence: stay hot (GIL-yielding spin) through a window that
# covers a ping-pong inter-arrival gap — dozing inside it puts the wake
# latency on the critical path of every message.  Past the window the
# thread parks on the doorbell futex, so idle procs cost nothing and
# wakeups are event-driven; the fallback without futex support sleeps in
# short bounded steps instead.  The window is the sm_poll_hot_us MCA var
# below (0 on single-CPU masks).


def _ncpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-linux
        return os.cpu_count() or 1


mca_var.register(
    "sm_poll_hot_us", 5000 if _ncpus() > 1 else 0,
    "Hot-spin window (microseconds) of the sm poll thread after its "
    "last traffic, before it parks on the doorbell futex.  Spinning "
    "only helps when a core is free to burn (the consumer must run "
    "WHILE the producer produces): on a single-CPU affinity mask the "
    "spinner steals the very core the producer needs — measured to "
    "serialize the han collectives' localized phases behind idle "
    "procs' spinners — so the default is 0 there and 5000 (the "
    "measured ping-pong cover) on multi-core hosts",
    type=int,
)
# the doze is also the bound on a lost wakeup the fence below cannot
# fully rule out — keep it SHORT
_DOZE_S = 0.005

# Full memory barrier for the sleep/wake handshake.  The doorbell is a
# Dekker protocol: a producer stores head then loads the sleep flag;
# the consumer stores the flag then re-reads every head — TSO's
# StoreLoad reordering can hide either store from the other side and
# park the consumer through a delivered frame.  Python exposes no
# fence, but an uncontended lock round-trip is an atomic RMW
# (LOCK-prefixed on x86, ldaxr/stlxr on arm64) and orders both sides;
# any residual miss is bounded by the doze timeout.
# Deliberately NOT a lockdep-witnessed lock: it is the memory fence on
# every ring produce/consume (the hottest acquire in the plane), it
# never nests, and nothing else may ever be taken under it.
_fence_lock = threading.Lock()


def _fence() -> None:
    with _fence_lock:
        pass


# ------------------------------------------------------------- futex --

FUTEX_WAIT = 0
FUTEX_WAKE = 1

_SYS_FUTEX = {
    "x86_64": 202, "aarch64": 98, "arm": 240, "armv7l": 240,
    "armv6l": 240, "i686": 240, "i386": 240, "ppc64le": 221,
    "s390x": 238, "riscv64": 98,
}.get(platform.machine())


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def _init_futex():
    if sys.platform != "linux" or _SYS_FUTEX is None:
        return None
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.syscall.restype = ctypes.c_long
        return libc
    except (OSError, AttributeError):
        return None


_libc = _init_futex()


def futex_available() -> bool:
    return _libc is not None


def _futex_wait(mm: mmap.mmap, off: int, expected: int,
                timeout_s: float) -> None:
    """Park on the shared word until woken, the value changes, or the
    timeout lapses.  ctypes releases the GIL for the syscall, so a
    parked poll thread costs nothing.  Without futex support this is a
    short bounded sleep — same liveness, more latency."""
    if _libc is None:
        time.sleep(min(timeout_s, 0.0002))
        return
    word = ctypes.c_uint32.from_buffer(mm, off)
    try:
        ts = _Timespec(int(timeout_s), int((timeout_s % 1.0) * 1e9))
        # non-PRIVATE futex: the word lives in a MAP_SHARED page and the
        # waker may be another process
        _libc.syscall(_SYS_FUTEX, ctypes.byref(word), FUTEX_WAIT,
                      expected, ctypes.byref(ts), 0, 0)
    finally:
        del word  # release the exported buffer before any mm.close()


def _futex_wake(mm: mmap.mmap, off: int, n: int = 1) -> None:
    if _libc is None:
        return
    word = ctypes.c_uint32.from_buffer(mm, off)
    try:
        _libc.syscall(_SYS_FUTEX, ctypes.byref(word), FUTEX_WAKE, n,
                      0, 0, 0)
    finally:
        del word


# ------------------------------------------- naming, hygiene registry --

_seg_counter = itertools.count()
_registry_lock = lockdep.lock("sm._registry_lock")
_created_paths: set[str] = set()
_live_segments: weakref.WeakSet = weakref.WeakSet()


def segment_dir() -> str:
    """Backing directory for ring segments: ``/dev/shm`` (a real tmpfs,
    the page-cache-free fast path) when present, tempdir otherwise —
    mmap sharing works on any file, only the residency guarantee
    differs."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else \
        tempfile.gettempdir()


def _session_tag() -> str:
    """Launcher session when present (zmpirun exports ZMPI_SESSION so
    one prefix sweep covers every rank it killed), else this pid."""
    tag = os.environ.get("ZMPI_SESSION")
    return tag if tag else f"p{os.getpid()}"


def _segment_name(rank: int) -> str:
    # pid + a process-unique counter: concurrently-living universes in
    # one test process can never collide, and an EEXIST at create can
    # only be a crashed job's leftover (pid reuse) — unlink and retry
    return (f"zompi_pyring_{_session_tag()}_{os.getpid()}_{rank}_"
            f"{next(_seg_counter)}")


def _create_shared_file(path: str, nbytes: int) -> mmap.mmap:
    """Create-and-map a shared backing file (control segment or ring) with
    the stale-unlink O_EXCL retry idiom, registered with the hygiene
    registry; a half-created file is never left behind."""
    flags = os.O_CREAT | os.O_EXCL | os.O_RDWR
    try:
        fd = os.open(path, flags, 0o600)
    except FileExistsError:
        # stale file from a crashed job (pid reuse): unlink, retry once
        try:
            os.unlink(path)
        except OSError:
            pass
        fd = os.open(path, flags, 0o600)
    try:
        try:
            os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    with _registry_lock:
        _created_paths.add(path)
    return mm


def orphaned_ring_files() -> list[str]:
    """Every Python-plane ring segment this process created that still
    exists on disk — the test-suite hygiene gate's view (the C plane's
    lifecycle contract: rings live exactly as long as their proc)."""
    with _registry_lock:
        created = list(_created_paths)
    return sorted(p for p in created if os.path.exists(p))


def live_poll_threads() -> list[str]:
    """Names of sm poll threads still alive across all (weakly tracked)
    segments — the leak gate's view, mirroring tcp.live_push_threads."""
    out = []
    for seg in list(_live_segments):
        t = seg._poll
        if t is not None and t.is_alive():
            out.append(t.name)
    return out


def boot_token() -> str:
    """Same-host identity for the modex card: two procs share a ring
    namespace iff their boot tokens match (hex-only, so a C-plane
    coordinator scanning caps for the substring "sm" can never
    misread it as a C ring capability)."""
    try:
        with open("/proc/sys/kernel/random/boot_id", "rb") as f:
            raw = f.read()
    except OSError:
        raw = socket.gethostname().encode()
    return hashlib.sha1(raw).hexdigest()[:12]


_CARD_PREFIX = "pyshm:"


def card_item(boot: str, name: str) -> str:
    return f"{_CARD_PREFIX}{boot}:{name}"


def parse_card(card) -> tuple[str, str] | None:
    """Extract ``(boot, segment_name)`` from a modex card's capability
    items (anything past ``[host, port]``); None when the peer
    advertised no Python-plane segment (sm off, C rank, rejoiner)."""
    if not isinstance(card, (list, tuple)):
        return None
    for item in card[2:]:
        if isinstance(item, str) and item.startswith(_CARD_PREFIX):
            parts = item.split(":", 2)
            if len(parts) == 3 and parts[1] and parts[2]:
                return parts[1], parts[2]
            # malformed/foreign item wearing our prefix: cards are
            # relayed verbatim from arbitrary peers — degrade, never
            # raise out of endpoint selection into send()
    return None


_NUMA_PREFIX = "pynuma:"

#: sentinel returned by :func:`parse_numa` for an item that WEARS the
#: pynuma prefix but cannot be a domain token (foreign/corrupt card):
#: the topology layer counts it and demotes the rank to a singleton
#: domain instead of letting a malformed foreign card raise out of a
#: collective's topology derivation
NUMA_MALFORMED = "\x00malformed"


def numa_card_item(token: str) -> str:
    return f"{_NUMA_PREFIX}{token}"


def parse_numa(card):
    """NUMA-domain token from a modex card's capability items: the
    token string, ``None`` when absent (old cards stay parseable —
    the host degrades to a single domain), or :data:`NUMA_MALFORMED`
    for a present-but-unusable item (cards are relayed verbatim from
    arbitrary peers — never raise out of topology derivation)."""
    if not isinstance(card, (list, tuple)):
        return None
    for item in card[2:]:
        if isinstance(item, str) and item.startswith(_NUMA_PREFIX):
            tok = item[len(_NUMA_PREFIX):]
            if tok and ":" not in tok and len(tok) <= 64:
                return tok
            return NUMA_MALFORMED
    return None


def _numa_from_sysfs() -> str:
    """This proc's NUMA domain via sysfs: the node whose cpulist holds
    the first CPU of our affinity mask (the hwloc-locality analog).
    Anything unreadable/degenerate collapses to domain "0" — a single
    domain, which the topology layer treats as "no NUMA structure"."""
    base = "/sys/devices/system/node"
    try:
        nodes = sorted(
            int(d[4:]) for d in os.listdir(base)
            if d.startswith("node") and d[4:].isdigit()
        )
        if len(nodes) < 2:
            return "0"
        cpu = min(os.sched_getaffinity(0))
        for n in nodes:
            with open(f"{base}/node{n}/cpulist") as f:
                for part in f.read().strip().split(","):
                    if not part:
                        continue
                    lo, _, hi = part.partition("-")
                    if int(lo) <= cpu <= int(hi or lo):
                        return str(n)
    except (OSError, ValueError):
        pass
    return "0"


def numa_token() -> str:
    """Domain identity for the modex card: the ``sm_numa_id`` MCA
    override when set (multi-domain emulation, exactly like the han
    bench's per-rank ``sm_boot_id``), else the sysfs derivation."""
    override = str(mca_var.get("sm_numa_id", "") or "").strip()
    if override:
        return override.replace(":", "_")[:64]
    return _numa_from_sysfs()


# close-time audit registry: every clean SmSegment.close() verifies its
# directory/bitmap/footprint invariants and records violations here for
# the conftest session gate (the demand-mapping contract: no ring
# materialized for a peer that never sent, no orphaned directory entry,
# physical pages within the bitmap-derived bound)
_audit_failures: list[str] = []


def segment_audit_failures() -> list[str]:
    with _registry_lock:
        return list(_audit_failures)


def _tuned_ring_bytes(varname: str, current: int) -> int:
    """Per-class ring sizing from a ztune-swept decision table (served
    through coll/ztable.py's store rung under ``ZMPI_PMIX``, then its
    file rung): adopted ONLY while ``varname`` still holds its registered
    default — an operator's explicit setting (env/file/API) always
    outranks the swept value.  No table, a table without a geometry
    line, or a table that fails to load keep the var's own value (said
    on the verbose stream)."""
    held = mca_var.lookup(varname)
    if held is not None and held.source != mca_var.VarSource.DEFAULT:
        return current
    from ..coll import ztable

    try:
        swept = ztable.table_geometry(varname, ztable.job_topology_key())
    except Exception as e:  # noqa: BLE001 - a bad table file keeps the var
        mca_output.verbose(
            2, _stream,
            "tuned geometry consult for %s failed (%s); the var's own "
            "value applies", varname, e,
        )
        return current
    if swept is None:
        return current
    return int(swept)


def _geometry() -> tuple[int, int]:
    slot_bytes = max(64, int(mca_var.get("sm_max_frag", 128 << 10)))
    ring_bytes = max(slot_bytes, _tuned_ring_bytes(
        "sm_ring_bytes", int(mca_var.get("sm_ring_bytes", 4 << 20))))
    nslots = max(2, ring_bytes // slot_bytes)
    return nslots, slot_bytes


def _class_geometry(klass: int) -> tuple[int, int]:
    """(nslots, slot_bytes) of a peer class, from the OWNER's vars at
    segment creation: intra-domain rings size by ``sm_ring_bytes``,
    leader-to-leader rings by ``sm_leader_ring_bytes`` — each
    adoptable from a ztune-swept table while the var is defaulted
    (:func:`_tuned_ring_bytes`)."""
    if klass == CLASS_LEADER:
        slot_bytes = max(64, int(mca_var.get("sm_max_frag", 128 << 10)))
        ring_bytes = max(slot_bytes, _tuned_ring_bytes(
            "sm_leader_ring_bytes",
            int(mca_var.get("sm_leader_ring_bytes", 2 << 20))))
        return max(2, ring_bytes // slot_bytes), slot_bytes
    return _geometry()


def _ring_span(nslots: int, slot_bytes: int) -> int:
    return _RING_HDR + nslots * (_SLOT_HDR + slot_bytes)


class RingFull(errors.InternalError):
    """The destination ring had no free slot within the caller's
    deadline.  A distinct type so the nonblocking (deferred-contract
    isend) path can probe with an already-expired deadline and park a
    producer continuation on the progress engine instead of blocking
    the caller; the blocking path still reads it as the stall it is
    (subclass of the InternalError it always raised)."""


class ConsumerStopped(errors.InternalError):
    """The destination ring's owner stopped consuming (sever/crash, or
    the tail of an orderly close): the peer is GONE.  A distinct type
    so the transport seam can classify it as peer death on ft procs —
    the sm twin of TCP's connection-reset-IS-death rule — instead of
    surfacing a bare transport error."""


class _RingState:
    """Consumer-side per-ring bookkeeping (the owner is the only
    consumer; ``tail`` here is authoritative, the shm copy exists for
    the producer's free-space check).  Geometry is per ring — peer
    classes size their rings differently under demand mapping — and
    each ring owns ITS OWN file mapping (layout v3: one file per
    materialized ring, head/tail at the file's start)."""

    __slots__ = ("src", "path", "mm", "mv", "words", "tail", "buf", "fill",
                 "nslots", "slot_bytes")

    def __init__(self, src: int, path: str, mm: mmap.mmap,
                 nslots: int, slot_bytes: int):
        self.src = src
        self.path = path
        self.mm = mm
        self.mv = memoryview(mm)
        self.words = _ring_words(self.mv)
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.tail = 0
        self.buf: bytearray | None = None  # partial message assembly
        self.fill = 0

    def close(self) -> None:
        self.words.release()
        self.mv.release()
        try:
            self.mm.close()
        except BufferError:  # pragma: no cover - exported view leaked
            pass


class SmSegment:
    """The receiver half: owns the mmap'd segment holding this proc's
    inbound rings and the poll thread that drains them.

    ``on_frame(src_ring, frame)`` is invoked on the poll thread with a
    dedicated writable bytearray per assembled message — the
    ``dss.unpack_from`` aliasing contract of the TCP receive path."""

    def __init__(self, rank: int, size: int, on_frame,
                 name: str | None = None):
        self.rank = rank
        self.size = size
        self._on_frame = on_frame
        # per-class geometry fixed at creation (the directory publishes
        # the materialized ring's actual shape, so a cross-proc MCA
        # mismatch still cannot desync the slot walk)
        self._class_geom = {
            CLASS_INTRA: _class_geometry(CLASS_INTRA),
            CLASS_LEADER: _class_geometry(CLASS_LEADER),
        }
        self.nslots, self.slot_bytes = self._class_geom[CLASS_INTRA]
        # layout v3: the control file is the HEADER ALONE — rings live
        # in their own files, so the virtual reservation is bounded by
        # the directory (O(size) bytes), not size × worst-class span
        span = max(_ring_span(n, s) for n, s in self._class_geom.values())
        self._hdr = _hdr_len(size)
        seg_len = self._hdr
        self.name = name or _segment_name(rank)
        self.path = os.path.join(segment_dir(), self.name)
        # stale-unlink O_EXCL retry + hygiene registration + never a
        # half-created file left behind
        self._mm = _create_shared_file(self.path, seg_len)
        # persistent read view: slicing an mmap OBJECT materializes an
        # intermediate bytes copy per read; slicing a memoryview of it
        # does not — the consumer's frag copy must be the only copy
        self._mv = memoryview(self._mm)
        mm = self._mm
        _U32.pack_into(mm, _OFF_NRINGS, size)
        _U64.pack_into(mm, _OFF_SPAN, span)
        _U64.pack_into(mm, _OFF_HDRLEN, self._hdr)
        # magic stamped LAST: a mapper that sees it sees the geometry
        _U64.pack_into(mm, _OFF_MAGIC, _MAGIC)
        self._span = span
        # demand mapping: rings materialize when their sender's first
        # contact writes an allocation request into the directory — the
        # poll loop scans _pending until every possible source is live
        self._rings: list[_RingState] = []
        self._pending = [src for src in range(size) if src != rank]
        # per-segment hot window (sm_poll_hot_us): 0 on single-CPU
        # affinity masks — see the var's rationale
        self._hot_s = max(0, int(mca_var.get("sm_poll_hot_us", 5000))) \
            / 1e6
        self._stop = threading.Event()
        self._closed = False
        self._severed = False
        self._regions: list["RmaRegion"] = []
        self._region_counter = itertools.count()
        self._close_lock = lockdep.lock("sm.SmSegment._close_lock")
        self._poll = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"sm-poll-{rank}-{os.getpid()}",
        )
        _live_segments.add(self)
        self._poll.start()

    def card(self, boot: str) -> str:
        return card_item(boot, self.name)

    # -- demand-mapped ring directory ------------------------------------

    def _dirent(self, src: int) -> int:
        return _dir_off(self.size) + src * _DIRENT

    def _ring_path(self, src: int) -> str:
        """The per-peer ring file of source rank `src` (layout v3):
        derived from the control segment's name, so a sender that read
        READY can open it without any name exchange and the launcher's
        ``zompi_pyring_<session>_`` prefix sweep covers it."""
        return f"{self.path}.r{src}"

    def _scan_requests(self) -> bool:
        """Materialize rings whose sender wrote an allocation request:
        create the per-peer ring FILE sized exactly to the class
        geometry, publish the geometry, set the bitmap bit, flip the
        entry READY, and start consuming.  Runs on the poll thread
        (the owner is the only writer of geometry/bitmap/READY, so the
        handshake needs no cross-process atomics)."""
        if not self._pending:
            return False
        mm = self._mm
        progressed = False
        for src in list(self._pending):
            off = self._dirent(src)
            if _U32.unpack_from(mm, off + _DE_STATE)[0] != _ST_REQUESTED:
                continue
            _fence()  # class write precedes the REQUESTED store
            klass = _U32.unpack_from(mm, off + _DE_CLASS)[0]
            nslots, slot_bytes = self._class_geom.get(
                klass, self._class_geom[CLASS_INTRA])
            rpath = self._ring_path(src)
            rmm = _create_shared_file(rpath, _ring_span(nslots,
                                                        slot_bytes))
            _U32.pack_into(mm, off + _DE_NSLOTS, nslots)
            _U32.pack_into(mm, off + _DE_SLOT_BYTES, slot_bytes)
            _fence()  # ring file + geometry must be visible before READY
            _U32.pack_into(mm, off + _DE_STATE, _ST_READY)
            word = _OFF_BITMAP + (src // 64) * 8
            bits = _U64.unpack_from(mm, word)[0]
            _U64.pack_into(mm, word, bits | (1 << (src % 64)))
            self._rings.append(_RingState(src, rpath, rmm, nslots,
                                          slot_bytes))
            self._pending.remove(src)
            spc.record("sm_rings_materialized", 1)
            mca_output.verbose(
                5, _stream,
                "rank %d: ring from rank %d materialized "
                "(class=%d, %d x %dB)", self.rank, src, klass, nslots,
                slot_bytes,
            )
            progressed = True
        return progressed

    def materialized(self) -> list[int]:
        """Source ranks whose inbound ring exists — the allocation
        bitmap's view (the OSU numa ladder's role-bound gate)."""
        return sorted(st.src for st in self._rings)

    def footprint_bytes(self) -> int:
        """Logical segment footprint: header pages plus every
        MATERIALIZED ring's span — the bitmap-derived bound the audit
        compares the tmpfs page count against (unmaterialized regions
        are sparse and cost nothing)."""
        return self._hdr + sum(_ring_span(st.nslots, st.slot_bytes)
                               for st in self._rings)

    def physical_bytes(self) -> int | None:
        """Actual backing pages of the control file plus every
        materialized ring file (tmpfs allocates on first touch;
        ``st_blocks`` is the honest footprint)."""
        try:
            total = os.stat(self.path).st_blocks * 512
            for st in self._rings:
                total += os.stat(st.path).st_blocks * 512
            return total
        except OSError:
            return None

    # -- RMA regions (the one-sided plane's backing store) ---------------

    def alloc_rma_region(self, nbytes: int) -> "RmaRegion":
        """Allocate a window/symmetric-heap backing region in this
        segment's namespace: its own file (``<segment>.w<idx>``) with
        the lock-word header, registered for the zero-orphan gate and
        unlinked at close unless a window freed it first."""
        region = RmaRegion(self, next(self._region_counter), nbytes)
        with _registry_lock:
            self._regions.append(region)
        return region

    def release_rma_region(self, region: "RmaRegion") -> None:
        """Window-free-time release: unmap and unlink the region file
        (the collective ``win.free`` already quiesced every origin)."""
        with _registry_lock:
            if region in self._regions:
                self._regions.remove(region)
        region.close(unlink=True)

    # -- consumer --------------------------------------------------------

    def _any_ready(self) -> bool:
        for st in self._rings:
            if st.words[_HEAD_WORD] != st.tail:
                return True
        return False

    def _drain_ring(self, st: _RingState) -> bool:
        mm = st.mm
        head = st.words[_HEAD_WORD]
        if head == st.tail:
            return False
        _fence()  # acquire edge: slot reads must not pass the head load
        nslots, slot_bytes = st.nslots, st.slot_bytes
        while st.tail < head:
            slot = _RING_HDR + \
                (st.tail % nslots) * (_SLOT_HDR + slot_bytes)
            frag_len, total = _SLOT.unpack_from(mm, slot)
            if frag_len > slot_bytes:  # pragma: no cover - corruption
                raise errors.InternalError(
                    f"sm ring from rank {st.src}: fragment of {frag_len}"
                    f" bytes exceeds the {slot_bytes}-byte slot"
                )
            if st.buf is None:
                st.buf = bytearray(total)
                st.fill = 0
            data = slot + _SLOT_HDR
            st.buf[st.fill:st.fill + frag_len] = \
                st.mv[data:data + frag_len]
            st.fill += frag_len
            spc.record("sm_bytes_recvd", frag_len + _SLOT_HDR)
            st.tail += 1
            if st.fill >= len(st.buf):
                frame, st.buf = st.buf, None
                # deliver BEFORE publishing the final fragment's tail:
                # a sender observing head == tail may then rely on every
                # completed message having reached the matching engine
                # (the close-quiesce ordering the BYE goodbye needs)
                try:
                    self._on_frame(st.src, frame)
                except Exception as e:  # noqa: BLE001 - keep polling
                    mca_output.emit(
                        _stream,
                        "rank %s: sm frame dispatch from %s failed: "
                        "%s: %s", self.rank, st.src,
                        type(e).__name__, e,
                    )
            # the tail store is the release edge freeing the slot: the
            # copy-out above must be globally done first (a producer
            # reuses the slot the moment it sees the new tail)
            _fence()
            st.words[_TAIL_WORD] = st.tail
        return True

    def _poll_loop(self) -> None:
        mm = self._mm
        hot_until = time.monotonic() + self._hot_s
        try:
            while not self._stop.is_set():
                progressed = self._scan_requests()
                for st in self._rings:
                    progressed |= self._drain_ring(st)
                now = time.monotonic()
                if progressed:
                    hot_until = now + self._hot_s
                    continue
                if now < hot_until:
                    # hot but cooperative: yield the GIL every pass so
                    # the app threads this poll serves can actually run.
                    # The window is bounded by sm_poll_hot_us (0 on
                    # 1-CPU affinity masks), then the loop dozes on the
                    # futex
                    # zlint: disable=ZL003 -- bounded hot-yield window, futex doze beyond it
                    time.sleep(0)
                    continue
                # doze: announce sleep, re-check (lost-wakeup guard:
                # heads AND allocation requests — a first-contact
                # sender rings the same doorbell), park bounded — a
                # missed doorbell costs one doze
                _U32.pack_into(mm, _OFF_DOORBELL, 1)
                _fence()  # flag store must precede the head re-reads
                if self._any_ready() or self._scan_requests() \
                        or self._stop.is_set():
                    _U32.pack_into(mm, _OFF_DOORBELL, 0)
                    hot_until = time.monotonic() + self._hot_s
                    continue
                _futex_wait(mm, _OFF_DOORBELL, 1, _DOZE_S)
                _U32.pack_into(mm, _OFF_DOORBELL, 0)
        except Exception as e:  # noqa: BLE001 - thread boundary
            mca_output.emit(
                _stream, "rank %s: sm poll loop died: %s: %s",
                self.rank, type(e).__name__, e,
            )
        finally:
            # peers' close-quiesce loops watch this: once the consumer
            # is gone, waiting for the rings to drain is waiting forever
            try:
                _U32.pack_into(mm, _OFF_STOPPED, 1)
            except ValueError:  # pragma: no cover - mm closed under us
                pass

    # -- lifecycle -------------------------------------------------------

    def sever(self) -> None:
        """Crash simulation: consumption stops, the file survives (a
        real crash cleans nothing up — the launcher sweep / final
        harness close owns the unlink; the close-time audit is skipped
        for a severed segment, a crash honors no invariants)."""
        self._severed = True
        self._stop.set()
        try:
            _futex_wake(self._mm, _OFF_DOORBELL)
        except ValueError:
            pass
        self._poll.join(timeout=5.0)

    def _audit(self) -> None:
        """Demand-mapping invariants, checked once at clean close and
        recorded for the conftest session gate: every bitmap bit
        matches a READY directory entry matches a consuming ring, no
        allocation request was left unserved (orphaned directory
        entry), and the tmpfs page count stays within the
        bitmap-derived bound (no pages touched for peers that never
        sent)."""
        mm = self._mm
        fails: list[str] = []
        ready = {st.src for st in self._rings}
        try:
            for src in range(self.size):
                if src == self.rank:
                    continue
                off = self._dirent(src)
                state = _U32.unpack_from(mm, off + _DE_STATE)[0]
                if state == _ST_REQUESTED:
                    # a request racing the close: its sender observes
                    # _OFF_STOPPED within one spin iteration and rolls
                    # the entry back to EMPTY — grant that rollback a
                    # bounded grace before calling the entry orphaned
                    # (a crashed-mid-handshake sender stays flagged)
                    deadline = time.monotonic() + 0.2
                    while state == _ST_REQUESTED \
                            and time.monotonic() < deadline:
                        time.sleep(0.001)
                        state = _U32.unpack_from(
                            mm, off + _DE_STATE)[0]
                word = _OFF_BITMAP + (src // 64) * 8
                bit = (_U64.unpack_from(mm, word)[0] >> (src % 64)) & 1
                if state == _ST_REQUESTED:
                    fails.append(
                        f"{self.name}: rank {src}'s ring request was "
                        "never materialized (orphaned directory entry)"
                    )
                if bool(bit) != (state == _ST_READY):
                    fails.append(
                        f"{self.name}: bitmap bit for rank {src} "
                        f"({bit}) disagrees with directory state "
                        f"({state})"
                    )
                if (state == _ST_READY) != (src in ready):
                    fails.append(
                        f"{self.name}: directory ready="
                        f"{state == _ST_READY} for rank {src} but "
                        f"consumer materialized={src in ready}"
                    )
                if state == _ST_READY and \
                        not os.path.exists(self._ring_path(src)):
                    fails.append(
                        f"{self.name}: READY directory entry for rank "
                        f"{src} but its ring file is gone"
                    )
            phys = self.physical_bytes()
            if phys is not None and self.path.startswith("/dev/shm"):
                # slack: each file rounds to page granularity at its
                # tail, plus header slop in the control file
                bound = self.footprint_bytes() + \
                    (2 * len(ready) + 2) * 4096
                if phys > bound:
                    fails.append(
                        f"{self.name}: physical footprint {phys}B "
                        f"exceeds the bitmap-derived bound {bound}B "
                        "(pages touched outside materialized rings)"
                    )
        except ValueError:  # pragma: no cover - mm closed under us
            return
        if fails:
            with _registry_lock:
                _audit_failures.extend(fails)

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        try:
            _futex_wake(self._mm, _OFF_DOORBELL)
        except ValueError:
            pass
        self._poll.join(timeout=5.0)
        if not getattr(self, "_severed", False):
            self._audit()
        # RMA regions a window never freed (abnormal teardown) are
        # unlinked here — the harness close owns the final sweep
        with _registry_lock:
            regions = list(self._regions)
            self._regions = []
        for region in regions:
            region.close(unlink=True)
        for st in self._rings:
            st.close()
            try:
                os.unlink(st.path)
            except OSError:
                pass
            with _registry_lock:
                _created_paths.discard(st.path)
        self._mv.release()
        try:
            self._mm.close()
        except BufferError:  # pragma: no cover - exported view leaked
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        with _registry_lock:
            _created_paths.discard(self.path)


class SmSender:
    """The producer half: maps a peer's CONTROL segment, runs the tiny
    allocate handshake (first contact materializes this source's ring
    file through the owner's doorbell machinery), maps the per-peer
    ring file, and streams frames into it.  Geometry comes from the
    control segment's RING DIRECTORY, not local MCA state — mismatched
    vars between procs cannot desynchronize the slot walk, and the
    owner alone decides each peer class's ring capacity."""

    def __init__(self, name: str, src_rank: int, dest_rank: int,
                 ring_class: int = CLASS_INTRA, timeout: float = 10.0):
        self.dest = dest_rank
        self.path = os.path.join(segment_dir(), name)
        fd = os.open(self.path, os.O_RDWR)
        try:
            seg_len = os.fstat(fd).st_size
            if seg_len < 4096:
                raise errors.InternalError(
                    f"sm segment {name}: truncated ({seg_len} bytes)"
                )
            self._cmm = mmap.mmap(fd, seg_len)
        finally:
            os.close(fd)
        cmm = self._cmm
        self._mm: mmap.mmap | None = None
        try:
            if _U64.unpack_from(cmm, _OFF_MAGIC)[0] != _MAGIC:
                raise errors.InternalError(
                    f"sm segment {name}: bad magic (creator still "
                    "stamping, v2 layout, or foreign file)"
                )
            nrings = _U32.unpack_from(cmm, _OFF_NRINGS)[0]
            hdr = _U64.unpack_from(cmm, _OFF_HDRLEN)[0]
            if src_rank >= nrings:
                raise errors.InternalError(
                    f"sm segment {name}: rank {src_rank} outside its "
                    f"{nrings}-ring universe"
                )
            if seg_len < hdr:
                raise errors.InternalError(
                    f"sm segment {name}: {seg_len} bytes < {hdr} "
                    "expected"
                )
            self._entry = _dir_off(nrings) + src_rank * _DIRENT
            self._handshake(ring_class, timeout)
            self.nslots = _U32.unpack_from(
                cmm, self._entry + _DE_NSLOTS)[0]
            self.slot_bytes = _U32.unpack_from(
                cmm, self._entry + _DE_SLOT_BYTES)[0]
            if not self.nslots or not self.slot_bytes:
                raise errors.InternalError(
                    f"sm segment {name}: corrupt directory geometry "
                    f"({self.nslots} x {self.slot_bytes}B)"
                )
            # READY implies the owner created-and-sized the ring file
            # BEFORE publishing (the fence ordering in _scan_requests)
            ring_path = f"{self.path}.r{src_rank}"
            span = _ring_span(self.nslots, self.slot_bytes)
            rfd = os.open(ring_path, os.O_RDWR)
            try:
                if os.fstat(rfd).st_size < span:
                    raise errors.InternalError(
                        f"sm ring file {ring_path}: smaller than its "
                        f"directory geometry ({span}B)"
                    )
                self._mm = mmap.mmap(rfd, span)
            finally:
                os.close(rfd)
        except BaseException:
            if self._mm is not None:
                self._mm.close()
            cmm.close()
            raise
        self._base = 0
        self._mv = memoryview(self._mm)  # no-copy slot windows
        self._words = _ring_words(self._mv, self._base)
        self._head = self._words[_HEAD_WORD]
        self._lock = lockdep.lock("sm.SmSender._lock")
        self._dead = False

    def _handshake(self, ring_class: int, timeout: float) -> None:
        """Demand-map this source's ring: write the peer class, flip
        the directory entry REQUESTED, ring the doorbell, and wait for
        the owner's poll thread to publish READY + geometry.  A ring an
        earlier same-rank sender already materialized is adopted as-is
        (its geometry is the contract)."""
        mm = self._cmm
        if _U32.unpack_from(mm, self._entry + _DE_STATE)[0] == _ST_READY:
            _fence()
            return
        _U32.pack_into(mm, self._entry + _DE_CLASS, int(ring_class))
        _fence()  # class store precedes the REQUESTED store
        _U32.pack_into(mm, self._entry + _DE_STATE, _ST_REQUESTED)
        self._doorbell()
        deadline = time.monotonic() + timeout
        spins = 0
        while _U32.unpack_from(
                mm, self._entry + _DE_STATE)[0] != _ST_READY:
            if _U32.unpack_from(mm, _OFF_STOPPED)[0]:
                # roll the request back before surfacing: a STOPPED
                # owner provably never serves it, and this sender is
                # the sole writer of a not-READY state word — the
                # request must not linger as an orphaned directory
                # entry for the owner's close-time audit to trip over
                if _U32.unpack_from(
                        mm, self._entry + _DE_STATE)[0] != _ST_READY:
                    _U32.pack_into(mm, self._entry + _DE_STATE,
                                   _ST_EMPTY)
                raise ConsumerStopped(
                    f"sm ring to rank {self.dest}: consumer stopped "
                    "before materializing the ring"
                )
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"sm ring to rank {self.dest}: allocation "
                    "handshake timed out (owner poll thread wedged?)"
                )
            spins += 1
            time.sleep(0 if spins < 200 else 0.0001)
        _fence()  # geometry reads must not pass the READY load

    # -- producer --------------------------------------------------------

    def _wait_slot(self, deadline: float, abort) -> None:
        """Block until the ring has a free slot.  ``abort()`` is
        consulted every spin so peer death / local close classifies
        promptly instead of riding out the stall timeout."""
        mm = self._mm
        spins = 0
        while True:
            # a stopped consumer is checked BEFORE accepting a free
            # slot: publishing into a ring nobody will ever drain again
            # would report success for up to a whole ring of silently
            # lost messages — the TCP path errors after at most one
            # kernel-buffered send, and the sm path must match it
            if _U32.unpack_from(self._cmm, _OFF_STOPPED)[0]:
                if spins:
                    spc.record("sm_ring_full_spins", spins)
                    _note_full_spins(spins)
                raise ConsumerStopped(
                    f"sm ring to rank {self.dest}: consumer stopped"
                )
            tail = self._words[_TAIL_WORD]
            if self._head - tail < self.nslots:
                if spins:
                    spc.record("sm_ring_full_spins", spins)
                    _note_full_spins(spins)
                return
            if abort is not None:
                abort()
            if time.monotonic() > deadline:
                spc.record("sm_ring_full_spins", spins)
                _note_full_spins(spins)
                raise RingFull(
                    f"sm ring to rank {self.dest} full past the stall "
                    "timeout (peer wedged?)"
                )
            spins += 1
            time.sleep(0 if spins < 200 else 0.00005)

    def _doorbell(self) -> None:
        mm = self._cmm
        _fence()  # head store must precede the sleep-flag load
        if _U32.unpack_from(mm, _OFF_DOORBELL)[0]:
            _U32.pack_into(mm, _OFF_DOORBELL, 0)
            _futex_wake(mm, _OFF_DOORBELL)

    def _publish(self, slot: int, frag_len: int, total: int) -> None:
        # the head store is the release edge: payload + slot header must
        # be globally visible first.  Program order suffices on TSO; the
        # fence (atomic RMW) makes it hold on weaker architectures — the
        # discipline of a release store
        mm = self._mm
        _SLOT.pack_into(mm, slot, frag_len, total)
        _fence()
        self._head += 1
        self._words[_HEAD_WORD] = self._head
        self._doorbell()

    def _slot_at(self, idx: int) -> int:
        return self._base + _RING_HDR + \
            (idx % self.nslots) * (_SLOT_HDR + self.slot_bytes)

    def send_direct(self, objs: tuple, oob_min: int, deadline: float,
                    abort) -> int | None:
        """Single-slot fast path: acquire a slot and pack the DSS header
        straight into slot memory (``dss.pack_frames_into`` — no
        intermediate header buffer), then copy the out-of-band segments
        behind it.  Returns on-ring bytes, or None when the frame does
        not fit one slot (caller takes the fragment pipeline)."""
        with self._lock:
            if self._dead:
                raise errors.InternalError(
                    f"sm ring to rank {self.dest} is torn down"
                )
            self._wait_slot(deadline, abort)
            slot = self._slot_at(self._head)
            window = self._mv[slot + _SLOT_HDR:
                              slot + _SLOT_HDR + self.slot_bytes]
            try:
                try:
                    hlen, segs = dss.pack_frames_into(
                        window, *objs, oob_min=oob_min
                    )
                except errors.TruncateError:
                    return None  # header alone overflows: fragment path
                total = hlen + sum(s.nbytes for s in segs)
                if total > self.slot_bytes:
                    return None
                off = hlen
                for seg in segs:
                    v = seg if seg.format == "B" and seg.ndim == 1 \
                        else seg.cast("B")
                    window[off:off + v.nbytes] = v
                    off += v.nbytes
            finally:
                window.release()
            self._publish(slot, total, total)
            return total + _SLOT_HDR

    def _frame_views(self, header, segments
                     ) -> tuple[list[memoryview], int, int]:
        """Shared prelude of the frame senders: flatten header +
        segments to non-empty byte views, validate the u32 framing
        bound, and compute the adaptive fragment size — ~8 fragments so
        the consumer's copy-out overlaps the remaining copy-ins (the
        pipeline is the whole point — measured 3x on 64 KiB messages vs
        one serial copy-in/copy-out), but never below 16 KiB:
        per-fragment interpreter overhead dominates tiny slots and
        would erase the multi-MiB win.  Returns (views, total, pipe)."""
        views = [memoryview(header)]
        for seg in segments:
            v = seg if isinstance(seg, memoryview) else memoryview(seg)
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            views.append(v)
        views = [v for v in views if v.nbytes]
        total = sum(v.nbytes for v in views)
        if total >= 1 << 32:
            raise errors.ArgError(
                f"sm frame of {total} bytes exceeds the u32 framing"
            )
        pipe = min(self.slot_bytes, max(16 << 10, total // 8))
        return views, total, pipe

    def try_send_frame(self, header, segments) -> tuple[int, int] | None:
        """Nonblocking :meth:`send_frame`: runs the fragment pipeline
        ONLY when the ring's free slots already cover the whole frame —
        the copy-in then completes without ever waiting on the consumer
        (free slots only grow under the producer lock: the consumer
        can only advance ``tail``).  Returns None when the frame does
        not currently fit; the caller parks a producer continuation
        instead of blocking (the deferred-contract isend path)."""
        views, total, pipe = self._frame_views(header, segments)
        with self._lock:
            if self._dead:
                raise errors.InternalError(
                    f"sm ring to rank {self.dest} is torn down"
                )
            if _U32.unpack_from(self._cmm, _OFF_STOPPED)[0]:
                raise ConsumerStopped(
                    f"sm ring to rank {self.dest}: consumer stopped"
                )
            nfrags = max(1, -(-total // pipe))
            tail = self._words[_TAIL_WORD]
            if self.nslots - (self._head - tail) < nfrags:
                return None
            return self._stream_frame(views, total, pipe)

    def send_frame(self, header, segments, deadline: float,
                   abort) -> tuple[int, int]:
        """Stream one frame (header + out-of-band segments) as a
        fragment pipeline: each fragment is copied from the caller's
        buffers straight into slot memory and published immediately, so
        the consumer overlaps assembly with the remaining copies.
        Returns ``(on_ring_bytes, nfrags)``."""
        views, total, pipe = self._frame_views(header, segments)
        with self._lock:
            if self._dead:
                raise errors.InternalError(
                    f"sm ring to rank {self.dest} is torn down"
                )
            return self._stream_frame(views, total, pipe,
                                      deadline=deadline, abort=abort)

    def _stream_frame(self, views, total: int, pipe: int,
                      deadline: float | None = None,
                      abort=None) -> tuple[int, int]:
        """Fragment-pipeline copy-in, producer lock held.  A None
        deadline means the caller already proved the free slots cover
        the frame (try_send_frame) — the slot waits degenerate to the
        free-slot check."""
        mm = self._mm
        vi, voff = 0, 0
        remaining = total
        nfrags = 0
        while True:
            self._wait_slot(
                time.monotonic() if deadline is None else deadline,
                abort,
            )
            slot = self._slot_at(self._head)
            frag = min(pipe, remaining)
            off = slot + _SLOT_HDR
            left = frag
            while left:
                v = views[vi]
                take = min(left, v.nbytes - voff)
                mm[off:off + take] = v[voff:voff + take]
                off += take
                voff += take
                left -= take
                if voff == v.nbytes:
                    vi += 1
                    voff = 0
            self._publish(slot, frag, total)
            nfrags += 1
            remaining -= frag
            if remaining == 0:
                break
        return total + nfrags * _SLOT_HDR, nfrags

    # -- quiesce / teardown ---------------------------------------------

    def pending(self) -> int:
        """Fragments published but not yet consumed-and-delivered (the
        close-quiesce probe); 0 once the peer delivered everything.
        Lock-free: the failure listener may close() this sender from
        another thread mid-probe, and a probe of a just-closed mmap
        must read as drained, not crash the closing proc."""
        if self._dead:
            return 0
        try:
            return self._head - self._words[_TAIL_WORD]
        except ValueError:  # closed under us: nothing left to wait for
            return 0

    def peer_stopped(self) -> bool:
        if self._dead:
            return True
        try:
            return bool(_U32.unpack_from(self._cmm, _OFF_STOPPED)[0])
        except ValueError:
            return True

    def close(self) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._words.release()
            self._mv.release()
            for m in (self._mm, self._cmm):
                try:
                    m.close()
                except BufferError:  # pragma: no cover - view leaked
                    pass


# ------------------------------------------------- RMA regions --------
# The one-sided data plane's backing store: a window (or symmetric
# heap) allocated inside the owner's sm namespace as its own file,
# mmap-ed by same-host origins for direct load/store put/get.  The
# page-sized region header carries the lock word serializing
# fetch-atomics cross-process, the shared/exclusive passive-target
# lock state with a per-rank holder table, and the futex generation
# word blocked lock waiters park on (the sm doorbell idiom applied to
# locks).  ``osc/direct.py`` is the consumer.

_RMA_MAGIC = 0x31414D5259505A00  # "\0ZPYRMA1" little-endian
_RH_OWNER = 8       # u32: owner rank
_RH_NPROCS = 12     # u32: universe size (bounds the holder table)
_RH_DATA_LEN = 16   # u64: window data bytes
_RH_DATA_OFF = 24   # u64: data offset (== header length)
_RH_GEN = 32        # u32: lock-handoff generation (waiters' futex word)
_RH_MUTEX = 36      # u32: region lock word (0 free, holder rank+1)
_RH_READERS = 40    # u32: shared passive-lock holder count
_RH_WRITER = 44     # u32: exclusive passive-lock holder rank+1 (0 none)
_RH_AMQ = 48        # u32: AM-origin lock waiters queued at the owner
_RH_POSTS = 52      # u32: PSCW exposure-epoch doorbell (post count;
                    #      parked origins' futex word)
_RH_COMPLETES = 56  # u32: PSCW completion doorbell (complete count;
                    #      the parked target's futex word)
_RH_TABLE = 64      # u32[nprocs]: per-rank passive-lock state

# per-rank holder-table states: the waiting-writer state makes writer
# priority crash-recoverable (a dead waiter's slot is cleared at
# classification like a dead holder's) and lets shared acquirers defer
# without a separate — unrecoverable — waiting-writers counter
_LK_NONE, _LK_SHARED, _LK_EXCL, _LK_WAITW = 0, 1, 2, 3

_MUTEX_WAIT = 1 << 31  # waiters-present bit of the region lock word

# zompi_shm_amo operand codes (native/shm_amo.cpp enums)
_AMO_ADD, _AMO_SWAP, _AMO_CAS, _AMO_SET, _AMO_FETCH = range(5)
_U32_CODE = 5  # TYPE_CODES["uint32"]


def _rma_hdr_len(nprocs: int) -> int:
    return (_RH_TABLE + 4 * nprocs + 4095) & ~4095


def _native_amo():
    """The port's ``__atomic`` AMO library (``native/shm_amo.cpp``, the
    namesake's entry points and codes), or None when ``native_kernels``/
    ``ZOMPI_NATIVE=0`` select the flock domain: the region lock word then
    degrades to flock-serialized critical sections on the region fd
    (kernel-blocking, crash-released, never a poll).  A failed build
    raises."""
    from .. import native

    return native.load()


class RegionOwnerGone(errors.InternalError):
    """The region's backing mapping is gone (owner closed/died while a
    lock or atomic was in flight): a distinct type so the window plane
    can classify it against the FailureState instead of surfacing a
    bare transport error."""


class RmaMapping:
    """One process's mapping of an RMA region file: the shared
    lock-word/passive-lock protocol plus a writable view of the data
    bytes.  The OWNER's side is :class:`RmaRegion` (creates, unlinks);
    origins construct this directly over the advertised file name.

    Atomicity domains: ``atomic()`` is the region lock word — an
    uncontended native CAS (or an flock critical section without the
    kernel library) + futex-parked contention — and EVERY mutator of
    the passive-lock words runs under it, so direct origins, the
    owner's local ops, and the owner's AM service all serialize on the
    same word.  Blocked passive-target lock waiters park on the
    GENERATION futex word and are woken by every unlock (shared count
    / writer word handoff — the doorbell idiom)."""

    def __init__(self, path: str, my_rank: int, _create=None):
        self.path = path
        self._my = my_rank
        self._closed = False
        if _create is not None:
            nprocs, nbytes, owner = _create
            hdr = _rma_hdr_len(nprocs)
            self._mm = _create_shared_file(path, hdr + nbytes)
            geo = memoryview(self._mm)[:_RH_TABLE].cast("Q")
            try:
                w32 = geo.cast("B").cast("I")
                w32[_RH_OWNER >> 2] = owner
                w32[_RH_NPROCS >> 2] = nprocs
                w32.release()
                geo[_RH_DATA_LEN >> 3] = nbytes
                geo[_RH_DATA_OFF >> 3] = hdr
                _fence()  # header fields visible before the magic stamp
                geo[0] = _RMA_MAGIC
            finally:
                geo.release()
            self._fd = os.open(path, os.O_RDWR)
        else:
            self._fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(self._fd).st_size
                if size < 4096:
                    raise errors.InternalError(
                        f"rma region {path}: truncated ({size} bytes)"
                    )
                self._mm = mmap.mmap(self._fd, size)
                with memoryview(self._mm)[:8].cast("Q") as magic:
                    stamped = magic[0] == _RMA_MAGIC
                if not stamped:
                    self._mm.close()
                    raise errors.InternalError(
                        f"rma region {path}: bad magic (creator still "
                        "stamping or foreign file)"
                    )
            except BaseException:
                os.close(self._fd)
                raise
        mm = self._mm
        with memoryview(mm)[:_RH_TABLE].cast("Q") as geo:
            self.data_len = geo[_RH_DATA_LEN >> 3]
            self.data_off = geo[_RH_DATA_OFF >> 3]
            with geo.cast("B").cast("I") as w32:
                self.owner_rank = w32[_RH_OWNER >> 2]
                self.nprocs = w32[_RH_NPROCS >> 2]
        if self.data_off + self.data_len > len(mm) or \
                _rma_hdr_len(self.nprocs) != self.data_off:
            try:
                self._mm.close()
            finally:
                os.close(self._fd)
            raise errors.InternalError(
                f"rma region {path}: corrupt geometry "
                f"({self.data_off}+{self.data_len} in {len(mm)}B)"
            )
        #: the header as native u32 words: every header word is loaded
        #: and stored whole (struct's pack_into/unpack_from go byte by
        #: byte, so a peer racing them can read a torn lock, generation
        #: or doorbell word)
        self._w32 = memoryview(mm)[:self.data_off].cast("I")
        self._arr = np.frombuffer(mm, dtype=np.uint8)
        #: writable uint8 view of the window data bytes (direct
        #: load/store lands here); .ctypes.data of `_arr` is the base
        #: address the native AMOs operate on
        self.data = self._arr[self.data_off:self.data_off
                              + self.data_len]
        self._lock = lockdep.lock("sm.RmaMapping._lock")
        self._use_native = _native_amo() is not None

    def _ld(self, off: int) -> int:
        return self._w32[off >> 2]

    def _st(self, off: int, value: int) -> None:
        self._w32[off >> 2] = value & 0xFFFFFFFF

    # -- the region lock word (fetch-atomics serialization) -----------

    def _word(self, off: int) -> int:
        return self._ld(off)

    def _amo32(self, off: int, kind: int, value: int = 0,
               compare: int = 0) -> int:
        lib = _native_amo()
        addr = self._arr.ctypes.data + off
        oi = ctypes.c_int64(0)
        of = ctypes.c_double(0.0)
        rc = lib.zompi_shm_amo(ctypes.c_void_p(addr), _U32_CODE, kind,
                               int(value), int(compare), 0.0, 0.0,
                               ctypes.byref(oi), ctypes.byref(of))
        if rc != 0:  # pragma: no cover - table covers uint32
            raise errors.InternalError("native AMO refused uint32")
        return oi.value & 0xFFFFFFFF

    def _mutex_acquire(self, deadline: float, abort) -> None:
        me = self._my + 1
        while True:
            old = self._amo32(_RH_MUTEX, _AMO_CAS, value=me, compare=0)
            if old == 0:
                return
            if not (old & _MUTEX_WAIT):
                # announce a waiter so the release knows to wake; a
                # lost race just re-reads on the next pass
                self._amo32(_RH_MUTEX, _AMO_CAS,
                            value=old | _MUTEX_WAIT, compare=old)
            if abort is not None:
                abort()
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"rma region {self.path}: lock word held past the "
                    "stall timeout (holder wedged?)"
                )
            try:
                _futex_wait(self._mm, _RH_MUTEX, old | _MUTEX_WAIT,
                            0.05)
            except ValueError:  # mapping closed under us (peer death
                raise RegionOwnerGone(  # listener): classify, not crash
                    f"rma region {self.path} unmapped mid-wait"
                )

    def _mutex_release(self) -> None:
        old = self._amo32(_RH_MUTEX, _AMO_SWAP, value=0)
        if old & _MUTEX_WAIT:
            _futex_wake(self._mm, _RH_MUTEX, 64)

    def _flock_acquire(self, deadline: float, abort) -> None:
        """Non-blocking-retry flock so the fallback honors the SAME
        abort/stall contract as the native lock word (a plain LOCK_EX
        blocks uninterruptibly — a wedged holder would hang the caller
        past any classification).  5 ms retry steps: the hold times are
        sub-microsecond RMWs, so contention resolves in one step."""
        while True:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return
            except OSError:
                if abort is not None:
                    abort()
                if time.monotonic() > deadline:
                    raise errors.InternalError(
                        f"rma region {self.path}: flock held past the "
                        "stall timeout (holder wedged?)"
                    )
                time.sleep(0.005)

    @contextlib.contextmanager
    def atomic(self, abort=None, timeout: float = 30.0):
        """The region's atomicity domain: per-instance thread lock +
        the cross-process lock word (native CAS + futex park; flock
        retry steps when the kernel library is unavailable — both
        honoring the abort/stall-timeout contract)."""
        with self._lock:
            if self._closed:
                raise RegionOwnerGone(
                    f"rma region {self.path} is unmapped"
                )
            if self._use_native:
                self._mutex_acquire(time.monotonic() + timeout, abort)
                try:
                    yield
                finally:
                    self._mutex_release()
            else:
                self._flock_acquire(time.monotonic() + timeout, abort)
                try:
                    yield
                finally:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)

    # -- passive-target (MPI_Win_lock) protocol -----------------------

    def _slot(self, rank: int) -> int:
        if not 0 <= rank < self.nprocs:
            raise errors.RankError(
                f"rank {rank} outside the {self.nprocs}-rank region"
            )
        return _RH_TABLE + 4 * rank

    def _writer_waiting(self) -> bool:
        for r in range(self.nprocs):
            if self._ld(_RH_TABLE + 4 * r) == _LK_WAITW:
                return True
        return False

    def try_lock(self, rank: int, exclusive: bool) -> bool:
        """One grant attempt; caller MUST hold :meth:`atomic`.  Shared
        requests defer to a waiting writer (no reader starvation of
        writers — the window plane's FIFO-fairness contract)."""
        slot = self._slot(rank)
        readers = self._ld(_RH_READERS)
        writer = self._ld(_RH_WRITER)
        if exclusive:
            if readers == 0 and writer == 0:
                self._st(_RH_WRITER, rank + 1)
                self._st(slot, _LK_EXCL)
                return True
            return False
        if writer == 0 and not self._writer_waiting():
            self._st(_RH_READERS, readers + 1)
            self._st(slot, _LK_SHARED)
            return True
        return False

    def mark_waiting(self, rank: int) -> None:
        """Record `rank` as a waiting writer (shared acquirers defer to
        it — writer priority); caller holds :meth:`atomic`."""
        slot = self._slot(rank)
        if self._ld(slot) == _LK_NONE:
            self._st(slot, _LK_WAITW)

    def _bump_gen_locked(self) -> None:
        gen = self._ld(_RH_GEN)
        self._st(_RH_GEN, (gen + 1) & 0xFFFFFFFF)

    def lock(self, rank: int, exclusive: bool, abort=None,
             timeout: float = 60.0) -> None:
        """Acquire the passive-target lock for `rank`, parking on the
        generation futex word between attempts (event-driven: every
        unlock bumps the generation and wakes).  ``abort()`` is
        consulted each wake so peer/owner death classifies instead of
        riding out the stall timeout."""
        deadline = time.monotonic() + timeout
        waiting = False
        try:
            while True:
                with self.atomic(abort=abort):
                    gen = self._word(_RH_GEN)
                    if self.try_lock(rank, exclusive):
                        waiting = False
                        return
                    if exclusive:
                        self._st(self._slot(rank), _LK_WAITW)
                        waiting = True
                if abort is not None:
                    abort()
                if time.monotonic() > deadline:
                    raise errors.InternalError(
                        f"rma region {self.path}: passive-target lock "
                        "wait timed out"
                    )
                try:
                    _futex_wait(self._mm, _RH_GEN, gen, 0.1)
                except ValueError:
                    raise RegionOwnerGone(
                        f"rma region {self.path} unmapped mid-wait"
                    )
        finally:
            if waiting:
                # gave up (timeout/abort): clear the waiting-writer
                # slot or shared acquirers defer to a ghost forever
                # (a region unmapped mid-cleanup has nothing to clear
                # and must not mask the original exception)
                try:
                    with self.atomic():
                        slot = self._slot(rank)
                        if self._ld(slot) == _LK_WAITW:
                            self._st(slot, _LK_NONE)
                            self._bump_gen_locked()
                    _futex_wake(self._mm, _RH_GEN, 64)
                except (RegionOwnerGone, ValueError):
                    pass

    def unlock(self, rank: int) -> int:
        """Release `rank`'s passive-target lock; returns the count of
        AM-origin lock waiters queued at the owner's service (caller
        pokes the owner when nonzero — a direct unlock sends no
        message the service could otherwise observe)."""
        with self.atomic():
            slot = self._slot(rank)
            state = self._ld(slot)
            if state == _LK_SHARED:
                readers = self._ld(_RH_READERS)
                self._st(_RH_READERS, max(0, readers - 1))
            elif state == _LK_EXCL:
                self._st(_RH_WRITER, 0)
            else:
                raise errors.WinError(
                    f"unlock: rank {rank} holds no lock on this region"
                )
            self._st(slot, _LK_NONE)
            self._bump_gen_locked()
            amq = self._ld(_RH_AMQ)
        _futex_wake(self._mm, _RH_GEN, 64)
        return amq

    def amq_adjust(self, delta: int) -> None:
        """Adjust the AM-waiter count; caller holds :meth:`atomic` (the
        owner's service queues/grants AM-origin lock requests)."""
        v = self._ld(_RH_AMQ)
        self._st(_RH_AMQ, max(0, v + delta))

    def holder_state(self, rank: int) -> int:
        return self._ld(self._slot(rank))

    def recover_dead(self, rank: int) -> bool:
        """Classification-time recovery of a died rank's lock state:
        force-release the region lock word if the corpse holds it,
        clear its passive-lock contribution (shared count / writer
        word / waiting-writer slot), and wake blocked waiters.
        Idempotent — every survivor may call it.  Returns True when
        anything was recovered."""
        recovered = False
        if self._closed:
            return False
        try:
            if self._use_native:
                while True:
                    old = self._word(_RH_MUTEX)
                    if (old & ~_MUTEX_WAIT) != rank + 1:
                        break
                    if self._amo32(_RH_MUTEX, _AMO_CAS, value=0,
                                   compare=old) == old:
                        recovered = True
                        _futex_wake(self._mm, _RH_MUTEX, 64)
                        break
        except (ValueError, AttributeError):
            return recovered  # closed under us: nothing left to repair
        # (flock fallback: the kernel released the corpse's flock with
        # its last fd — only the passive-lock words need repair)
        try:
            with self.atomic():
                slot = self._slot(rank)
                state = self._ld(slot)
                if state == _LK_SHARED:
                    readers = self._ld(_RH_READERS)
                    self._st(_RH_READERS, max(0, readers - 1))
                elif state == _LK_EXCL:
                    if self._ld(_RH_WRITER) == rank + 1:
                        self._st(_RH_WRITER, 0)
                if state != _LK_NONE:
                    self._st(slot, _LK_NONE)
                    self._bump_gen_locked()
                    recovered = True
        except (RegionOwnerGone, ValueError):
            return recovered
        if recovered:
            try:
                _futex_wake(self._mm, _RH_GEN, 64)
            except ValueError:
                pass
        return recovered

    # -- the PSCW region doorbell --------------------------------------
    # Post/complete as the epoch signal, carried by two header words
    # instead of AM messages: the exposing side bumps its region's
    # post word (waking origins parked on its futex), origins direct-
    # store the epoch payload and bump the complete word (waking the
    # parked target).  The sm doorbell idiom applied to active-target
    # synchronization — no message, no matching engine, no target-side
    # dispatch.  Counts wrap at 2^32; waits compare modulo.

    def _ring(self, off: int) -> int:
        with self.atomic():
            gen = (self._word(off) + 1) & 0xFFFFFFFF
            self._st(off, gen)
        _futex_wake(self._mm, off, 64)
        return gen

    def _await_ring(self, off: int, seen: int, timeout: float,
                    abort, what: str) -> int:
        deadline = time.monotonic() + timeout
        while True:
            cur = self._word(off)
            if (cur - seen) & 0xFFFFFFFF:
                return cur
            if abort is not None:
                abort()
            if time.monotonic() > deadline:
                raise errors.InternalError(
                    f"rma region {self.path}: {what} doorbell never "
                    f"rang within {timeout}s"
                )
            try:
                _futex_wait(self._mm, off, cur, 0.1)
            except ValueError:
                raise RegionOwnerGone(
                    f"rma region {self.path} unmapped mid-{what}-wait"
                )

    def post_epoch(self) -> int:
        """Ring the exposure doorbell (MPI_Win_post's signal leg);
        returns the new post generation."""
        return self._ring(_RH_POSTS)

    def await_post(self, seen: int, timeout: float = 10.0,
                   abort=None) -> int:
        """Park until the post doorbell advances past ``seen``
        (MPI_Win_start's wait leg); returns the observed generation —
        the caller's next ``seen``."""
        return self._await_ring(_RH_POSTS, seen, timeout, abort, "post")

    def complete_epoch(self) -> int:
        """Ring the completion doorbell (MPI_Win_complete's signal
        leg — direct stores are visible at issue, so the bump IS the
        whole completion)."""
        return self._ring(_RH_COMPLETES)

    def await_complete(self, seen: int, timeout: float = 10.0,
                       abort=None) -> int:
        """Park until the completion doorbell advances past ``seen``
        (MPI_Win_wait's wait leg)."""
        return self._await_ring(_RH_COMPLETES, seen, timeout, abort,
                                "complete")

    def doorbell_gens(self) -> tuple[int, int]:
        """Current (post, complete) generations — the persistent
        schedule snapshots these at construction so its first epoch
        never consumes a stale ring."""
        return self._word(_RH_POSTS), self._word(_RH_COMPLETES)

    # -- data access ---------------------------------------------------

    def view(self, dtype) -> np.ndarray:
        """Writable flat view of the data bytes as `dtype` (the
        window's element type — matches the AM plane's target-side
        ``st.buffer`` semantics)."""
        return self.data.view(dtype)

    def data_addr(self) -> int:
        """Base address of the data bytes (native lock-free AMOs)."""
        return self._arr.ctypes.data + self.data_off

    def close(self, unlink: bool = False) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._arr = None
        self.data = None
        self._w32.release()
        try:
            self._mm.close()
        except BufferError:  # user still holds a window view: the OS
            pass             # reclaims the mapping at process exit
        try:
            os.close(self._fd)
        except OSError:  # pragma: no cover
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            with _registry_lock:
                _created_paths.discard(self.path)


class RmaRegion(RmaMapping):
    """The owner's side of an RMA region: creates the backing file in
    the segment's namespace (``<segment>.w<idx>``), registered with
    the hygiene registry, unlinked at close (sever leaves it — the
    crash contract; the final harness close owns the sweep)."""

    def __init__(self, seg: "SmSegment", idx: int, nbytes: int):
        self.name = f"{seg.name}.w{idx}"
        super().__init__(
            os.path.join(segment_dir(), self.name), seg.rank,
            _create=(seg.size, int(nbytes), seg.rank),
        )
