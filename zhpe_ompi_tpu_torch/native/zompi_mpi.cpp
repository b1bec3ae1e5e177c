/* libzompi_mpi — the C ABI shim's engine (SURVEY.md §7's "C ABI
 * mpi.h-compatible shim" commitment; breadth per VERDICT round-3
 * Missing #1).
 *
 * Speaks the SAME wire protocol as the Python host plane
 * (zhpe_ompi_tpu_torch/pt2pt/tcp.py, and the JAX package's namesake):
 *   - modex: connect to the coordinator, send pack(rank, [host, port]),
 *     receive pack(address_book); rank 0 IS the coordinator (binds the
 *     agreed address, gathers, replies) — ompi_mpi_init.c:667-700's
 *     business-card exchange.
 *   - data frames: 4-byte LE length + DSS(src, tag, cid, seq, payload);
 *     payloads are DSS ndarrays (dtype tags '<i4','<i8','<f4','<f8','|u1')
 *     so the host plane's decoder round-trips them (as CPU tensors
 *     on a port rank).
 *   - hello frame on each new connection announces the peer rank.
 *   - barrier: dissemination rounds, tag 0x7FFD cid 0x7FFD, empty-bytes
 *     payload — bit-identical to TcpProc.barrier, so mixed C/Python jobs
 *     synchronize together.
 *
 * Protocol note: the shim speaks BOTH protocol legs.  Below
 * ZMPI_MCA_tcp_eager_limit (default 1 MB) user sends are eager; above it
 * they follow the same RTS/CTS rendezvous as the Python plane
 * (pml_ob1_sendreq.c:768's delivery guarantee at any size up to the
 * shared 4-byte frame bound of ~4 GiB, enforced with MPI_ERR_COUNT):
 * the sender
 * parks the payload, announces with a small RTS tuple, and pushes the
 * data frame over a dedicated bulk connection (hello ["d"]) once the
 * receiver's CTS arrives.  The receiving engine enters a PLACEHOLDER
 * into the matching stream at RTS position (non-overtaking) and sends
 * CTS only when a receive CLAIMS it — the Python plane's flow-control
 * contract (unmatched bulk parks at the SENDER).  Large MPI_Isend runs
 * its rendezvous on a background thread (crossed-Isend deadlock
 * freedom); collective-internal exchanges stay eager at any size, their
 * receives being posted by the same synchronized algorithm on all ranks.
 *
 * Matching: a posted-receive engine (the pml_ob1_recvfrag.c:295-513
 * contract): posted requests are matched in post order against arriving
 * fragments, the unexpected queue holds arrivals with no posted match,
 * and wildcards (ANY_SOURCE/ANY_TAG) resolve in arrival order.  Blocking
 * receive is Irecv+Wait over the same engine, so ordering between
 * blocking and nonblocking receives follows the MPI posting-order rule.
 *
 * Communicators: WORLD and SELF are predefined; Comm_split/dup derive
 * new contexts whose cid triples (pt2pt / collective / barrier context)
 * are computed deterministically from the parent's cid and a per-parent
 * creation sequence — every member runs the identical computation, so no
 * wire agreement round is needed (the ompi_comm_nextcid analog,
 * ompi/communicator/comm_cid.c, collapsed to a hash because disjoint
 * sibling groups can safely share a context id).
 *
 * Collectives: recursive-doubling allreduce with the non-power-of-two
 * fold (coll_base_allreduce.c:130-225 shape), binomial bcast
 * (coll_base_bcast.c:329), linear rooted reduce/gather/scatter
 * (coll/basic's linear algorithms, coll_base_gather.c:41 family), ring
 * allgather, and pairwise alltoall (coll_base_alltoall.c:132 shape) on a
 * reserved cid, element-typed kernels for the predefined ops including
 * the logical/bitwise set (op_base_functions.c analog).
 *
 * Derived datatypes: contiguous and vector typemaps with a resumable
 * pack/unpack into base-typed contiguous wire buffers — the convertor
 * shape (opal_convertor_pack, opal/datatype/opal_convertor.c:218-276)
 * reduced to the two constructors the C surface exposes.
 */

#include "zompi_mpi.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/file.h>
#include <netinet/in.h>
#include <sys/stat.h>
#include <sys/wait.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <deque>
#include <functional>
#include <list>
#include <map>
#include <memory>
#include <set>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <chrono>

namespace {

// ---------------------------------------------------------------- DSS
// Subset of zhpe_ompi_tpu_torch/utils/dss.py: varints, zigzag ints, str,
// bytes, list, ndarray.  Type tags must match dss.py exactly.
enum DssTag : uint8_t {
  T_NONE = 0, T_BOOL = 1, T_INT = 2, T_FLOAT = 3, T_STR = 4,
  T_BYTES = 5, T_LIST = 6, T_TUPLE = 7, T_DICT = 8, T_NDARRAY = 9,
  // out-of-band twins (dss.pack_frames): header carries the metadata
  // plus an 8-byte little-endian offset-from-frame-END; the raw
  // payload sits in the frame's trailing segment region.  The parser
  // normalizes them to T_NDARRAY/T_BYTES so downstream dispatch is
  // agnostic to which framing the (Python) sender chose.
  T_NDARRAY_OOB = 10, T_BYTES_OOB = 11,
};

void put_varint(std::string &out, uint64_t n) {
  while (true) {
    uint8_t b = n & 0x7F;
    n >>= 7;
    if (n) out.push_back((char)(b | 0x80));
    else { out.push_back((char)b); return; }
  }
}

bool get_varint(const uint8_t *buf, size_t len, size_t &pos, uint64_t &n) {
  n = 0;
  int shift = 0;
  while (pos < len) {
    uint8_t b = buf[pos++];
    n |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

void put_int(std::string &out, int64_t v) {
  out.push_back((char)T_INT);
  uint64_t z = v >= 0 ? ((uint64_t)v << 1) : ((uint64_t)(-v) << 1 | 1);
  put_varint(out, z);
}

void put_str(std::string &out, const std::string &s) {
  out.push_back((char)T_STR);
  put_varint(out, s.size());
  out += s;
}

void put_bytes(std::string &out, const void *p, size_t n) {
  out.push_back((char)T_BYTES);
  put_varint(out, n);
  out.append((const char *)p, n);
}

void put_float(std::string &out, double v) {
  // dss.py float: T_FLOAT + struct "<d" (little-endian hosts only,
  // same assumption the OOB offset codec already makes)
  out.push_back((char)T_FLOAT);
  char b[8];
  memcpy(b, &v, 8);
  out.append(b, 8);
}

void put_ndarray_1d(std::string &out, const char *dtstr, const void *data,
                    uint64_t count, uint64_t itemsize) {
  out.push_back((char)T_NDARRAY);
  size_t dl = strlen(dtstr);
  put_varint(out, dl);
  out.append(dtstr, dl);
  put_varint(out, 1);          // ndim
  put_varint(out, count);      // shape[0]
  put_varint(out, count * itemsize);
  out.append((const char *)data, count * itemsize);
}

// Parsed DSS value (only what the shim needs).
struct DssVal {
  uint8_t tag = T_NONE;
  int64_t i = 0;
  std::string s;            // str/bytes raw
  std::string dt;           // ndarray dtype
  std::vector<uint64_t> shape;
  std::string data;         // ndarray raw bytes
  std::vector<DssVal> items;  // list/tuple
};

bool parse_one(const uint8_t *buf, size_t len, size_t &pos, DssVal &v) {
  if (pos >= len) return false;
  v.tag = buf[pos++];
  uint64_t n;
  switch (v.tag) {
    case T_NONE: return true;
    case T_BOOL: v.i = buf[pos++]; return true;
    case T_INT: {
      if (!get_varint(buf, len, pos, n)) return false;
      v.i = (n & 1) ? -(int64_t)(n >> 1) : (int64_t)(n >> 1);
      return true;
    }
    case T_FLOAT: {
      if (pos + 8 > len) return false;
      double d;
      memcpy(&d, buf + pos, 8);
      pos += 8;
      v.i = (int64_t)d;
      return true;
    }
    case T_STR:
    case T_BYTES: {
      if (!get_varint(buf, len, pos, n) || pos + n > len) return false;
      v.s.assign((const char *)buf + pos, n);
      pos += n;
      return true;
    }
    case T_BYTES_OOB: {
      if (!get_varint(buf, len, pos, n)) return false;
      if (pos + 8 > len) return false;
      uint64_t ofe;
      memcpy(&ofe, buf + pos, 8);
      pos += 8;
      if (ofe > len || n > ofe) return false;
      v.s.assign((const char *)buf + (len - ofe), n);
      v.tag = T_BYTES;
      return true;
    }
    case T_NDARRAY:
    case T_NDARRAY_OOB: {
      if (!get_varint(buf, len, pos, n) || pos + n > len) return false;
      v.dt.assign((const char *)buf + pos, n);
      pos += n;
      uint64_t ndim;
      if (!get_varint(buf, len, pos, ndim)) return false;
      for (uint64_t k = 0; k < ndim; k++) {
        uint64_t d;
        if (!get_varint(buf, len, pos, d)) return false;
        v.shape.push_back(d);
      }
      if (!get_varint(buf, len, pos, n)) return false;
      if (v.tag == T_NDARRAY_OOB) {
        if (pos + 8 > len) return false;
        uint64_t ofe;
        memcpy(&ofe, buf + pos, 8);  // little-endian hosts only (x86/arm)
        pos += 8;
        if (ofe > len || n > ofe) return false;
        v.data.assign((const char *)buf + (len - ofe), n);
        v.tag = T_NDARRAY;
        return true;
      }
      if (pos + n > len) return false;
      v.data.assign((const char *)buf + pos, n);
      pos += n;
      return true;
    }
    case T_LIST:
    case T_TUPLE: {
      if (!get_varint(buf, len, pos, n)) return false;
      v.items.resize(n);
      for (uint64_t k = 0; k < n; k++)
        if (!parse_one(buf, len, pos, v.items[k])) return false;
      return true;
    }
    default:
      return false;  // dict etc: not needed by the shim
  }
}

bool parse_all(const std::string &frame, std::vector<DssVal> &out) {
  const uint8_t *buf = (const uint8_t *)frame.data();
  size_t len = frame.size(), pos = 0;
  uint64_t count;
  if (!get_varint(buf, len, pos, count)) return false;
  out.resize(count);
  for (uint64_t k = 0; k < count; k++)
    if (!parse_one(buf, len, pos, out[k])) return false;
  return true;
}

// ------------------------------------------------------------- sockets

bool send_all(int fd, const void *p, size_t n) {
  const char *c = (const char *)p;
  while (n) {
    ssize_t w = ::send(fd, c, n, 0);
    if (w <= 0) return false;
    c += w;
    n -= (size_t)w;
  }
  return true;
}

bool recv_all(int fd, void *p, size_t n) {
  char *c = (char *)p;
  while (n) {
    ssize_t r = ::recv(fd, c, n, 0);
    if (r <= 0) return false;
    c += r;
    n -= (size_t)r;
  }
  return true;
}

bool send_frame(int fd, const std::string &payload) {
  // the wire protocol is 4-byte length-framed (matching the Python
  // plane's struct "<I"); a frame at or past 4 GiB cannot be framed —
  // fail loudly instead of wrapping the length and shearing the stream
  if (payload.size() > 0xFFFFFFFFull) return false;
  uint32_t len = (uint32_t)payload.size();
  uint8_t hdr[4] = {(uint8_t)(len), (uint8_t)(len >> 8),
                    (uint8_t)(len >> 16), (uint8_t)(len >> 24)};
  return send_all(fd, hdr, 4) && send_all(fd, payload.data(), len);
}

bool recv_frame(int fd, std::string &out) {
  uint8_t hdr[4];
  if (!recv_all(fd, hdr, 4)) return false;
  uint32_t len = hdr[0] | hdr[1] << 8 | hdr[2] << 16 | hdr[3] << 24;
  out.resize(len);
  return len == 0 || recv_all(fd, &out[0], len);
}

// children must not inherit the engine's sockets across execve: an
// exec'd child holding duplicates of our connections converts peer
// death into a silent hang for everyone blocked on those sockets
void set_cloexec(int fd) { fcntl(fd, F_SETFD, FD_CLOEXEC); }

int tcp_connect(const std::string &host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  set_cloexec(fd);
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, host.c_str(), &a.sin_addr);
  for (int tries = 0; tries < 200; tries++) {
    if (connect(fd, (sockaddr *)&a, sizeof a) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      return fd;
    }
    usleep(50 * 1000);
    close(fd);
    fd = socket(AF_INET, SOCK_STREAM, 0);
  }
  close(fd);
  return -1;
}

// ------------------------------------------------------------ datatypes

struct DtInfo { const char *tag; size_t item; };

bool base_dtinfo(MPI_Datatype dt, DtInfo &out) {
  switch (dt) {
    case MPI_BYTE:           out = {"|u1", 1}; return true;
    case MPI_INT:            out = {"<i4", 4}; return true;
    case MPI_LONG:           out = {"<i8", 8}; return true;
    case MPI_FLOAT:          out = {"<f4", 4}; return true;
    case MPI_DOUBLE:         out = {"<f8", 8}; return true;
    case MPI_CHAR:           out = {"<i1", 1}; return true;
    case MPI_SIGNED_CHAR:    out = {"<i1", 1}; return true;
    case MPI_SHORT:          out = {"<i2", 2}; return true;
    case MPI_LONG_LONG:      out = {"<i8", 8}; return true;
    case MPI_UNSIGNED_CHAR:  out = {"<u1", 1}; return true;
    case MPI_UNSIGNED_SHORT: out = {"<u2", 2}; return true;
    case MPI_UNSIGNED:       out = {"<u4", 4}; return true;
    case MPI_UNSIGNED_LONG:  out = {"<u8", 8}; return true;
    // MINLOC/MAXLOC pair types: opaque fixed-size records on the wire
    // (C struct layouts, padding included — op.h's ompi_op pair reds)
    case MPI_2INT:           out = {"|V8", 8}; return true;
    case MPI_FLOAT_INT:      out = {"|V8", 8}; return true;
    case MPI_DOUBLE_INT:     out = {"|V16", 16}; return true;
    case MPI_LONG_INT:       out = {"|V16", 16}; return true;
    case MPI_SHORT_INT:      out = {"|V8", 8}; return true;
  }
  return false;
}

bool is_pair_dtype(MPI_Datatype dt) {
  return dt >= MPI_2INT && dt <= MPI_SHORT_INT;
}

// the TYPEMAP size of a pair record (value + int, padding excluded);
// 0 for non-pair types
int pair_typemap_size(MPI_Datatype dt) {
  switch (dt) {
    case MPI_2INT:       return 8;
    case MPI_FLOAT_INT:  return 8;
    case MPI_DOUBLE_INT: return 12;
    case MPI_LONG_INT:   return 12;
    case MPI_SHORT_INT:  return 6;
  }
  return 0;
}

// the op/dtype pairing must fail at the ORIGIN of every accumulate-
// family call: the remote apply is fire-and-forget, so a target-side
// reduce_buf error would otherwise vanish (pair types take only
// MINLOC/MAXLOC/REPLACE/NO_OP; loc ops REQUIRE a pair type)
int check_acc_op_pairing(MPI_Datatype base, MPI_Op op) {
  bool pair = is_pair_dtype(base);
  bool loc_op = op == MPI_MINLOC || op == MPI_MAXLOC;
  if (pair && !loc_op && op != MPI_REPLACE && op != MPI_NO_OP)
    return MPI_ERR_OP;
  if (!pair && loc_op) return MPI_ERR_OP;
  return MPI_SUCCESS;
}

// Derived typemap: blocks of base elements within one extent, the
// convertor's description (opal_datatype_optimize.c) reduced to the
// contiguous/vector constructors.
struct DtypeObj {
  MPI_Datatype base = MPI_BYTE;
  std::vector<std::pair<int64_t, int64_t>> blocks;  // (offset, n) in elems
  int64_t extent = 0;   // ub - lb, in base elems (the item stride)
  int64_t lb = 0;       // lower bound (min displacement), in base elems
  int64_t elems = 0;    // base elems per one item (sum of block n)
  bool committed = false;
  // canonical-packing element unit for byte-sealed typemaps: the
  // packed stream of a single-oldtype byte constructor is whole base
  // elements of that oldtype (external32 swaps at this unit); 0 means
  // heterogeneous (struct) — canonical packing is then unsupported
  int swap_unit = 1;
  // constructor envelope (type_get_envelope.c / type_get_contents.c)
  int combiner = 0;  // MPI_COMBINER_NAMED until a constructor stamps it
  std::vector<int> env_ints;
  std::vector<long long> env_aints;
  std::vector<int> env_types;
};

constexpr MPI_Datatype DERIVED_BASE = 0x40;
std::map<MPI_Datatype, DtypeObj> g_dtypes;
MPI_Datatype g_next_dtype = DERIVED_BASE;

// canonical packed element unit of a type's packed stream: predefined
// and element-sealed derived = base item size; byte-sealed derived =
// the unit recorded at construction (0 = heterogeneous struct)
int packed_unit_of(const DtypeObj *derived, MPI_Datatype dt,
                   size_t item) {
  MPI_Datatype base = derived ? derived->base : dt;
  if (is_pair_dtype(base)) return 0;  // heterogeneous record: no unit
  if (derived && base == 0 /* MPI_BYTE */) return derived->swap_unit;
  return (int)item;
}

// A resolved view: base info + typemap (identity map for predefined).
struct DtView {
  DtInfo di;
  const DtypeObj *derived = nullptr;  // null => predefined (contiguous)
  int64_t elems_per_item() const { return derived ? derived->elems : 1; }
  bool contiguous() const {
    if (!derived) return true;
    return derived->blocks.size() == 1 && derived->blocks[0].first == 0 &&
           derived->extent == derived->elems;
  }
};

// merge adjacent typemap blocks (opal_datatype_optimize.c's job)
void coalesce_blocks(std::vector<std::pair<int64_t, int64_t>> &blocks) {
  std::vector<std::pair<int64_t, int64_t>> merged;
  for (auto &b : blocks) {
    if (!merged.empty() &&
        merged.back().first + merged.back().second == b.first)
      merged.back().second += b.second;
    else
      merged.push_back(b);
  }
  blocks = std::move(merged);
}

// memory footprint of `count` items laid out per MPI extent rules —
// block r of a gather-family buffer starts at r * slot_bytes
size_t slot_bytes(const DtView &v, int count) {
  int64_t ext = v.derived ? v.derived->extent : 1;
  return (size_t)count * (size_t)ext * v.di.item;
}

bool resolve_dtype(MPI_Datatype dt, DtView &v) {
  if (dt < DERIVED_BASE) return base_dtinfo(dt, v.di);
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end() || !it->second.committed) return false;
  v.derived = &it->second;
  return base_dtinfo(it->second.base, v.di);
}

// pack `count` items described by `v` from user memory into a
// contiguous base-element buffer (the convertor's pack direction)
void pack_dtype(const void *user, int count, const DtView &v,
                std::vector<char> &out) {
  size_t item = v.di.item;
  out.resize((size_t)count * v.elems_per_item() * item);
  if (v.contiguous()) {
    memcpy(out.data(), user, out.size());
    return;
  }
  const char *src = (const char *)user;
  char *dst = out.data();
  for (int c = 0; c < count; c++) {
    const char *base = src + (size_t)c * v.derived->extent * item;
    for (auto &b : v.derived->blocks) {
      memcpy(dst, base + (size_t)b.first * item, (size_t)b.second * item);
      dst += (size_t)b.second * item;
    }
  }
}

// unpack up to `avail_bytes` of contiguous base elements into user
// memory laid out per `v` (the convertor's unpack direction)
void unpack_dtype(void *user, int count, const DtView &v,
                  const char *wire, size_t avail_bytes) {
  size_t item = v.di.item;
  if (v.contiguous()) {
    size_t want = (size_t)count * v.elems_per_item() * item;
    memcpy(user, wire, avail_bytes < want ? avail_bytes : want);
    return;
  }
  char *dst = (char *)user;
  size_t taken = 0;
  for (int c = 0; c < count; c++) {
    char *base = dst + (size_t)c * v.derived->extent * item;
    for (auto &b : v.derived->blocks) {
      size_t n = (size_t)b.second * item;
      if (taken >= avail_bytes) return;
      if (taken + n > avail_bytes) n = avail_bytes - taken;
      memcpy(base + (size_t)b.first * item, wire + taken, n);
      taken += n;
    }
  }
}

// ------------------------------------------------------ matching engine

struct Message {
  int64_t src, tag, cid, seq;
  std::string dt;     // ndarray dtype or "" for bytes payload
  std::string data;   // raw payload bytes
  // rendezvous placeholder: entered into the matching stream at RTS
  // arrival (so a later eager frame can never overtake the announced
  // message — MPI non-overtaking); the bulk data fills it in place
  bool rndv_pending = false;
  int64_t rndv_id = 0;
  int64_t rndv_nbytes = 0;  // announced size, for Probe's count
  // matched-probe extraction (mprobe.c): a nonzero handle means an
  // Improbe owns this message — ordinary matching and probing skip it
  int64_t mhandle = 0;
};

// A receive request registered with the engine.  Blocking receives are
// Irecv+Wait over the same posted list, preserving MPI posting order.
struct Req {
  bool complete = false;
  bool is_recv = false;
  bool heap = false;               // user-facing (Isend/Irecv) vs stack
  int comm = MPI_COMM_WORLD;       // for MPI_SOURCE translation
  void *user_buf = nullptr;
  int count = 0;
  std::vector<char> scratch;       // landing zone for derived-type recvs
  bool needs_unpack = false;
  // Unpack plan captured AT POST TIME: MPI allows MPI_Type_free while a
  // receive is pending, so completion must not consult the dtype table.
  DtInfo plan_di{"|u1", 1};
  DtypeObj plan;
  MPI_Status status{};
};

struct Posted {
  Req *req;
  int64_t cid;
  int src_world;   // -1 = ANY
  int64_t tag;     // -1 = ANY
  char *land;      // where arriving bytes go (user buf or scratch)
  size_t want_bytes;
  size_t item;     // base element size (status._count unit)
};

// Imrecv claims parked on a rendezvous-pending extracted message:
// mhandle -> landing plan (guarded by match_mu)
std::map<int64_t, Posted> g_mrecv_wait;

struct Shim {
  int rank = -1, size = 0;
  int listen_fd = -1;
  static constexpr size_t BOOK_CAP = 4096;  // universe bound (see init)
  std::string host = "127.0.0.1";
  int listen_port = 0;
  std::vector<std::pair<std::string, int>> book;
  // modex capability strings, aligned with book ("" = none; "sm" =
  // the rank maps same-host shared-memory rings)
  std::vector<std::string> caps;
  std::map<int, int> conns;  // peer rank -> fd
  std::mutex conn_mu;
  std::mutex send_mu;
  std::deque<Message> unexpected;
  std::list<Posted> posted;
  std::map<int, Req *> reqs;
  int next_req = 1;
  std::mutex match_mu;
  std::condition_variable match_cv;
  std::atomic<bool> closing{false};
  std::thread accept_thread;            // joined FIRST at finalize
  std::vector<std::thread> threads;     // drain threads (joinable)
  std::vector<int> drain_fds;           // every fd a drain thread reads
  std::vector<int> bulk_fds;            // RECV side: peers' bulk-data fds
  std::atomic<int> bulk_closing{0};     // self-closes still in flight
  std::map<int, int> bulk_conns;        // SEND side: peer -> cached fd
  // bulk_mu guards the MAPS only; each peer's pushes serialize on its
  // own mutex so concurrent transfers to different peers stream in
  // parallel (the per-transfer-socket property the cache must keep)
  std::map<int, std::unique_ptr<std::mutex>> bulk_peer_mu;
  std::mutex bulk_mu;
  std::mutex threads_mu;
  // atomic: drain threads stamp CTS frames concurrently with app sends
  std::atomic<int64_t> seq{0};
  bool initialized = false;
  // rendezvous: sender-side id counter; receiver-side map of announced
  // transfers (src, rndv_id) -> original (tag, cid, seq) envelope, and
  // receives already matched to a placeholder awaiting bulk data
  // (rndv_wait is guarded by match_mu — it is part of matching state)
  // atomic: MPI_T_cvar_write mutates it at runtime while rendezvous
  // pushers and icoll threads read it concurrently
  std::atomic<int64_t> eager_limit{1 << 20};
  // atomic for the same reason: the rndv_cts_timeout cvar is writable
  // at runtime while rendezvous waiters read it from their threads
  std::atomic<double> cts_timeout{-1.0};  // <0: wait forever
  // SPC-style engine counters, surfaced as MPI_T pvars
  std::atomic<long long> ctr_eager_sends{0};
  std::atomic<long long> ctr_rndv_sends{0};
  std::atomic<long long> ctr_bytes_sent{0};
  std::atomic<int> inflight_isends{0};
  std::atomic<int64_t> next_rndv{1};
  std::map<std::pair<int64_t, int64_t>, std::array<int64_t, 3>> rndv_in;
  std::mutex rndv_mu;
  std::map<std::pair<int64_t, int64_t>, Posted> rndv_wait;

  ~Shim() {
    // error-path exit without MPI_Finalize: joinable std::threads would
    // std::terminate in their destructors — detach them (the process is
    // dying anyway; Finalize remains the clean path)
    if (accept_thread.joinable()) accept_thread.detach();
    for (auto &t : threads)
      if (t.joinable()) t.detach();
  }
};

// Intentionally leaked: detached bulk/rendezvous threads may still be
// unwinding when main() returns, and a static Shim destructor running
// under them (mutexes included) would be UB at process exit.  Finalize
// does the real cleanup; the one Shim's memory dies with the process.
Shim &g = *new Shim;

// ------------------------- same-host shared-memory transport --------
// The btl/sm role for the C plane (opal/mca/btl/sm's fast-box/FIFO,
// re-designed as one SPSC byte-stream ring per DIRECTED same-host
// pair).  The ENTIRE main channel of an sm-activated direction rides
// the ring — eager data, RTS, CTS, window tuples, barrier signals —
// so per-pair FIFO holds with no cross-transport reordering (the
// reference needs PML sequence numbers for exactly this; one
// transport per direction needs none).  Rendezvous BULK data keeps
// its dedicated TCP connections: a separate channel whose arrival
// order the placeholder design already decouples.
//
// Activation: both ranks advertise "sm" in their modex card, share a
// host string, and belong to the same init cohort (the contiguous
// WORLD block that initialized together — spawn joins stay TCP).
// Each rank creates its outbound rings, then waits briefly for the
// matching inbound files; a mapped inbound ring proves the shared
// /dev/shm namespace, which gates the OUTBOUND activation.  Inbound
// rings that appear late are still polled (pending list), so an
// asymmetric activation can never lose frames.

struct SmRingHdr {
  std::atomic<uint64_t> magic;
  char pad0[56];
  std::atomic<uint64_t> head;  // bytes produced (monotonic)
  char pad1[56];
  std::atomic<uint64_t> tail;  // bytes consumed (monotonic)
  char pad2[56];
};
constexpr uint64_t SM_MAGIC = 0x5A4F4D5049534D31ULL;  // "ZOMPISM1"
constexpr size_t SM_RING_BYTES = (size_t)4 << 20;     // stream capacity

struct SmRing {
  SmRingHdr *hdr = nullptr;
  char *data = nullptr;
  std::string path;
  bool creator = false;
  std::mutex wmu;     // outbound: serialize concurrent senders
  std::string rbuf;   // inbound: frame assembly across poll cycles
  int src = -1;       // inbound: the writing peer (diagnostics)
  // outbound overflow queue: the POLL thread must never block on a
  // full ring (it is the consumer that frees every OTHER ring — a
  // blocked poll thread deadlocks crossed large replies), so its
  // writes spill here and the poll loop itself drains the spill as
  // space appears.  Order: once non-empty, EVERY later frame to this
  // ring appends behind it (guarded by wmu).
  std::string pending;
};

// set inside sm_poll_loop: sends from the dispatch path must not block
thread_local bool tl_sm_poll_thread = false;

void sm_release(SmRing &r) {
  if (r.hdr) {
    munmap((void *)r.hdr, sizeof(SmRingHdr) + SM_RING_BYTES);
    r.hdr = nullptr;
  }
  if (r.creator && !r.path.empty()) shm_unlink(r.path.c_str());
}

std::map<int, std::unique_ptr<SmRing>> g_sm_out;   // dest -> ring
std::vector<std::unique_ptr<SmRing>> g_sm_in;
std::vector<std::pair<int, std::string>> g_sm_pending;  // late inbound
std::mutex g_sm_pending_mu;
std::thread g_sm_poll;
std::atomic<bool> g_sm_poll_up{false};

void dispatch_frame(const std::string &frame);  // defined with drains

bool sm_map(const std::string &path, bool create, SmRing &out) {
  int fd;
  size_t len = sizeof(SmRingHdr) + SM_RING_BYTES;
  if (create) {
    shm_unlink(path.c_str());  // stale ring from a crashed job
    fd = shm_open(path.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0 || ftruncate(fd, (off_t)len) != 0) {
      if (fd >= 0) close(fd);
      return false;
    }
  } else {
    fd = shm_open(path.c_str(), O_RDWR, 0600);
    if (fd < 0) return false;
    struct stat st{};
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)len) {
      close(fd);  // peer still truncating: caller retries
      return false;
    }
  }
  char *m = (char *)mmap(nullptr, len, PROT_READ | PROT_WRITE,
                         MAP_SHARED, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return false;
  out.hdr = (SmRingHdr *)m;
  out.data = m + sizeof(SmRingHdr);
  out.path = path;
  out.creator = create;
  if (create) {
    out.hdr->head.store(0, std::memory_order_relaxed);
    out.hdr->tail.store(0, std::memory_order_relaxed);
    out.hdr->magic.store(SM_MAGIC, std::memory_order_release);
  } else if (out.hdr->magic.load(std::memory_order_acquire) !=
             SM_MAGIC) {
    munmap(m, len);
    out.hdr = nullptr;
    return false;  // creator has not finished stamping
  }
  return true;
}

// the selection policy (shared by the modex card and sm_setup): rings
// on multi-core hosts, TCP on single-core, ZMPI_MCA_sm forces either
bool sm_enabled() {
  const char *force = getenv("ZMPI_MCA_sm");
  if (force && force[0]) return force[0] == '1';
  return sysconf(_SC_NPROCESSORS_ONLN) > 1;
}

// segment-name session tag: the launcher's ZMPI_SESSION when present
// (inherited by spawn children, whose coordinator port differs —
// keeps the whole job tree under ONE sweepable prefix), else the
// coordinator port (direct launches)
const char *session_tag() {
  const char *t = getenv("ZMPI_SESSION");
  if (t && t[0]) return t;
  t = getenv("ZMPI_COORD_PORT");
  return t && t[0] ? t : "0";
}

std::string sm_ring_path(int src, int dst) {
  char buf[96];
  snprintf(buf, sizeof buf, "/zompi_ring_%s_%d_%d", session_tag(), src,
           dst);
  return buf;
}

// stream `n` bytes into the ring, wrapping and waiting on the
// consumer; frames larger than the ring flow through in pieces (the
// reader frees space as it assembles)
int sm_write_bytes(SmRing *r, const char *p, size_t n) {
  size_t done = 0;
  int spins = 0;
  while (done < n) {
    uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    size_t free_ = SM_RING_BYTES - (size_t)(head - tail);
    if (free_ == 0) {
      if (g.closing.load()) return MPI_ERR_OTHER;
      if (++spins > 2000)
        std::this_thread::sleep_for(std::chrono::microseconds(50));
      continue;
    }
    spins = 0;
    size_t chunk = n - done < free_ ? n - done : free_;
    size_t off = (size_t)(head % SM_RING_BYTES);
    size_t first = chunk < SM_RING_BYTES - off ? chunk
                                               : SM_RING_BYTES - off;
    memcpy(r->data + off, p + done, first);
    memcpy(r->data, p + done + first, chunk - first);
    r->hdr->head.store(head + chunk, std::memory_order_release);
    done += chunk;
  }
  return MPI_SUCCESS;
}

// write whatever fits RIGHT NOW; returns bytes written (never waits)
size_t sm_write_avail(SmRing *r, const char *p, size_t n) {
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  size_t free_ = SM_RING_BYTES - (size_t)(head - tail);
  size_t chunk = n < free_ ? n : free_;
  if (chunk == 0) return 0;
  size_t off = (size_t)(head % SM_RING_BYTES);
  size_t first = chunk < SM_RING_BYTES - off ? chunk
                                             : SM_RING_BYTES - off;
  memcpy(r->data + off, p, first);
  memcpy(r->data, p + first, chunk - first);
  r->hdr->head.store(head + chunk, std::memory_order_release);
  return chunk;
}

// wmu must be held; pushes as much spilled data as fits
void sm_flush_pending_locked(SmRing *r) {
  if (r->pending.empty()) return;
  size_t put = sm_write_avail(r, r->pending.data(), r->pending.size());
  if (put) r->pending.erase(0, put);
}

int sm_send_frame(SmRing *r, const std::string &payload) {
  // same 4-byte little-endian length prefix as the TCP framing
  uint32_t len = (uint32_t)payload.size();
  char hdr[4] = {(char)(len & 0xFF), (char)((len >> 8) & 0xFF),
                 (char)((len >> 16) & 0xFF), (char)((len >> 24) & 0xFF)};
  std::lock_guard<std::mutex> lk(r->wmu);
  sm_flush_pending_locked(r);
  if (tl_sm_poll_thread) {
    // the poll thread NEVER blocks here (deadlock analysis above):
    // whatever does not fit spills behind any existing backlog
    if (r->pending.empty()) {
      size_t put = sm_write_avail(r, hdr, 4);
      if (put == 4) {
        size_t put2 =
            sm_write_avail(r, payload.data(), payload.size());
        if (put2 < payload.size())
          r->pending.append(payload, put2, std::string::npos);
        return MPI_SUCCESS;
      }
      r->pending.append(hdr + put, 4 - put);
      r->pending += payload;
      return MPI_SUCCESS;
    }
    r->pending.append(hdr, 4);
    r->pending += payload;
    return MPI_SUCCESS;
  }
  // app threads drain the spill first (order), then block as needed
  while (!r->pending.empty()) {
    sm_flush_pending_locked(r);
    if (r->pending.empty()) break;
    if (g.closing.load()) return MPI_ERR_OTHER;
    std::this_thread::sleep_for(std::chrono::microseconds(20));
  }
  int rc = sm_write_bytes(r, hdr, 4);
  if (rc != MPI_SUCCESS) return rc;
  return sm_write_bytes(r, payload.data(), payload.size());
}

// drain whatever the producer published; dispatch completed frames
bool sm_poll_ring(SmRing *r) {
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (head == tail) return false;
  size_t n = (size_t)(head - tail);
  size_t off = (size_t)(tail % SM_RING_BYTES);
  size_t first = n < SM_RING_BYTES - off ? n : SM_RING_BYTES - off;
  r->rbuf.append(r->data + off, first);
  r->rbuf.append(r->data, n - first);
  r->hdr->tail.store(head, std::memory_order_release);
  size_t pos = 0;
  while (r->rbuf.size() - pos >= 4) {
    const unsigned char *b = (const unsigned char *)r->rbuf.data() + pos;
    uint32_t len = (uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                   ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
    if (r->rbuf.size() - pos - 4 < len) break;
    dispatch_frame(r->rbuf.substr(pos + 4, len));
    pos += 4 + (size_t)len;
  }
  r->rbuf.erase(0, pos);
  return true;
}

void sm_poll_loop() {
  tl_sm_poll_thread = true;
  auto last_active = std::chrono::steady_clock::now();
  auto last_pending = last_active;
  while (!g.closing.load()) {
    bool any = false;
    for (auto &r : g_sm_in) any |= sm_poll_ring(r.get());
    // drain outbound spills (frames the dispatch path could not fit)
    for (auto &e : g_sm_out) {
      SmRing *r = e.second.get();
      if (r->pending.empty()) continue;
      std::lock_guard<std::mutex> lk(r->wmu);
      sm_flush_pending_locked(r);
      any = true;
    }
    auto now = std::chrono::steady_clock::now();
    // late inbound rings (peer activated after our init window)
    if (now - last_pending > std::chrono::milliseconds(100)) {
      last_pending = now;
      std::lock_guard<std::mutex> lk(g_sm_pending_mu);
      for (auto it = g_sm_pending.begin(); it != g_sm_pending.end();) {
        auto r = std::make_unique<SmRing>();
        if (sm_map(it->second, false, *r)) {
          r->src = it->first;
          g_sm_in.push_back(std::move(r));
          it = g_sm_pending.erase(it);
        } else {
          ++it;
        }
      }
    }
    if (any) {
      last_active = now;
      continue;
    }
    // stay HOT for a generous window after traffic: a ping-pong's
    // inter-arrival gap is a full RTT, and dozing inside it puts the
    // sleep latency ON the critical path of every message (measured:
    // a 200us window turned 2us rings into 208us).  Escalate only
    // through genuinely idle phases.
    auto idle = now - last_active;
    if (idle < std::chrono::milliseconds(20)) {
      // hot, but YIELD: a hard spin on a shared host steals the app
      // thread's core and puts a scheduler quantum (~ms) on every
      // message (measured both ways: hard spin 3.6ms, 100us dozes
      // 208us; yield keeps the poll sub-10us hot without starving)
      sched_yield();
      continue;
    }
    if (idle < std::chrono::milliseconds(200))
      std::this_thread::sleep_for(std::chrono::microseconds(20));
    else
      std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

// init-time cohort wiring; returns only after outbound rings exist and
// inbound rings were awaited (missing ones go to the pending list)
void sm_setup(int cohort_base, int cohort_size) {
  // hardware-aware default (the component-selection policy the
  // reference's MCA priorities exist for): the ring's polling thread
  // pays a scheduler quantum per handoff when there is only ONE core
  // (measured on this host: small messages 2x faster, 256 KB 5x
  // slower), so single-core hosts keep the kernel-blocking TCP path.
  // ZMPI_MCA_sm=1 forces the rings on, =0 forces them off; both
  // sides decide independently and asymmetric choices degrade safely
  // to TCP (activation requires the peer's mapped ring).
  if (!sm_enabled()) return;
  double wait_s = 5.0;
  if (const char *w = getenv("ZMPI_MCA_sm_wait"))
    if (w[0]) wait_s = atof(w);
  std::vector<int> peers;
  for (int j = cohort_base; j < cohort_base + cohort_size; j++) {
    if (j == g.rank || j >= (int)g.book.size()) continue;
    if (j >= (int)g.caps.size() ||
        g.caps[(size_t)j].find("sm") == std::string::npos)
      continue;
    if (g.book[(size_t)j].first != g.host) continue;  // other host
    auto r = std::make_unique<SmRing>();
    if (sm_map(sm_ring_path(g.rank, j), true, *r))
      g_sm_out[j] = std::move(r);  // activated after namespace proof
    peers.push_back(j);
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(wait_s);
  for (int j : peers) {
    bool mapped = false;
    while (std::chrono::steady_clock::now() < deadline) {
      auto r = std::make_unique<SmRing>();
      if (sm_map(sm_ring_path(j, g.rank), false, *r)) {
        r->src = j;
        g_sm_in.push_back(std::move(r));
        mapped = true;
        break;
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
    if (!mapped) {
      // shared namespace unproven: never WRITE to this peer via sm,
      // but keep looking for its ring so its frames are never lost
      auto oit = g_sm_out.find(j);
      if (oit != g_sm_out.end()) {
        sm_release(*oit->second);  // unmap AND unlink the orphan file
        g_sm_out.erase(oit);
      }
      std::lock_guard<std::mutex> lk(g_sm_pending_mu);
      g_sm_pending.push_back({j, sm_ring_path(j, g.rank)});
    }
  }
  if (!g_sm_out.empty() || !g_sm_in.empty() || !g_sm_pending.empty()) {
    g_sm_poll = std::thread(sm_poll_loop);
    g_sm_poll_up.store(true);
  }
}

void sm_teardown() {
  if (g_sm_poll_up.load()) {
    if (g_sm_poll.joinable()) g_sm_poll.join();  // closing already set
    g_sm_poll_up.store(false);
  }
  for (auto &e : g_sm_out) sm_release(*e.second);
  g_sm_out.clear();
  for (auto &r : g_sm_in) sm_release(*r);
  g_sm_in.clear();
  {
    std::lock_guard<std::mutex> lk(g_sm_pending_mu);
    g_sm_pending.clear();
  }
}

SmRing *sm_ring_to(int dest) {
  auto it = g_sm_out.find(dest);
  return it == g_sm_out.end() ? nullptr : it->second.get();
}

// fill a posted request from an arriving/unexpected message.
// match_mu must be held.
void deliver(const Posted &p, const Message &m) {
  size_t have = m.data.size();
  size_t copied = have > p.want_bytes ? p.want_bytes : have;
  memcpy(p.land, m.data.data(), copied);
  Req *r = p.req;
  r->status.MPI_SOURCE = (int)m.src;  // world rank; translated at Wait
  r->status.MPI_TAG = (int)m.tag;
  r->status.MPI_ERROR =
      have > p.want_bytes ? MPI_ERR_TRUNCATE : MPI_SUCCESS;
  // _count carries BYTES (dtype-agnostic, so MPI_Probe can fill it
  // without knowing the eventual receive type); Get_count converts
  r->status._count = (long long)copied;
  r->complete = true;
}

void send_cts(int64_t sender, int64_t rndv_id);

// Arrival path (drain threads + self-sends): posted list first, in post
// order; otherwise the unexpected queue (pml_ob1_recvfrag.c:342 shape).
// A rendezvous placeholder that matches a posted receive PARKS it in
// rndv_wait instead of completing — the bulk data finishes it later,
// but the match decision is made NOW, at announce position, so later
// eager frames cannot overtake (MPI non-overtaking).  The claim is what
// releases the sender (CTS), sent after match_mu drops.
void push_message(Message &&m) {
  int64_t cts_src = -1, cts_rid = -1;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (auto it = g.posted.begin(); it != g.posted.end(); ++it) {
      if (it->cid != m.cid) continue;
      if (it->src_world != MPI_ANY_SOURCE && it->src_world != m.src)
        continue;
      if (it->tag != MPI_ANY_TAG && it->tag != m.tag) continue;
      if (m.rndv_pending) {
        g.rndv_wait[{m.src, m.rndv_id}] = *it;
        g.posted.erase(it);
        cts_src = m.src;
        cts_rid = m.rndv_id;
        break;
      }
      deliver(*it, m);
      g.posted.erase(it);
      g.match_cv.notify_all();
      return;
    }
    if (cts_src < 0) g.unexpected.push_back(std::move(m));
  }
  if (cts_src >= 0) send_cts(cts_src, cts_rid);
  g.match_cv.notify_all();
}

// Post a receive: unexpected queue first (arrival order), else posted.
// Returns the request handle.
// capture the landing plan for a receive into `r`: contiguous types
// land in the user buffer, derived types in scratch with the typemap
// snapshotted (survives MPI_Type_free).  Shared by post_recv and the
// matched-probe receive so the two paths can never diverge.
char *prepare_landing(Req *r, const DtView &v, size_t &want_bytes) {
  want_bytes = (size_t)r->count * v.elems_per_item() * v.di.item;
  r->plan_di = v.di;
  if (v.contiguous()) return (char *)r->user_buf;
  r->scratch.resize(want_bytes);
  r->needs_unpack = true;
  r->plan = *v.derived;
  return r->scratch.data();
}

int post_recv(Req *r, const DtView &v, int64_t cid, int src_world,
              int64_t tag) {
  size_t base_bytes;
  char *land = prepare_landing(r, v, base_bytes);
  Posted p{r, cid, src_world, tag, land, base_bytes, v.di.item};
  int handle;
  int64_t cts_src = -1, cts_rid = -1;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
    bool matched = false;
    for (auto it = g.unexpected.begin(); it != g.unexpected.end(); ++it) {
      if (it->mhandle) continue;  // owned by a matched probe
      if (it->cid != cid) continue;
      if (src_world != MPI_ANY_SOURCE && it->src != src_world) continue;
      if (tag != MPI_ANY_TAG && it->tag != tag) continue;
      if (it->rndv_pending) {
        // the first matching message is an announced (not yet arrived)
        // rendezvous: claim it — this is the moment the sender may
        // release the payload (CTS after the lock drops)
        g.rndv_wait[{it->src, it->rndv_id}] = p;
        cts_src = it->src;
        cts_rid = it->rndv_id;
        g.unexpected.erase(it);
        matched = true;
        break;
      }
      deliver(p, *it);
      g.unexpected.erase(it);
      matched = true;
      break;
    }
    if (!matched) g.posted.push_back(p);
  }
  if (cts_src >= 0) send_cts(cts_src, cts_rid);
  return handle;
}

// finish a completed receive on the calling thread (derived unpack,
// from the plan captured at post time)
void finish_recv(Req *r) {
  if (r->needs_unpack) {
    DtView v;
    v.di = r->plan_di;
    v.derived = &r->plan;
    // _count is BYTES (the probe-compatible unit) — cap the unpack at
    // exactly the received payload, not a multiple of it
    size_t avail = (size_t)r->status._count;
    unpack_dtype(r->user_buf, r->count, v, r->scratch.data(), avail);
    r->needs_unpack = false;
    r->scratch.clear();
  }
}

// remove every engine registration of `r` (posted entry, parked
// rendezvous claim, handle slot); match_mu must be held.  Keeps a
// stack-allocated Req from outliving its registration on error paths.
void deregister_locked(int handle, Req *r) {
  g.posted.remove_if([r](const Posted &p) { return p.req == r; });
  for (auto it = g_mrecv_wait.begin(); it != g_mrecv_wait.end();) {
    if (it->second.req == r) it = g_mrecv_wait.erase(it);
    else ++it;
  }
  for (auto it = g.rndv_wait.begin(); it != g.rndv_wait.end();) {
    if (it->second.req == r) it = g.rndv_wait.erase(it);
    else ++it;
  }
  g.reqs.erase(handle);
}

// wait for handle; fills status (world-rank source), frees the slot.
// On shutdown — or past `timeout_sec` when >= 0 — the request is fully
// deregistered before returning, so a stack-allocated Req never
// outlives its registration.
int wait_handle_impl(int handle, MPI_Status *status,
                     double timeout_sec = -1.0) {
  Req *r;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(
                      timeout_sec < 0 ? 0.0 : timeout_sec);
  {
    std::unique_lock<std::mutex> lk(g.match_mu);
    auto it = g.reqs.find(handle);
    if (it == g.reqs.end()) return MPI_ERR_REQUEST;
    r = it->second;
    while (!r->complete) {
      g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
      bool expired = timeout_sec >= 0 &&
                     std::chrono::steady_clock::now() > deadline;
      if (g.closing.load() || (expired && !r->complete)) {
        deregister_locked(handle, r);
        bool heap = r->heap;
        if (heap) delete r;
        return MPI_ERR_OTHER;
      }
    }
    g.reqs.erase(it);
  }
  finish_recv(r);
  int rc = r->status.MPI_ERROR;
  if (status) *status = r->status;
  if (r->heap) delete r;
  return rc;
}

// internal (collectives): stack Req, world-rank statuses
int wait_handle(int handle, MPI_Status *status) {
  return wait_handle_impl(handle, status);
}

// ------------------------------------------------------------ endpoints

void drain_loop(int fd);

void start_drain(int fd) {
  std::lock_guard<std::mutex> lk(g.threads_mu);
  if (g.closing.load()) {
    // Finalize already swept drain_fds: a drain started now would never
    // be shut down and would hang the join loop
    close(fd);
    return;
  }
  g.drain_fds.push_back(fd);
  g.threads.emplace_back(drain_loop, fd);
}

// Receiver side of bulk-data connections (hello ["d"]): one per
// SENDING peer (the sender caches and reuses it across transfers), EOF
// when that sender's Finalize closes its cache.  A joinable thread +
// a Finalize-swept fd per connection would accumulate (pthread stacks
// of exited joinable threads are retained until join), so these drains
// run detached, register in bulk_fds only for the Finalize shutdown
// sweep, and deregister + close their own fd on exit — the self-close
// is safe because the closing thread is the only reader.
void start_bulk_drain(int fd) {
  {
    std::lock_guard<std::mutex> lk(g.threads_mu);
    g.bulk_fds.push_back(fd);
  }
  std::thread([fd]() {
    drain_loop(fd);
    // deregister (so Finalize's shutdown sweep can't touch a reused fd
    // number) while flagging the close as in-flight — Finalize waits
    // for BOTH lists to drain, so a straggler's close-by-number can
    // never hit a descriptor the application opens after Finalize
    {
      std::lock_guard<std::mutex> lk(g.threads_mu);
      auto &v = g.bulk_fds;
      v.erase(std::remove(v.begin(), v.end(), fd), v.end());
      g.bulk_closing.fetch_add(1);
    }
    close(fd);
    g.bulk_closing.fetch_sub(1);
  }).detach();
}

int endpoint(int dest);
int peer_send_frame(int dest, const std::string &payload);

// rendezvous constants — wire-identical to pt2pt/tcp.py:158-162
constexpr int64_t RNDV_DATA_CID = 0x7FF9;
constexpr int64_t RNDV_CTS_CID = 0x7FFA;
constexpr const char *RTS_MARK = "__zmpi_rndv_rts__";

// one-sided plane: request frames are tuples on this reserved cid,
// applied by the drain (the AM-window shape of osc/am.py, C-side);
// replies are plain messages on the same cid matched by reply tag
constexpr int64_t WIN_CID = 0x7FF8;
void handle_win_frame(int64_t src, const DssVal &t);

// CTS leaves only when a receive CLAIMS the announced message — the
// Python plane's flow-control contract ("an unmatched multi-GB send
// must park at the SENDER, not in the receiver's unexpected queue",
// tcp.py send docstring; _resolve_rndv runs from on_match).  Called
// AFTER match_mu is released by the claiming path.
void send_cts(int64_t sender, int64_t rndv_id) {
  if (g.closing.load()) return;
  std::string cts;
  put_varint(cts, 5);
  put_int(cts, g.rank);
  put_int(cts, rndv_id);
  put_int(cts, RNDV_CTS_CID);
  put_int(cts, g.seq++);
  put_bytes(cts, "", 0);
  peer_send_frame((int)sender, cts);
  // NOTE: a sender dying AFTER this CTS (bulk connect/push failure)
  // leaves the claimed receive parked — the peer-death-without-fault-
  // tolerance class, surfaced on the sender as an error; job-level
  // recovery is the errhandler's business, as on the Python plane.
}

// Engine-level RTS note (the match half of TcpProc._resolve_rndv):
// record the announce and enter a PLACEHOLDER into the matching stream
// at this position, so the announced message keeps its place in the
// (src, tag, cid) order.  No CTS yet — the payload stays parked at the
// sender until a receive claims the placeholder.
void answer_rts(const std::vector<DssVal> &vals) {
  int64_t sender = vals[4].items[1].i;
  int64_t rndv_id = vals[4].items[2].i;
  {
    std::lock_guard<std::mutex> lk(g.rndv_mu);
    g.rndv_in[{sender, rndv_id}] = {vals[1].i, vals[2].i, vals[3].i};
  }
  Message ph;
  ph.src = vals[0].i;
  ph.tag = vals[1].i;
  ph.cid = vals[2].i;
  ph.seq = vals[3].i;
  ph.rndv_pending = true;
  ph.rndv_id = rndv_id;
  ph.rndv_nbytes = vals[4].items[3].i;
  push_message(std::move(ph));
}

// Bulk-data arrival: complete the receive the placeholder claimed, or
// fill the placeholder where it sits in the unexpected queue (position
// preserved either way).
void land_rndv_data(Message &&m, int64_t rid) {
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto w = g.rndv_wait.find({m.src, rid});
    if (w != g.rndv_wait.end()) {
      deliver(w->second, m);
      g.rndv_wait.erase(w);
      g.match_cv.notify_all();
      return;
    }
    for (auto it = g.unexpected.begin(); it != g.unexpected.end();
         ++it) {
      Message &u = *it;
      if (u.rndv_pending && u.src == m.src && u.rndv_id == rid) {
        u.dt = std::move(m.dt);
        u.data = std::move(m.data);
        u.rndv_pending = false;
        // an Imrecv may already be parked on this extracted message:
        // deliver into its buffer now and retire the placeholder
        if (u.mhandle) {
          auto mw = g_mrecv_wait.find(u.mhandle);
          if (mw != g_mrecv_wait.end()) {
            deliver(mw->second, u);
            g_mrecv_wait.erase(mw);
            g.unexpected.erase(it);
          }
        }
        g.match_cv.notify_all();
        return;
      }
    }
  }
  // placeholder vanished (shutdown race): deliver by normal matching
  push_message(std::move(m));
}

// one inbound frame, from EITHER transport (TCP drains and the sm
// poll loop feed the identical dispatch)
void dispatch_frame(const std::string &frame) {
  std::vector<DssVal> vals;
  if (!parse_all(frame, vals) || vals.size() != 5) return;
  if (vals[4].tag == T_TUPLE && vals[4].items.size() == 4 &&
      vals[4].items[0].tag == T_STR && vals[4].items[0].s == RTS_MARK) {
    answer_rts(vals);
    return;
  }
  if (vals[2].i == WIN_CID && vals[4].tag == T_TUPLE) {
    handle_win_frame(vals[0].i, vals[4]);
    return;
  }
  Message m;
  m.src = vals[0].i;
  m.tag = vals[1].i;
  m.cid = vals[2].i;
  m.seq = vals[3].i;
  if (vals[4].tag == T_NDARRAY) {
    m.dt = vals[4].dt;
    m.data = vals[4].data;
  } else if (vals[4].tag == T_BYTES || vals[4].tag == T_STR) {
    m.data = vals[4].s;
  }
  if (m.cid == RNDV_DATA_CID) {
    // bulk data of an announced transfer: re-frame under the envelope
    // the RTS carried, then land it on the placeholder/claimed recv
    int64_t rid = m.tag;
    std::array<int64_t, 3> env;
    {
      std::lock_guard<std::mutex> lk(g.rndv_mu);
      auto it = g.rndv_in.find({m.src, rid});
      if (it == g.rndv_in.end()) return;  // unannounced: drop
      env = it->second;
      g.rndv_in.erase(it);
    }
    m.tag = env[0];
    m.cid = env[1];
    m.seq = env[2];
    land_rndv_data(std::move(m), rid);
    return;
  }
  push_message(std::move(m));
}

void drain_loop(int fd) {
  std::string frame;
  while (!g.closing.load()) {
    if (!recv_frame(fd, frame)) return;
    dispatch_frame(frame);
  }
}

void accept_loop() {
  while (!g.closing.load()) {
    int fd = accept(g.listen_fd, nullptr, nullptr);
    if (fd < 0) return;
    set_cloexec(fd);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::string hello;
    if (!recv_frame(fd, hello)) { close(fd); continue; }
    std::vector<DssVal> vals;
    if (!parse_all(hello, vals) || vals.empty()) { close(fd); continue; }
    if (vals[0].tag == T_INT) {
      std::lock_guard<std::mutex> lk(g.conn_mu);
      if (!g.conns.count((int)vals[0].i)) g.conns[(int)vals[0].i] = fd;
    } else if (vals[0].tag == T_LIST) {
      // rendezvous bulk connection (hello ["d"]): transient,
      // self-closing, never registered for sends
      start_bulk_drain(fd);
      continue;
    }
    start_drain(fd);
  }
}

int endpoint(int dest) {
  {
    std::lock_guard<std::mutex> lk(g.conn_mu);
    auto it = g.conns.find(dest);
    if (it != g.conns.end()) return it->second;
  }
  int fd = tcp_connect(g.book[dest].first, g.book[dest].second);
  if (fd < 0) return -1;
  std::string hello;
  put_varint(hello, 1);
  put_int(hello, g.rank);
  if (!send_frame(fd, hello)) { close(fd); return -1; }
  {
    std::lock_guard<std::mutex> lk(g.conn_mu);
    auto it = g.conns.find(dest);
    if (it != g.conns.end()) {
      // crossed simultaneous connect: the peer may have registered OUR
      // socket (it saw the hello) — closing it would RST the peer's
      // first frames.  Keep both; each side sends on its own choice.
      start_drain(fd);
      return it->second;
    }
    g.conns[dest] = fd;
  }
  start_drain(fd);
  return fd;
}

// ONE main-channel frame to a peer: the sm ring when the direction is
// activated (entire channel, preserving per-direction FIFO), else the
// TCP endpoint under the global send lock.  Every main-channel
// producer routes through here — mixing transports per direction
// would break the matching order.
int peer_send_frame(int dest, const std::string &payload) {
  if (SmRing *r = sm_ring_to(dest)) return sm_send_frame(r, payload);
  int fd = endpoint(dest);
  if (fd < 0) return MPI_ERR_OTHER;
  std::lock_guard<std::mutex> lk(g.send_mu);
  return send_frame(fd, payload) ? MPI_SUCCESS : MPI_ERR_OTHER;
}

// RTS/CTS rendezvous send (pml_ob1_sendreq.c:768's protocol, the wire
// shape of TcpProc._send_rndv), split in two so MPI_Isend can put the
// ANNOUNCE on the wire from the calling thread — the RTS's position on
// the control socket is what fixes the message's matching order
// (non-overtaking), so it must precede any later frame to the peer —
// while the CTS wait + bulk push run wherever convenient.

// Announce: post the CTS receive, then send the RTS inline.  On success
// fills rid/handle; the heap CTS Req is owned by the handle machinery.
int rndv_announce(size_t count, const DtInfo &di, int dest, int64_t tag,
                  int64_t cid, int64_t &rid_out, int &handle_out) {
  int64_t rid = g.next_rndv.fetch_add(1);
  static char dummy;  // zero-byte CTS landing, shared is fine
  Req *r = new Req;
  r->is_recv = true;
  r->heap = true;
  r->user_buf = &dummy;
  r->count = 0;
  DtView v;  // byte view; CTS payload is empty
  v.di = {"|u1", 1};
  int handle = post_recv(r, v, RNDV_CTS_CID, dest, rid);
  // every early return must deregister: a stale posted entry would let
  // a late CTS write through a freed request
  auto abort_cts = [&]() {
    std::lock_guard<std::mutex> lk(g.match_mu);
    deregister_locked(handle, r);
    delete r;
    return MPI_ERR_OTHER;
  };
  std::string rts;
  put_varint(rts, 5);
  put_int(rts, g.rank);
  put_int(rts, tag);
  put_int(rts, cid);
  put_int(rts, g.seq++);
  rts.push_back((char)T_TUPLE);
  put_varint(rts, 4);
  put_str(rts, RTS_MARK);
  put_int(rts, g.rank);
  put_int(rts, rid);
  put_int(rts, (int64_t)(count * di.item));
  if (peer_send_frame(dest, rts) != MPI_SUCCESS) return abort_cts();
  rid_out = rid;
  handle_out = handle;
  return MPI_SUCCESS;
}

// Complete: wait for the receiver's CTS (it arrives when a receive
// MATCHES the announce, so a blocking send legally waits as long as the
// receiver computes — infinite by default, MPI blocking-send law;
// ZMPI_MCA_rndv_cts_timeout bounds it for jobs preferring typed errors
// over peer-death hangs), then push the data frame over a dedicated
// bulk connection so the control socket never carries a multi-MB write.
// Cached per-peer bulk connections: a TCP connect + slow-start per
// multi-MB transfer costs more than the transfer at larger sizes, so
// the first rendezvous to a peer opens the hello-["d"] connection and
// later ones reuse it (frames serialize under bulk_mu; the receiver's
// bulk drain loops over frames and self-closes on our Finalize EOF).
int bulk_endpoint_locked(int dest) {
  auto it = g.bulk_conns.find(dest);
  if (it != g.bulk_conns.end()) return it->second;
  int dfd = tcp_connect(g.book[dest].first, g.book[dest].second);
  if (dfd < 0) return -1;
  std::string hello;
  put_varint(hello, 1);
  hello.push_back((char)T_LIST);
  put_varint(hello, 1);
  put_str(hello, "d");
  if (!send_frame(dfd, hello)) {
    close(dfd);
    return -1;
  }
  g.bulk_conns[dest] = dfd;
  return dfd;
}

int rndv_complete(const void *buf, size_t count, const DtInfo &di,
                  int dest, int64_t rid, int handle) {
  MPI_Status st{};
  int rc = wait_handle_impl(handle, &st, g.cts_timeout);
  if (rc != MPI_SUCCESS) return rc;
  std::string payload;
  put_varint(payload, 5);
  put_int(payload, g.rank);
  put_int(payload, rid);
  put_int(payload, RNDV_DATA_CID);
  put_int(payload, g.seq++);
  put_ndarray_1d(payload, di.tag, buf, count, di.item);
  std::mutex *peer_mu;
  {
    std::lock_guard<std::mutex> lk(g.bulk_mu);
    auto &slot = g.bulk_peer_mu[dest];
    if (!slot) slot.reset(new std::mutex);
    peer_mu = slot.get();
  }
  std::lock_guard<std::mutex> plk(*peer_mu);
  int dfd;
  {
    std::lock_guard<std::mutex> lk(g.bulk_mu);
    dfd = bulk_endpoint_locked(dest);
  }
  bool ok = dfd >= 0 && send_frame(dfd, payload);
  if (!ok && dfd >= 0) {
    // a broken cached connection gets one fresh retry
    std::lock_guard<std::mutex> lk(g.bulk_mu);
    close(dfd);
    g.bulk_conns.erase(dest);
    dfd = bulk_endpoint_locked(dest);
    ok = dfd >= 0 && send_frame(dfd, payload);
  }
  return ok ? MPI_SUCCESS : MPI_ERR_OTHER;
}

int wire_send_rndv(const void *buf, size_t count, const DtInfo &di,
                   int dest, int64_t tag, int64_t cid) {
  int64_t rid;
  int handle;
  int rc = rndv_announce(count, di, dest, tag, cid, rid, handle);
  if (rc != MPI_SUCCESS) return rc;
  return rndv_complete(buf, count, di, dest, rid, handle);
}

// DSS reply carrying an address book (the modex coordinator's answer,
// shared by MPI_Init's rank-0 coordinator and the spawn coordinator)
std::string pack_address_book(
    const std::vector<std::pair<std::string, int>> &book,
    const std::vector<std::string> *caps = nullptr) {
  std::string reply;
  put_varint(reply, 1);
  reply.push_back((char)T_LIST);
  put_varint(reply, book.size());
  for (size_t i = 0; i < book.size(); i++) {
    const std::string cap =
        caps && i < caps->size() ? (*caps)[i] : std::string();
    reply.push_back((char)T_LIST);
    put_varint(reply, cap.empty() ? 2 : 3);
    put_str(reply, book[i].first);
    put_int(reply, book[i].second);
    if (!cap.empty()) put_str(reply, cap);
  }
  return reply;
}

// wire-send `count` contiguous base elements (world-rank addressing).
// allow_rndv selects the protocol split: USER point-to-point sends
// rendezvous above the eager limit (flow control for unmatched sends);
// collective-internal sends stay eager at any size — their receives are
// posted by the same synchronized algorithm on every rank, so the
// unexpected-queue exposure is one round's worth by construction, and
// eager keeps the ring/pairwise exchanges deadlock-free (the same
// reasoning as the allgather ring's buffered-eager note below).
int wire_send(const void *buf, size_t count, const DtInfo &di, int dest,
              int64_t tag, int64_t cid, bool allow_rndv = false,
              bool force_rndv = false) {
  if (dest == g.rank) {
    if (force_rndv) {
      // synchronous self-send: completion must imply the receive is
      // matched, so wait until a matching receive is POSTED before
      // delivering (unmatched single-threaded self-Ssend deadlocks,
      // as the spec's contract implies; a concurrent thread's recv
      // releases it)
      std::unique_lock<std::mutex> lk(g.match_mu);
      for (;;) {
        bool posted = false;
        for (auto &pp : g.posted) {
          if (pp.cid != cid) continue;
          if (pp.src_world != MPI_ANY_SOURCE && pp.src_world != g.rank)
            continue;
          if (pp.tag != MPI_ANY_TAG && pp.tag != tag) continue;
          posted = true;
          break;
        }
        if (posted) break;
        g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
        if (g.closing.load()) return MPI_ERR_OTHER;
      }
    }
    Message m;
    m.src = g.rank; m.tag = tag; m.cid = cid; m.seq = g.seq++;
    m.dt = di.tag;
    m.data.assign((const char *)buf, count * di.item);
    push_message(std::move(m));
    return MPI_SUCCESS;
  }
  // 4-byte framing bounds any single message below 4 GiB (the Python
  // plane shares the limit — struct "<I"); reject with a typed error
  // rather than let send_frame fail opaquely after the RTS handshake
  if (count * di.item > 0xFFFF0000ull) return MPI_ERR_COUNT;
  if (force_rndv ||
      (allow_rndv && (int64_t)(count * di.item) > g.eager_limit)) {
    int rc = wire_send_rndv(buf, count, di, dest, tag, cid);
    if (rc == MPI_SUCCESS) {  // pvars count sends that reached the wire
      g.ctr_rndv_sends.fetch_add(1, std::memory_order_relaxed);
      g.ctr_bytes_sent.fetch_add((long long)(count * di.item),
                                 std::memory_order_relaxed);
    }
    return rc;
  }
  std::string payload;
  put_varint(payload, 5);
  put_int(payload, g.rank);
  put_int(payload, tag);
  put_int(payload, cid);
  put_int(payload, g.seq++);
  put_ndarray_1d(payload, di.tag, buf, count, di.item);
  if (peer_send_frame(dest, payload) != MPI_SUCCESS)
    return MPI_ERR_OTHER;
  g.ctr_eager_sends.fetch_add(1, std::memory_order_relaxed);
  g.ctr_bytes_sent.fetch_add((long long)(count * di.item),
                             std::memory_order_relaxed);
  return MPI_SUCCESS;
}

// blocking internal recv of contiguous base elements (world addressing);
// used by the collective algorithms
int raw_recv(void *buf, int count, MPI_Datatype dt, int source, int64_t tag,
             int64_t cid, MPI_Status *status) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  Req r;
  r.is_recv = true;
  r.user_buf = buf;
  r.count = count;
  int handle = post_recv(&r, v, cid, source, tag);
  return wait_handle(handle, status);
}

int raw_send(const void *buf, int count, MPI_Datatype dt, int dest,
             int64_t tag, int64_t cid, bool allow_rndv = false,
             bool force_rndv = false) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  if (v.contiguous())
    return wire_send(buf, (size_t)count * v.elems_per_item(), v.di, dest,
                     tag, cid, allow_rndv, force_rndv);
  std::vector<char> packed;
  pack_dtype(buf, count, v, packed);
  return wire_send(packed.data(), packed.size() / v.di.item, v.di, dest,
                   tag, cid, allow_rndv, force_rndv);
}

// --------------------------------------------------------- communicators

struct CommObj {
  std::vector<int> group;   // local rank -> world rank
  int local_rank = 0;
  int64_t cid_pt2pt, cid_coll, cid_bar;
  int64_t coll_seq = 0;
  uint64_t child_seq = 0;
  uint64_t win_seq = 0;               // per-comm window-id sequence
  // intercommunicator: non-empty => pt2pt addresses THIS group (remote
  // ranks), local_rank/group stay the local side (intercomm_create.c)
  std::vector<int> remote;
  std::vector<int> cart_dims;         // non-empty => Cartesian topology
  std::vector<int> cart_periods;
  std::vector<int> graph_index;       // non-empty => graph topology
  std::vector<int> graph_edges;
  bool dist = false;                  // distributed graph (adjacent form)
  bool dist_weighted = false;
  std::vector<int> dist_src;          // recv neighbors, in order
  std::vector<int> dist_dst;          // send neighbors, in order
  std::vector<int> dist_srcw;         // weights (when dist_weighted)
  std::vector<int> dist_dstw;
};

std::map<int, CommObj> g_comms;
int g_next_comm = 2;  // 0 = WORLD, 1 = SELF

// group table: a group is a list of world ranks (the ompi/group analog
// with int handles)
struct GroupObj {
  std::vector<int> ranks;  // group rank -> world rank
};
std::map<int, GroupObj> g_groups;
int g_next_group = 1;

GroupObj *lookup_group(int grp) {
  auto it = g_groups.find(grp);
  return it == g_groups.end() ? nullptr : &it->second;
}

int register_group(std::vector<int> ranks) {
  int handle = g_next_group++;
  g_groups[handle] = GroupObj{std::move(ranks)};
  return handle;
}

// MPI-IO file table (definitions with the other global state so
// MPI_Finalize can sweep leaked fds)
struct FileObj {
  int fd = -1;
  int amode = 0;
  int comm = MPI_COMM_WORLD;
  int64_t pointer = 0;  // individual pointer, ETYPES (bytes w/ default view)
  std::string path;
  // file view (io_ompio's etype/filetype template, byte-flattened):
  // the filetype tiles the file from `disp`; IO addresses payload
  // bytes inside the tiles.  Default view = identity (etype BYTE,
  // filetype BYTE) — offsets are then plain bytes.
  int64_t view_disp = 0;
  MPI_Datatype view_etype = 0 /* MPI_BYTE */;
  MPI_Datatype view_ftype = 0;
  std::vector<std::pair<int64_t, int64_t>> vblocks;  // (off,len) bytes
  int64_t vtile = 1;      // filetype extent (bytes)
  int64_t vpayload = 1;   // payload bytes per tile
  int64_t etype_size = 1;
  bool identity_view = true;
  // shared file pointer (sharedfp/lockedfile's shape): sidecar file,
  // flock-serialized fetch-and-add; value in ETYPES
  std::string sfp_path;
  bool atomic_mode = false;
  // one outstanding split collective (read/write_all|ordered_begin)
  bool split_active = false;
  MPI_Status split_status{};
};

std::map<int, FileObj> g_files;
int g_next_file = 1;
// guards map MUTATION vs the nonblocking-IO threads' lookups; node
// pointers stay valid across inserts (std::map), and closing a file
// with IO in flight is erroneous per MPI, so held FileObj*s are safe
std::mutex g_files_mu;

CommObj *lookup_comm(MPI_Comm c) {
  auto it = g_comms.find(c);
  return it == g_comms.end() ? nullptr : &it->second;
}

int world_of(const CommObj &c, int local) {
  return (local >= 0 && local < (int)c.group.size()) ? c.group[local] : -1;
}

int local_of(const CommObj &c, int world) {
  for (size_t i = 0; i < c.group.size(); i++)
    if (c.group[i] == world) return (int)i;
  return MPI_ANY_SOURCE;
}

// point-to-point PEER group: on an intercommunicator ranks address the
// REMOTE group (MPI-3.1 6.6.1); intracommunicators address themselves
const std::vector<int> &peer_group(const CommObj &c) {
  return c.remote.empty() ? c.group : c.remote;
}

int peer_world_of(const CommObj &c, int rank) {
  const std::vector<int> &pg = peer_group(c);
  return (rank >= 0 && rank < (int)pg.size()) ? pg[rank] : -1;
}

int peer_local_of(const CommObj &c, int world) {
  const std::vector<int> &pg = peer_group(c);
  for (size_t i = 0; i < pg.size(); i++)
    if (pg[i] == world) return (int)i;
  return MPI_ANY_SOURCE;
}

uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Deterministic child context ids: every member of the parent computes
// the same triple, so no agreement round is needed.  Disjoint sibling
// groups may share a cid — harmless, they share no endpoints.  The low
// reserved ids (0 pt2pt, 0x7FFC coll, 0x7FFD barrier, SELF block) are
// below 0x10000; derived cids are forced above it.
void derive_cids(const CommObj &parent, uint64_t salt, CommObj &child) {
  uint64_t base =
      mix64(mix64((uint64_t)parent.cid_pt2pt) ^
            (parent.child_seq * 0x100000001B3ULL) ^ salt);
  base = (base & 0x3FFFFFFFFFFFULL) | 0x10000ULL;
  child.cid_pt2pt = (int64_t)base;
  child.cid_coll = (int64_t)base + 1;
  child.cid_bar = (int64_t)base + 2;
}

// ----------------------------------------------------------- reductions

template <typename T>
int reduce_arith(T *acc, const T *in, int n, MPI_Op op) {
  switch (op) {
    case MPI_SUM:
      for (int i = 0; i < n; i++) acc[i] = acc[i] + in[i];
      return MPI_SUCCESS;
    case MPI_PROD:
      for (int i = 0; i < n; i++) acc[i] = acc[i] * in[i];
      return MPI_SUCCESS;
    case MPI_MAX:
      for (int i = 0; i < n; i++) acc[i] = acc[i] > in[i] ? acc[i] : in[i];
      return MPI_SUCCESS;
    case MPI_MIN:
      for (int i = 0; i < n; i++) acc[i] = acc[i] < in[i] ? acc[i] : in[i];
      return MPI_SUCCESS;
    case MPI_LAND:
      for (int i = 0; i < n; i++) acc[i] = (T)(acc[i] && in[i]);
      return MPI_SUCCESS;
    case MPI_LOR:
      for (int i = 0; i < n; i++) acc[i] = (T)(acc[i] || in[i]);
      return MPI_SUCCESS;
    case MPI_LXOR:
      for (int i = 0; i < n; i++) acc[i] = (T)(!acc[i] != !in[i]);
      return MPI_SUCCESS;
  }
  return MPI_ERR_OP;
}

template <typename T>
int reduce_int(T *acc, const T *in, int n, MPI_Op op) {
  switch (op) {
    case MPI_BAND:
      for (int i = 0; i < n; i++) acc[i] = acc[i] & in[i];
      return MPI_SUCCESS;
    case MPI_BOR:
      for (int i = 0; i < n; i++) acc[i] = acc[i] | in[i];
      return MPI_SUCCESS;
    case MPI_BXOR:
      for (int i = 0; i < n; i++) acc[i] = acc[i] ^ in[i];
      return MPI_SUCCESS;
  }
  return reduce_arith(acc, in, n, op);
}

// user-defined reduction operators (ompi/op/op.c:243-287's table,
// reduced to a map); handles from 0x20 up
struct UserOp {
  MPI_User_function *fn;
  bool commute;
};
std::map<MPI_Op, UserOp> g_user_ops;
MPI_Op g_next_op = 0x20;

// MINLOC/MAXLOC over (value, index) pair structs: winner by value,
// ties broken by the LOWER index (MPI-3.1 §5.9.4)
template <typename Pair>
void reduce_loc(Pair *acc, const Pair *in, int n, bool maxloc) {
  for (int i = 0; i < n; i++) {
    bool take = maxloc ? in[i].v > acc[i].v : in[i].v < acc[i].v;
    if (in[i].v == acc[i].v) take = in[i].i < acc[i].i;
    if (take) acc[i] = in[i];
  }
}

struct PairFloatInt { float v; int i; };
struct PairDoubleInt { double v; int i; };
struct PairLongInt { long v; int i; };
struct PairShortInt { short v; int i; };
struct Pair2Int { int v; int i; };

int reduce_loc_buf(void *acc, const void *in, int n, MPI_Datatype dt,
                   bool maxloc) {
  switch (dt) {
    case MPI_2INT:
      reduce_loc((Pair2Int *)acc, (const Pair2Int *)in, n, maxloc);
      return MPI_SUCCESS;
    case MPI_FLOAT_INT:
      reduce_loc((PairFloatInt *)acc, (const PairFloatInt *)in,
                        n, maxloc);
      return MPI_SUCCESS;
    case MPI_DOUBLE_INT:
      reduce_loc((PairDoubleInt *)acc, (const PairDoubleInt *)in,
                         n, maxloc);
      return MPI_SUCCESS;
    case MPI_LONG_INT:
      reduce_loc((PairLongInt *)acc, (const PairLongInt *)in, n,
                       maxloc);
      return MPI_SUCCESS;
    case MPI_SHORT_INT:
      reduce_loc((PairShortInt *)acc, (const PairShortInt *)in,
                        n, maxloc);
      return MPI_SUCCESS;
  }
  return MPI_ERR_TYPE;  // MINLOC/MAXLOC require a pair type
}

// acc = acc ⊕ in elementwise, acc as the LEFT operand (rank order is
// the caller's responsibility; op.h:547-605's in-order contract)
int reduce_buf(void *acc, const void *in, int n, MPI_Datatype dt,
               MPI_Op op) {
  // the RMA identity ops (MPI-3.1 §11.3): REPLACE = atomic put,
  // NO_OP = leave the accumulator untouched
  if (op == MPI_REPLACE) {
    DtInfo di;
    if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
    memcpy(acc, in, (size_t)n * di.item);
    return MPI_SUCCESS;
  }
  if (op == MPI_NO_OP) return MPI_SUCCESS;
  if (op == MPI_MINLOC || op == MPI_MAXLOC)
    return reduce_loc_buf(acc, in, n, dt, op == MPI_MAXLOC);
  auto uit = g_user_ops.find(op);
  if (uit != g_user_ops.end()) {
    // MPI user fn computes inoutvec = invec ∘ inoutvec (invec LEFT);
    // feed invec=acc, inoutvec=copy(in), copy back — acc ∘ in lands
    // in acc per this function's contract
    DtInfo di;
    if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
    std::vector<char> tmp((size_t)n * di.item);
    memcpy(tmp.data(), in, tmp.size());
    int len = n;
    MPI_Datatype d = dt;
    uit->second.fn(acc, tmp.data(), &len, &d);
    memcpy(acc, tmp.data(), tmp.size());
    return MPI_SUCCESS;
  }
  switch (dt) {
    case MPI_INT:
      return reduce_int((int32_t *)acc, (const int32_t *)in, n, op);
    case MPI_LONG:
    case MPI_LONG_LONG:
      return reduce_int((int64_t *)acc, (const int64_t *)in, n, op);
    case MPI_CHAR:
    case MPI_SIGNED_CHAR:
      return reduce_int((int8_t *)acc, (const int8_t *)in, n, op);
    case MPI_SHORT:
      return reduce_int((int16_t *)acc, (const int16_t *)in, n, op);
    case MPI_BYTE:
    case MPI_UNSIGNED_CHAR:
      return reduce_int((uint8_t *)acc, (const uint8_t *)in, n, op);
    case MPI_UNSIGNED_SHORT:
      return reduce_int((uint16_t *)acc, (const uint16_t *)in, n, op);
    case MPI_UNSIGNED:
      return reduce_int((uint32_t *)acc, (const uint32_t *)in, n, op);
    case MPI_UNSIGNED_LONG:
      return reduce_int((uint64_t *)acc, (const uint64_t *)in, n, op);
    case MPI_FLOAT:
      // bitwise ops on floats are invalid (MPI-4.1 §6.9.2)
      return reduce_arith((float *)acc, (const float *)in, n, op);
    case MPI_DOUBLE:
      return reduce_arith((double *)acc, (const double *)in, n, op);
  }
  return MPI_ERR_TYPE;
}

// ------------------------------------------------------------- windows
// Active-target RMA (win_create.c:44 / osc_rdma's fence epoch, reduced
// to the AM shape the Python plane's osc/am.py uses): the window is the
// target's local buffer; put/accumulate are fire-and-forget tuples the
// target's drain applies under the window lock; get/flush are RPCs.
// Per-origin FIFO on a connection means a flush reply proves every
// earlier op from that origin has been applied — fence is flush-all
// plus the communicator barrier.

struct WinObj {
  char *base = nullptr;
  int64_t size = 0;  // bytes
  int disp_unit = 1;
  bool owns_base = false;  // Win_allocate: free the buffer at Win_free
  CommObj comm;      // snapshot at creation
  std::mutex mu;     // apply lock (drains from several origins)
  std::set<int> dirty;  // world ranks with unflushed ops from us
  std::mutex dirty_mu;
  // passive-target lock manager (osc/am.py _LockManager's shape): the
  // target's drain arbitrates; waiters park their reply tag until a
  // release grants them, FIFO
  std::mutex lock_mu;
  int lock_excl_holder = -1;        // world rank or -1
  int lock_shared = 0;              // count of shared holders
  std::deque<std::array<int64_t, 3>> lock_waiters;  // (origin, type, rtag)
  // PSCW epochs: the start group (targets we access) and post group
  // (origins exposed to), world ranks.  The open flags distinguish an
  // EMPTY epoch (legal, MPI_GROUP_EMPTY) from no epoch at all.
  std::vector<int> pscw_start;
  std::vector<int> pscw_post;
  bool pscw_start_open = false;
  bool pscw_post_open = false;
  // dynamic windows (win_create_dynamic.c): ops address ABSOLUTE byte
  // displacements that must land inside a locally attached region
  bool dynamic = false;
  std::vector<std::pair<uint64_t, uint64_t>> attached;  // (addr, len)
  std::mutex attach_mu;
  // shared-memory windows (win_allocate_shared.c): one mmap'd segment
  // per comm, every rank maps the whole thing
  bool shm = false;
  char *shm_map = nullptr;
  size_t shm_len = 0;
  std::string shm_path;
  std::vector<int64_t> shm_sizes;   // per comm rank
  std::vector<int> shm_units;
  std::vector<int64_t> shm_offsets;
};

// resolve the target-side destination of an RMA op: normal windows
// bound-check against [0, size); dynamic windows take absolute
// displacements validated against the attached-region list
char *win_dst(WinObj *w, int64_t disp, int64_t nbytes) {
  if (nbytes < 0) return nullptr;
  if (!w->dynamic) {
    if (disp < 0 || disp + nbytes > w->size) return nullptr;
    return w->base + disp;
  }
  std::lock_guard<std::mutex> lk(w->attach_mu);
  for (auto &r : w->attached) {
    uint64_t d = (uint64_t)disp;
    if (d >= r.first && d + (uint64_t)nbytes <= r.first + r.second)
      return (char *)(uintptr_t)d;
  }
  return nullptr;
}

std::map<int64_t, WinObj *> g_wins;      // wire win-id -> obj
std::map<int, int64_t> g_win_handles;    // local MPI_Win -> wire win-id
int g_next_win_handle = 0;
std::mutex g_wins_mu;

std::atomic<int64_t> g_next_reply_tag{1};

// send a 5-frame whose payload is a window tuple (tag 0: requests are
// dispatched by cid+tuple, never matched)
int win_send_tuple(int dest_world, const std::string &tuple_payload) {
  if (dest_world == g.rank) return MPI_ERR_OTHER;  // caller handles self
  std::string f;
  put_varint(f, 5);
  put_int(f, g.rank);
  put_int(f, 0);
  put_int(f, WIN_CID);
  put_int(f, g.seq++);
  f += tuple_payload;
  return peer_send_frame(dest_world, f);
}

void win_reply(int64_t origin, int64_t reply_tag, const void *data,
               size_t nbytes) {
  if (origin == g.rank) return;
  std::string f;
  put_varint(f, 5);
  put_int(f, g.rank);
  put_int(f, reply_tag);
  put_int(f, WIN_CID);
  put_int(f, g.seq++);
  put_ndarray_1d(f, "|u1", data, nbytes, 1);
  peer_send_frame((int)origin, f);
}

// The one lock-release path (wunlock wire handler AND the self-target
// MPI_Win_unlock): drop `unlocker`'s hold, then grant waiters FIFO — a
// head exclusive waits for full drain and blocks everyone behind it,
// shared waiters are granted as a run.  Returns the granted
// (origin, type, reply_tag) rows; the caller sends the replies.
std::vector<std::array<int64_t, 3>> release_and_grants(WinObj *w,
                                                       int unlocker) {
  std::vector<std::array<int64_t, 3>> grants;
  std::lock_guard<std::mutex> lk(w->lock_mu);
  if (w->lock_excl_holder == unlocker) w->lock_excl_holder = -1;
  else if (w->lock_shared > 0) w->lock_shared--;
  while (!w->lock_waiters.empty()) {
    auto next = w->lock_waiters.front();
    if (next[1] == 1) {  // exclusive waiter
      if (w->lock_excl_holder < 0 && w->lock_shared == 0) {
        w->lock_excl_holder = (int)next[0];
        grants.push_back(next);
        w->lock_waiters.pop_front();
      }
      break;  // exclusive at the head blocks everyone behind it
    }
    if (w->lock_excl_holder >= 0) break;
    w->lock_shared++;
    grants.push_back(next);
    w->lock_waiters.pop_front();
  }
  return grants;
}

// The one AMO apply path (local fast path AND the wamo wire handler):
// validates displacement and operand shape, applies under the window
// lock, fills `old` with the pre-op value.  subkind: add | set | swap |
// cas ([compare][value] operand) | fetch (no operand) | "aop:<N>"
// (cell = cell OP operand for predefined op N).  Every subkind except
// cas operates on `nelems` elements atomically — the Get_accumulate
// general form; fetch takes nelems from the caller since it has no
// operand.  User ops are rejected at the origin, per MPI.
bool apply_amo(WinObj *w, int64_t disp, const std::string &sub,
               MPI_Datatype dt, const char *opnd, size_t opnd_len,
               std::vector<char> &old, int64_t fetch_elems = 1) {
  DtInfo di;
  if (!base_dtinfo(dt, di)) return false;
  int64_t nelems;
  if (sub == "cas") {
    if (opnd_len != 2 * di.item || opnd == nullptr) return false;
    nelems = 1;
  } else if (sub == "fetch") {
    if (opnd_len != 0) return false;
    nelems = fetch_elems;
  } else {
    if (opnd_len == 0 || opnd == nullptr || opnd_len % di.item)
      return false;
    nelems = (int64_t)(opnd_len / di.item);
  }
  if (nelems <= 0) return false;
  char *cell = win_dst(w, disp, nelems * (int64_t)di.item);
  if (!cell) return false;
  old.resize((size_t)nelems * di.item);
  std::lock_guard<std::mutex> lk(w->mu);
  memcpy(old.data(), cell, old.size());
  if (sub == "add") {
    reduce_buf(cell, opnd, (int)nelems, dt, MPI_SUM);
  } else if (sub == "set" || sub == "swap") {
    memcpy(cell, opnd, old.size());
  } else if (sub == "cas") {
    if (memcmp(cell, opnd, di.item) == 0)
      memcpy(cell, opnd + di.item, di.item);
  } else if (sub.rfind("aop:", 0) == 0) {
    MPI_Op op = (MPI_Op)atoi(sub.c_str() + 4);
    if (g_user_ops.count(op)) return false;
    if (reduce_buf(cell, opnd, (int)nelems, dt, op) != MPI_SUCCESS)
      return false;
  } else if (sub != "fetch") {
    return false;
  }
  return true;
}

// Drain-side dispatch of ("wput"|"wacc"|"wget"|"wflush", win_id, ...)
void handle_win_frame(int64_t src, const DssVal &t) {
  if (t.items.empty() || t.items[0].tag != T_STR) return;
  const std::string &kind = t.items[0].s;
  if (t.items.size() < 2) return;
  WinObj *w = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_wins_mu);
    auto it = g_wins.find(t.items[1].i);
    if (it == g_wins.end()) return;  // freed or never created: drop
    w = it->second;
  }
  if (kind == "wput" && t.items.size() == 4) {
    int64_t disp = t.items[2].i;
    const std::string &data = t.items[3].data;
    char *dst = win_dst(w, disp, (int64_t)data.size());
    if (!dst) return;
    std::lock_guard<std::mutex> lk(w->mu);
    memcpy(dst, data.data(), data.size());
  } else if (kind == "wacc" && t.items.size() == 6) {
    int64_t disp = t.items[2].i;
    MPI_Op op = (MPI_Op)t.items[3].i;
    MPI_Datatype dt = (MPI_Datatype)t.items[4].i;
    const std::string &data = t.items[5].data;
    DtInfo di;
    if (!base_dtinfo(dt, di)) return;
    int64_t n = (int64_t)(data.size() / di.item);
    char *dst = win_dst(w, disp, (int64_t)data.size());
    if (!dst) return;
    std::lock_guard<std::mutex> lk(w->mu);
    // MPI_Accumulate: target = target op origin (the service loop is
    // the serialization point, as in osc/am.py's apply_acc)
    reduce_buf(dst, data.data(), (int)n, dt, op);
  } else if (kind == "wget" && t.items.size() == 5) {
    int64_t disp = t.items[2].i;
    int64_t nbytes = t.items[3].i;
    int64_t reply_tag = t.items[4].i;
    char *src_p = win_dst(w, disp, nbytes);
    if (!src_p) {
      win_reply(src, reply_tag, "", 0);
      return;
    }
    std::vector<char> out((size_t)nbytes);
    {
      std::lock_guard<std::mutex> lk(w->mu);
      memcpy(out.data(), src_p, (size_t)nbytes);
    }
    win_reply(src, reply_tag, out.data(), out.size());
  } else if (kind == "wflush" && t.items.size() == 3) {
    // FIFO per connection: by the time the drain reaches this frame,
    // every earlier op from `src` has been applied
    win_reply(src, t.items[2].i, "", 0);
  } else if (kind == "wlock" && t.items.size() == 4) {
    // passive-target lock request: grant now or park the reply until a
    // release frees the window (the drain is the arbiter)
    int lock_type = (int)t.items[2].i;
    int64_t reply_tag = t.items[3].i;
    bool grant;
    {
      std::lock_guard<std::mutex> lk(w->lock_mu);
      if (lock_type == 1) {  // exclusive
        grant = w->lock_excl_holder < 0 && w->lock_shared == 0 &&
                w->lock_waiters.empty();
        if (grant) w->lock_excl_holder = (int)src;
      } else {               // shared
        grant = w->lock_excl_holder < 0 && w->lock_waiters.empty();
        if (grant) w->lock_shared++;
      }
      if (!grant) w->lock_waiters.push_back({src, lock_type, reply_tag});
    }
    if (grant) win_reply(src, reply_tag, "", 0);
  } else if (kind == "wunlock" && t.items.size() == 3) {
    // FIFO ordering means every op the holder issued before the unlock
    // is already applied — release, grant waiters, ack the unlocker
    auto grants = release_and_grants(w, (int)src);
    win_reply(src, t.items[2].i, "", 0);
    for (auto &gr : grants) win_reply(gr[0], gr[2], "", 0);
  } else if (kind == "wamo" && t.items.size() == 7) {
    // fetch-AMO RPC (the shmem_atomic substrate, oshmem/shmem/c/
    // shmem_fadd.c): ("wamo", wid, disp, subkind, dt, operand-bytes,
    // reply_tag) -> old value; applied atomically under the window
    // lock (the drain is the serialization point)
    int64_t reply_tag = t.items[6].i;
    std::string sub = t.items[3].s;
    int64_t fetch_n = 1;
    if (sub.rfind("fetch:", 0) == 0) {
      fetch_n = atoll(sub.c_str() + 6);
      sub = "fetch";
    }
    std::vector<char> old;
    if (!apply_amo(w, t.items[2].i, sub, (MPI_Datatype)t.items[4].i,
                   t.items[5].data.data(), t.items[5].data.size(), old,
                   fetch_n)) {
      win_reply(src, reply_tag, "", 0);
      return;
    }
    win_reply(src, reply_tag, old.data(), old.size());
  }
}

// --------------------------------------------- comm-generic collectives
// All take local-rank addressing and translate through comm.group;
// WORLD keeps the round-3 wire format (cid 0x7FFC/0x7FFD) so mixed
// C/Python jobs stay bit-compatible.

// barrier signal frame: empty T_BYTES payload, bit-identical to
// TcpProc.barrier's wire format (NOT a zero-length ndarray)
int send_barrier_signal(CommObj &c, int dest_world) {
  if (dest_world == g.rank) {
    Message m;
    m.src = g.rank; m.tag = 0x7FFD; m.cid = c.cid_bar; m.seq = g.seq++;
    push_message(std::move(m));
    return MPI_SUCCESS;
  }
  std::string payload;
  put_varint(payload, 5);
  put_int(payload, g.rank);
  put_int(payload, 0x7FFD);
  put_int(payload, c.cid_bar);
  put_int(payload, g.seq++);
  put_bytes(payload, "", 0);
  return peer_send_frame(dest_world, payload);
}

int c_barrier(CommObj &c) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // dissemination rounds (tag 0x7FFD), wire-identical to TcpProc.barrier
  int n = (int)c.group.size(), me = c.local_rank;
  for (int64_t k = 1; k < n; k <<= 1) {
    int dest = (int)((me + k) % n);
    int rc = send_barrier_signal(c, world_of(c, dest));
    if (rc) return rc;
    int src = (int)((me - k % n + n) % n);
    uint8_t dummy[1];
    rc = raw_recv(dummy, 0, MPI_BYTE, world_of(c, src), 0x7FFD, c.cid_bar,
                  nullptr);
    if (rc) return rc;
  }
  return MPI_SUCCESS;
}

int c_bcast(CommObj &c, void *buf, int count, MPI_Datatype dt, int root,
            int64_t opcode) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // binomial tree (coll_base_bcast.c:329 shape)
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | opcode;
  int vrank = (me - root + n) % n;
  if (vrank != 0) {
    int parent = ((vrank & (vrank - 1)) + root) % n;
    int rc = raw_recv(buf, count, dt, world_of(c, parent), tag, c.cid_coll,
                      nullptr);
    if (rc) return rc;
  }
  for (int mask = 1; mask < n; mask <<= 1) {
    if ((vrank & (mask - 1)) == 0 && (vrank | mask) != vrank) {
      int child = vrank | mask;
      if (child < n) {
        int rc = raw_send(buf, count, dt, world_of(c, (child + root) % n),
                          tag, c.cid_coll);
        if (rc) return rc;
      }
    }
  }
  return MPI_SUCCESS;
}

int c_allreduce(CommObj &c, const void *sendbuf, void *recvbuf, int count,
                MPI_Datatype dt, MPI_Op op) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // recursive doubling with the non-power-of-two pre/post fold
  // (in-order combines: lower rank's operand left)
  DtView v;
  if (!resolve_dtype(dt, v) || v.derived) return MPI_ERR_TYPE;
  size_t nbytes = (size_t)count * v.di.item;
  memcpy(recvbuf, sendbuf, nbytes);
  int n = (int)c.group.size(), me = c.local_rank;
  if (n == 1) return MPI_SUCCESS;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E03;
  std::vector<char> other(nbytes);

  int pof2 = 1;
  while (pof2 * 2 <= n) pof2 *= 2;
  int rem = n - pof2;
  int newrank;
  int rc;
  if (me < 2 * rem) {
    if (me % 2 == 0) {
      rc = raw_send(recvbuf, count, dt, world_of(c, me + 1), tag,
                    c.cid_coll);
      if (rc) return rc;
      newrank = -1;
    } else {
      rc = raw_recv(other.data(), count, dt, world_of(c, me - 1), tag,
                    c.cid_coll, nullptr);
      if (rc) return rc;
      // lower rank's operand left: acc = other ⊕ acc
      std::vector<char> tmp(other);
      rc = reduce_buf(tmp.data(), recvbuf, count, dt, op);
      if (rc) return rc;
      memcpy(recvbuf, tmp.data(), nbytes);
      newrank = me / 2;
    }
  } else {
    newrank = me - rem;
  }
  if (newrank >= 0) {
    for (int mask = 1; mask < pof2; mask <<= 1) {
      int pnew = newrank ^ mask;
      int partner = pnew < rem ? pnew * 2 + 1 : pnew + rem;
      rc = raw_send(recvbuf, count, dt, world_of(c, partner), tag,
                    c.cid_coll);
      if (rc) return rc;
      rc = raw_recv(other.data(), count, dt, world_of(c, partner), tag,
                    c.cid_coll, nullptr);
      if (rc) return rc;
      if (partner < me) {
        std::vector<char> tmp(other);
        rc = reduce_buf(tmp.data(), recvbuf, count, dt, op);
        if (rc) return rc;
        memcpy(recvbuf, tmp.data(), nbytes);
      } else {
        rc = reduce_buf(recvbuf, other.data(), count, dt, op);
        if (rc) return rc;
      }
    }
  }
  if (me < 2 * rem) {
    if (me % 2 == 0) {
      rc = raw_recv(recvbuf, count, dt, world_of(c, me + 1), tag,
                    c.cid_coll, nullptr);
      if (rc) return rc;
    } else {
      rc = raw_send(recvbuf, count, dt, world_of(c, me - 1), tag,
                    c.cid_coll);
      if (rc) return rc;
    }
  }
  return MPI_SUCCESS;
}

int c_reduce(CommObj &c, const void *sendbuf, void *recvbuf, int count,
             MPI_Datatype dt, MPI_Op op, int root) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // linear with rank-ordered combine (coll/basic shape): correct for
  // non-commutative user expectations, O(p) small messages at root
  DtView v;
  if (!resolve_dtype(dt, v) || v.derived) return MPI_ERR_TYPE;
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E04;
  size_t nbytes = (size_t)count * v.di.item;
  if (me != root)
    return raw_send(sendbuf, count, dt, world_of(c, root), tag,
                    c.cid_coll);
  std::vector<char> acc(nbytes), contrib(nbytes);
  for (int r = 0; r < n; r++) {
    const char *part;
    if (r == me) {
      part = (const char *)sendbuf;
    } else {
      int rc = raw_recv(contrib.data(), count, dt, world_of(c, r), tag,
                        c.cid_coll, nullptr);
      if (rc) return rc;
      part = contrib.data();
    }
    if (r == 0) {
      memcpy(acc.data(), part, nbytes);
    } else {
      int rc = reduce_buf(acc.data(), part, count, dt, op);
      if (rc) return rc;
    }
  }
  memcpy(recvbuf, acc.data(), nbytes);
  return MPI_SUCCESS;
}

int c_gather(CommObj &c, const void *sendbuf, int sendcount,
             MPI_Datatype sendtype, void *recvbuf, int recvcount,
             MPI_Datatype recvtype, int root) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // linear (coll_base_gather.c:41's basic shape)
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E05;
  if (me != root)
    return raw_send(sendbuf, sendcount, sendtype, world_of(c, root), tag,
                    c.cid_coll);
  DtView rv;
  if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
  size_t slot = slot_bytes(rv, recvcount);
  for (int r = 0; r < n; r++) {
    char *dst = (char *)recvbuf + (size_t)r * slot;
    if (r == me) {
      DtView sv;
      if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
      std::vector<char> packed;
      pack_dtype(sendbuf, sendcount, sv, packed);
      unpack_dtype(dst, recvcount, rv, packed.data(), packed.size());
    } else {
      int rc = raw_recv(dst, recvcount, recvtype, world_of(c, r), tag,
                        c.cid_coll, nullptr);
      if (rc) return rc;
    }
  }
  return MPI_SUCCESS;
}

int c_scatter(CommObj &c, const void *sendbuf, int sendcount,
              MPI_Datatype sendtype, void *recvbuf, int recvcount,
              MPI_Datatype recvtype, int root) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // linear (coll_base_scatter.c's basic shape)
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E06;
  if (me != root)
    return raw_recv(recvbuf, recvcount, recvtype, world_of(c, root), tag,
                    c.cid_coll, nullptr);
  DtView sv;
  if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
  size_t slot = slot_bytes(sv, sendcount);
  for (int r = 0; r < n; r++) {
    const char *src = (const char *)sendbuf + (size_t)r * slot;
    if (r == me) {
      DtView rv;
      if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
      std::vector<char> packed;
      pack_dtype(src, sendcount, sv, packed);
      unpack_dtype(recvbuf, recvcount, rv, packed.data(), packed.size());
    } else {
      int rc = raw_send(src, sendcount, sendtype, world_of(c, r), tag,
                        c.cid_coll);
      if (rc) return rc;
    }
  }
  return MPI_SUCCESS;
}

int c_allgather(CommObj &c, const void *sendbuf, int sendcount,
                MPI_Datatype sendtype, void *recvbuf, int recvcount,
                MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // ring (coll_base_allgather.c:358 shape): n-1 rounds of pass-along
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E07;
  DtView rv;
  if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
  size_t slot = slot_bytes(rv, recvcount);
  // place own contribution
  DtView sv;
  if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
  std::vector<char> packed;
  pack_dtype(sendbuf, sendcount, sv, packed);
  unpack_dtype((char *)recvbuf + (size_t)me * slot, recvcount, rv,
               packed.data(), packed.size());
  int right = (me + 1) % n, left = (me - 1 + n) % n;
  for (int round = 0; round < n - 1; round++) {
    int send_block = (me - round + n) % n;
    int recv_block = (me - round - 1 + n) % n;
    // eager sends are buffered by the drain threads, so the ring cannot
    // deadlock even though every rank sends before receiving
    int rc = raw_send((char *)recvbuf + (size_t)send_block * slot,
                      recvcount, recvtype, world_of(c, right), tag,
                      c.cid_coll);
    if (rc) return rc;
    rc = raw_recv((char *)recvbuf + (size_t)recv_block * slot, recvcount,
                  recvtype, world_of(c, left), tag, c.cid_coll, nullptr);
    if (rc) return rc;
  }
  return MPI_SUCCESS;
}

int c_alltoall(CommObj &c, const void *sendbuf, int sendcount,
               MPI_Datatype sendtype, void *recvbuf, int recvcount,
               MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // pairwise exchange (coll_base_alltoall.c:132 shape); distinct tag
  // per round keeps matching unambiguous
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E08;
  DtView sv, rv;
  if (!resolve_dtype(sendtype, sv) || !resolve_dtype(recvtype, rv))
    return MPI_ERR_TYPE;
  size_t sslot = slot_bytes(sv, sendcount);
  size_t rslot = slot_bytes(rv, recvcount);
  // self block
  {
    std::vector<char> packed;
    pack_dtype((const char *)sendbuf + (size_t)me * sslot, sendcount, sv,
               packed);
    unpack_dtype((char *)recvbuf + (size_t)me * rslot, recvcount, rv,
                 packed.data(), packed.size());
  }
  for (int k = 1; k < n; k++) {
    int to = (me + k) % n, from = (me - k + n) % n;
    int rc = raw_send((const char *)sendbuf + (size_t)to * sslot,
                      sendcount, sendtype, world_of(c, to), tag,
                      c.cid_coll);
    if (rc) return rc;
    rc = raw_recv((char *)recvbuf + (size_t)from * rslot, recvcount,
                  recvtype, world_of(c, from), tag, c.cid_coll, nullptr);
    if (rc) return rc;
  }
  return MPI_SUCCESS;
}

int c_scan(CommObj &c, const void *sendbuf, void *recvbuf, int count,
           MPI_Datatype dt, MPI_Op op, bool exclusive) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // linear chain (coll_base_scan.c:35 / coll_base_exscan.c:35): rank r
  // receives the prefix of ranks < r, combines in rank order, forwards
  DtView v;
  if (!resolve_dtype(dt, v) || v.derived) return MPI_ERR_TYPE;
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E09;
  size_t nbytes = (size_t)count * v.di.item;
  std::vector<char> acc(nbytes);
  if (me == 0) {
    if (!exclusive) memcpy(recvbuf, sendbuf, nbytes);
    memcpy(acc.data(), sendbuf, nbytes);
  } else {
    int rc = raw_recv(acc.data(), count, dt, world_of(c, me - 1), tag,
                      c.cid_coll, nullptr);
    if (rc) return rc;
    if (exclusive) {
      memcpy(recvbuf, acc.data(), nbytes);  // prefix of ranks < me
      int rc2 = reduce_buf(acc.data(), sendbuf, count, dt, op);
      if (rc2) return rc2;
    } else {
      int rc2 = reduce_buf(acc.data(), sendbuf, count, dt, op);
      if (rc2) return rc2;
      memcpy(recvbuf, acc.data(), nbytes);
    }
  }
  if (me + 1 < n) {
    // acc holds the inclusive prefix of ranks <= me (for rank 0 in the
    // exclusive form: just its own value) — the next rank's prefix
    int rc = raw_send(acc.data(), count, dt, world_of(c, me + 1), tag,
                      c.cid_coll);
    if (rc) return rc;
  }
  return MPI_SUCCESS;
}

int c_gatherv(CommObj &c, const void *sendbuf, int sendcount,
              MPI_Datatype sendtype, void *recvbuf, const int recvcounts[],
              const int displs[], MPI_Datatype recvtype, int root) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // linear with per-rank counts/displacements (displs in recvtype
  // extent units, the MPI contract)
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E0A;
  if (me != root)
    return raw_send(sendbuf, sendcount, sendtype, world_of(c, root), tag,
                    c.cid_coll);
  DtView rv;
  if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
  size_t unit = slot_bytes(rv, 1);
  for (int r = 0; r < n; r++) {
    char *dst = (char *)recvbuf + (size_t)displs[r] * unit;
    if (r == me) {
      DtView sv;
      if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
      std::vector<char> packed;
      pack_dtype(sendbuf, sendcount, sv, packed);
      unpack_dtype(dst, recvcounts[r], rv, packed.data(), packed.size());
    } else {
      int rc = raw_recv(dst, recvcounts[r], recvtype, world_of(c, r), tag,
                        c.cid_coll, nullptr);
      if (rc) return rc;
    }
  }
  return MPI_SUCCESS;
}

int c_scatterv(CommObj &c, const void *sendbuf, const int sendcounts[],
               const int displs[], MPI_Datatype sendtype, void *recvbuf,
               int recvcount, MPI_Datatype recvtype, int root) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  int n = (int)c.group.size(), me = c.local_rank;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E0B;
  if (me != root)
    return raw_recv(recvbuf, recvcount, recvtype, world_of(c, root), tag,
                    c.cid_coll, nullptr);
  DtView sv;
  if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
  size_t unit = slot_bytes(sv, 1);
  for (int r = 0; r < n; r++) {
    const char *blk = (const char *)sendbuf + (size_t)displs[r] * unit;
    if (r == me) {
      DtView rv;
      if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
      std::vector<char> packed;
      pack_dtype(blk, sendcounts[r], sv, packed);
      unpack_dtype(recvbuf, recvcount, rv, packed.data(), packed.size());
    } else {
      int rc = raw_send(blk, sendcounts[r], sendtype, world_of(c, r), tag,
                        c.cid_coll);
      if (rc) return rc;
    }
  }
  return MPI_SUCCESS;
}

int c_allgatherv(CommObj &c, const void *sendbuf, int sendcount,
                 MPI_Datatype sendtype, void *recvbuf,
                 const int recvcounts[], const int displs[],
                 MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // n rooted broadcasts of each rank's block into the (identical)
  // recv layout — simple and displacement-safe (gaps never touched)
  int n = (int)c.group.size(), me = c.local_rank;
  DtView rv;
  if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
  size_t unit = slot_bytes(rv, 1);
  // own contribution into own block first
  {
    DtView sv;
    if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
    std::vector<char> packed;
    pack_dtype(sendbuf, sendcount, sv, packed);
    unpack_dtype((char *)recvbuf + (size_t)displs[me] * unit,
                 recvcounts[me], rv, packed.data(), packed.size());
  }
  for (int r = 0; r < n; r++) {
    int rc = c_bcast(c, (char *)recvbuf + (size_t)displs[r] * unit,
                     recvcounts[r], recvtype, r, 0x7E0C);
    if (rc) return rc;
  }
  return MPI_SUCCESS;
}

int c_reduce_scatter(CommObj &c, const void *sendbuf, void *recvbuf,
                     const int recvcounts[], MPI_Datatype dt, MPI_Op op);

int c_reduce_scatter_block(CommObj &c, const void *sendbuf, void *recvbuf,
                           int recvcount, MPI_Datatype dt, MPI_Op op) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // the uniform-counts case of the ragged form (same 2 coll_seq slots)
  std::vector<int> counts(c.group.size(), recvcount);
  return c_reduce_scatter(c, sendbuf, recvbuf, counts.data(), dt, op);
}

int c_reduce_scatter(CommObj &c, const void *sendbuf, void *recvbuf,
                     const int recvcounts[], MPI_Datatype dt, MPI_Op op) {
  // reduce_scatter.c's ragged form: full reduce at 0, then scatterv of
  // the per-rank slices (coll/basic's composition)
  DtView v;
  if (!resolve_dtype(dt, v) || v.derived) return MPI_ERR_TYPE;
  int n = (int)c.group.size();
  int64_t total = 0;
  std::vector<int> displs(n);
  for (int r = 0; r < n; r++) {
    if (recvcounts[r] < 0) return MPI_ERR_ARG;
    displs[r] = (int)total;
    total += recvcounts[r];
  }
  if (total * (int64_t)v.di.item > 0x7FFFFFFFll) return MPI_ERR_COUNT;
  // only the root touches the full reduction (the rsb helper's shape)
  std::vector<char> full(
      c.local_rank == 0 ? (size_t)total * v.di.item : 0);
  int rc = c_reduce(c, sendbuf, full.data(), (int)total, dt, op, 0);
  if (rc != MPI_SUCCESS) return rc;
  return c_scatterv(c, full.data(), recvcounts, displs.data(), dt,
                    recvbuf, recvcounts[c.local_rank], dt, 0);
}

int c_alltoallv(CommObj &c, const void *sendbuf, const int sendcounts[],
                const int sdispls[], MPI_Datatype sendtype, void *recvbuf,
                const int recvcounts[], const int rdispls[],
                MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  // alltoallv.c: ragged pairwise exchange — one message per ordered
  // pair under one reserved tag; receives post first, sends are eager
  DtView sv, rv;
  if (!resolve_dtype(sendtype, sv) || !resolve_dtype(recvtype, rv))
    return MPI_ERR_TYPE;
  int n = (int)c.group.size(), me = c.local_rank;
  for (int r = 0; r < n; r++)
    if (sendcounts[r] < 0 || recvcounts[r] < 0 || sdispls[r] < 0 ||
        rdispls[r] < 0)
      return MPI_ERR_ARG;
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E11;
  size_t sstride = slot_bytes(sv, 1), rstride = slot_bytes(rv, 1);
  std::vector<Req> reqs(n);
  std::vector<int> handles(n, -1);
  auto abort_all = [&](int err) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < n; i++)
      if (handles[i] >= 0) deregister_locked(handles[i], &reqs[i]);
    return err;
  };
  for (int r = 0; r < n; r++) {
    if (r == me || recvcounts[r] == 0) continue;
    reqs[r].is_recv = true;
    reqs[r].user_buf = (char *)recvbuf + (size_t)rdispls[r] * rstride;
    reqs[r].count = recvcounts[r];
    handles[r] = post_recv(&reqs[r], rv, c.cid_coll, world_of(c, r),
                           tag);
  }
  for (int r = 0; r < n; r++) {
    if (r == me || sendcounts[r] == 0) continue;
    int rc = raw_send((const char *)sendbuf + (size_t)sdispls[r] * sstride,
                      sendcounts[r], sendtype, world_of(c, r), tag,
                      c.cid_coll);
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  // self block: straight pack/unpack through the convertor
  if (sendcounts[me] > 0 || recvcounts[me] > 0) {
    std::vector<char> packed;
    pack_dtype((const char *)sendbuf + (size_t)sdispls[me] * sstride,
               sendcounts[me], sv, packed);
    unpack_dtype((char *)recvbuf + (size_t)rdispls[me] * rstride,
                 recvcounts[me], rv, packed.data(), packed.size());
  }
  for (int r = 0; r < n; r++) {
    if (handles[r] < 0) continue;
    int rc = wait_handle(handles[r], nullptr);
    handles[r] = -1;
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  return MPI_SUCCESS;
}

int c_alltoallw(CommObj &c, const void *sendbuf, const int sendcounts[],
                const int sdispls[], const MPI_Datatype sendtypes[],
                void *recvbuf, const int recvcounts[],
                const int rdispls[], const MPI_Datatype recvtypes[]) {
  // alltoallw.c: the fully general exchange — per-peer datatypes and
  // BYTE displacements (the one collective whose displacements are not
  // scaled by an extent, MPI-3.1 §5.8)
  if (!c.remote.empty()) return MPI_ERR_COMM;
  int n = (int)c.group.size(), me = c.local_rank;
  std::vector<DtView> sv((size_t)n), rv((size_t)n);
  for (int r = 0; r < n; r++) {
    if (sendcounts[r] < 0 || recvcounts[r] < 0 || sdispls[r] < 0 ||
        rdispls[r] < 0)
      return MPI_ERR_ARG;
    if (sendcounts[r] > 0 &&
        !resolve_dtype(sendtypes[r], sv[(size_t)r]))
      return MPI_ERR_TYPE;
    if (recvcounts[r] > 0 &&
        !resolve_dtype(recvtypes[r], rv[(size_t)r]))
      return MPI_ERR_TYPE;
  }
  int64_t tag = (c.coll_seq++ % 0x8000) << 16 | 0x7E12;
  std::vector<Req> reqs((size_t)n);
  std::vector<int> handles((size_t)n, -1);
  auto abort_all = [&](int err) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < n; i++)
      if (handles[(size_t)i] >= 0)
        deregister_locked(handles[(size_t)i], &reqs[(size_t)i]);
    return err;
  };
  for (int r = 0; r < n; r++) {
    if (r == me || recvcounts[r] == 0) continue;
    reqs[(size_t)r].is_recv = true;
    reqs[(size_t)r].user_buf = (char *)recvbuf + (size_t)rdispls[r];
    reqs[(size_t)r].count = recvcounts[r];
    handles[(size_t)r] = post_recv(&reqs[(size_t)r], rv[(size_t)r],
                                   c.cid_coll, world_of(c, r), tag);
  }
  for (int r = 0; r < n; r++) {
    if (r == me || sendcounts[r] == 0) continue;
    int rc = raw_send((const char *)sendbuf + (size_t)sdispls[r],
                      sendcounts[r], sendtypes[r], world_of(c, r), tag,
                      c.cid_coll);
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  if (sendcounts[me] > 0 && recvcounts[me] > 0) {
    std::vector<char> packed;
    pack_dtype((const char *)sendbuf + (size_t)sdispls[me],
               sendcounts[me], sv[(size_t)me], packed);
    unpack_dtype((char *)recvbuf + (size_t)rdispls[me], recvcounts[me],
                 rv[(size_t)me], packed.data(), packed.size());
  }
  for (int r = 0; r < n; r++) {
    if (handles[(size_t)r] < 0) continue;
    int rc = wait_handle(handles[(size_t)r], nullptr);
    handles[(size_t)r] = -1;
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  return MPI_SUCCESS;
}

}  // namespace

// ----------------------------------------------- error handlers core
// comm_create_errhandler.c family.  The comm plane dispatches through
// the installed handler at the pt2pt/collective entry points; win and
// file carry the full surface (create/set/get/call) with their MPI
// defaults (windows: ARE_FATAL, files: ERRORS_RETURN).

struct ErrhObj {
  int kind;  // 0 comm, 1 win, 2 file
  void *fn;
  // MPI-3.1 8.3.4: a freed handler stays in effect while any object
  // still references it; the object tables below hold the references
  bool freed = false;
};
std::map<int, ErrhObj> g_errhandlers;
int g_next_errh = 0x10;  // 0 = ARE_FATAL, 1 = ERRORS_RETURN
std::map<int, int> g_comm_errh, g_win_errh, g_file_errh;

bool errh_referenced(int h) {
  for (auto &e : g_comm_errh)
    if (e.second == h) return true;
  for (auto &e : g_win_errh)
    if (e.second == h) return true;
  for (auto &e : g_file_errh)
    if (e.second == h) return true;
  return false;
}

void reap_errh(int h) {
  if (h < 0x10) return;
  auto it = g_errhandlers.find(h);
  if (it != g_errhandlers.end() && it->second.freed &&
      !errh_referenced(h))
    g_errhandlers.erase(it);
}

// drop an object's handler reference (object free/close paths)
void release_errh_ref(std::map<int, int> &table, int handle) {
  auto it = table.find(handle);
  if (it == table.end()) return;
  int h = it->second;
  table.erase(it);
  reap_errh(h);
}

// a handler id is settable iff predefined or a live entry of `kind`
bool valid_errh(int h, int kind) {
  if (h == 0 /*ARE_FATAL*/ || h == 1 /*ERRORS_RETURN*/) return true;
  auto it = g_errhandlers.find(h);
  return it != g_errhandlers.end() && !it->second.freed &&
         it->second.kind == kind;
}

int errh_of_comm(int comm) {
  auto it = g_comm_errh.find(comm);
  if (it != g_comm_errh.end()) return it->second;
  // unset comms fall back to WORLD's handler (the reference inherits
  // from the parent at creation; the WORLD fallback reaches the same
  // observable behavior for the common set-on-WORLD idiom)
  it = g_comm_errh.find(0 /* MPI_COMM_WORLD */);
  return it != g_comm_errh.end() ? it->second : 0 /* ARE_FATAL */;
}

// defined after the ABI (needs MPI_Error_string); the definition sits
// inside the extern "C" block, so the declaration matches that linkage
extern "C" int dispatch_comm_err(int comm, int code);

// ----------------------------------------------- PMIx store client
// A zmpirun --dvm job modexes through the resident daemon's PMIx
// store (runtime/pmix.py) instead of a per-job coordinator: 4-byte
// length-framed dss.pack([op, *args]) requests, ["ok", value] /
// ["err", message] replies.  C ranks speak the same verbs the Python
// plane's _modex_pmix uses (mkns/put/commit/fence/get), so mixed
// C/Python jobs share one store-served wire-up — and on a DVM tree
// the address in ZMPI_PMIX is THIS host's daemon, whose routed store
// forwards writes up and serves gets from its leaf cache.

void pmix_req(std::string &f, const char *op, size_t argc) {
  put_varint(f, 1);            // dss.pack of ONE value: the request
  f.push_back((char)T_LIST);
  put_varint(f, argc + 1);     // [op, *args]
  put_str(f, op);
}

bool pmix_call(int fd, const std::string &req, DssVal &out,
               std::string &err) {
  if (!send_frame(fd, req)) {
    err = "request send failed";
    return false;
  }
  std::string reply;
  if (!recv_frame(fd, reply)) {
    err = "store connection lost";
    return false;
  }
  std::vector<DssVal> vals;
  if (!parse_all(reply, vals) || vals.size() != 1 ||
      vals[0].tag != T_LIST || vals[0].items.size() != 2 ||
      vals[0].items[0].tag != T_STR) {
    err = "malformed reply";
    return false;
  }
  if (vals[0].items[0].s != "ok") {
    err = vals[0].items[1].s;
    return false;
  }
  out = vals[0].items[1];
  return true;
}

// the ZMPI_LIFELINE contract (runtime/dvm.py): one connection parked
// on the host daemon's control port for this process's whole life —
// the daemon never replies, EOF means the daemon died, and a rank
// must not outlive the daemon that owns its store, fault routing, and
// exit accounting (the PRRTE local-procs-die-with-their-prted
// contract).  Exit 143 mirrors the SIGTERM teardown the daemon itself
// would have applied.  No farewell on stderr: that IS the dead
// daemon's IOF pipe.
void arm_lifeline(const char *address) {
  std::string addr = address;
  size_t colon = addr.rfind(':');
  if (colon == std::string::npos) return;
  int fd = tcp_connect(addr.substr(0, colon),
                       atoi(addr.c_str() + colon + 1));
  if (fd < 0) _exit(143);  // daemon already gone: a teardown race
  std::string f;
  put_varint(f, 1);
  f.push_back((char)T_LIST);
  put_varint(f, 1);
  put_str(f, "lifeline");
  if (!send_frame(fd, f)) _exit(143);
  std::thread([fd] {
    std::string frame;
    while (recv_frame(fd, frame)) {
    }
    _exit(143);
  }).detach();
}

// The store-served modex (tcp.py _modex_pmix, C side): publish this
// rank's card, fence the namespace, read every peer's card into the
// book.  uri = "host:port/ns" (the ZMPI_PMIX contract).
bool pmix_modex(const char *uri_c) {
  std::string uri = uri_c;
  size_t slash = uri.rfind('/');
  size_t colon = slash == std::string::npos
                     ? std::string::npos
                     : uri.rfind(':', slash);
  if (slash == std::string::npos || colon == std::string::npos) {
    fprintf(stderr, "zompi: malformed ZMPI_PMIX '%s' "
                    "(want host:port/ns)\n", uri_c);
    return false;
  }
  std::string host = uri.substr(0, colon);
  int port = atoi(uri.substr(colon + 1, slash - colon - 1).c_str());
  std::string ns = uri.substr(slash + 1);
  const double timeout = 30.0;  // the Python plane's host_init default
  int fd = tcp_connect(host, port);
  if (fd < 0) {
    fprintf(stderr, "zompi: no PMIx store at %s:%d\n",
            host.c_str(), port);
    return false;
  }
  DssVal out;
  std::string err, f;
  bool ok = true;
  // mkns is idempotent — the daemon created the job's namespace at
  // launch; this call just asserts the size contract
  pmix_req(f, "mkns", 2);
  put_str(f, ns);
  put_int(f, g.size);
  ok = pmix_call(fd, f, out, err);
  if (ok) {
    // card:<rank> = [host, port(, "sm")] — same capability shape the
    // coordinator modex sends (sm: this rank maps same-host rings)
    f.clear();
    pmix_req(f, "put", 4);
    put_str(f, ns);
    put_int(f, g.rank);
    put_str(f, "card:" + std::to_string(g.rank));
    bool sm = sm_enabled();
    f.push_back((char)T_LIST);
    put_varint(f, sm ? 3 : 2);
    put_str(f, g.host);
    put_int(f, g.listen_port);
    if (sm) put_str(f, "sm");
    ok = pmix_call(fd, f, out, err);
  }
  if (ok) {
    f.clear();
    pmix_req(f, "commit", 2);
    put_str(f, ns);
    put_int(f, g.rank);
    ok = pmix_call(fd, f, out, err);
  }
  if (ok) {
    // the modex barrier: parks until every rank of the namespace
    // committed (the store's fence verb)
    f.clear();
    pmix_req(f, "fence", 3);
    put_str(f, ns);
    put_int(f, g.rank);
    put_float(f, timeout);
    ok = pmix_call(fd, f, out, err);
  }
  if (ok) {
    g.book.assign(g.size, {"", 0});
    g.caps.assign(g.size, "");
    for (int r = 0; r < g.size && ok; r++) {
      f.clear();
      pmix_req(f, "get", 4);
      put_str(f, ns);
      put_str(f, "card:" + std::to_string(r));
      put_float(f, timeout);
      put_int(f, 0);  // min_generation: launch cards are gen 0
      ok = pmix_call(fd, f, out, err);
      // reply value = [card, generation]; card = [host, port, caps...]
      if (ok && (out.tag != T_LIST || out.items.size() < 2 ||
                 out.items[0].tag != T_LIST ||
                 out.items[0].items.size() < 2)) {
        err = "malformed card for rank " + std::to_string(r);
        ok = false;
      }
      if (ok) {
        DssVal &card = out.items[0];
        g.book[r] = {card.items[0].s, (int)card.items[1].i};
        if (card.items.size() >= 3 && card.items[2].tag == T_STR)
          g.caps[r] = card.items[2].s;
      }
    }
  }
  close(fd);
  if (!ok)
    fprintf(stderr, "zompi: pmix modex via %s:%d/%s failed: %s\n",
            host.c_str(), port, ns.c_str(), err.c_str());
  return ok;
}

// ------------------------------------------------------------ C ABI

// thread-level / finalized bookkeeping (init_thread.c, finalized.c);
// definitions here so Init/Finalize can stamp them, used by the
// utilities section below
static bool g_finalized_flag = false;
static std::thread::id g_main_tid;
static int g_thread_level = 0;  // MPI_THREAD_SINGLE

extern "C" {

// the MPI_IN_PLACE sentinel (never dereferenced; identity by address)
char zompi_in_place_[1];

int MPI_Init(int *, char ***) {
  if (g.initialized) return MPI_ERR_OTHER;
  g_main_tid = std::this_thread::get_id();
  g_thread_level = 0;
  const char *r = getenv("ZMPI_RANK");
  const char *s = getenv("ZMPI_SIZE");
  const char *ch = getenv("ZMPI_COORD_HOST");
  const char *cp = getenv("ZMPI_COORD_PORT");
  // a zmpirun --dvm job carries no coordinator at all: the resident
  // daemon's PMIx store serves the modex (ZMPI_PMIX = host:port/ns)
  const char *px = getenv("ZMPI_PMIX");
  bool dvm_store = px && px[0];
  if (!r || !s || (!dvm_store && (!ch || !cp))) {
    fprintf(stderr, "zompi: ZMPI_RANK/SIZE plus ZMPI_COORD_HOST/PORT "
                    "(or ZMPI_PMIX) unset\n");
    return MPI_ERR_OTHER;
  }
  g.rank = atoi(r);
  g.size = atoi(s);
  std::string coord_host = ch ? ch : "";
  int coord_port = cp ? atoi(cp) : 0;
  // same MCA var (and default) as the Python plane's protocol switch
  const char *el = getenv("ZMPI_MCA_tcp_eager_limit");
  if (el && el[0]) g.eager_limit = atoll(el);
  const char *ct = getenv("ZMPI_MCA_rndv_cts_timeout");
  if (ct && ct[0]) g.cts_timeout = atof(ct);

  // listener (btl_tcp's per-proc endpoint)
  g.listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  set_cloexec(g.listen_fd);
  int one = 1;
  setsockopt(g.listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = 0;
  inet_pton(AF_INET, g.host.c_str(), &a.sin_addr);
  if (bind(g.listen_fd, (sockaddr *)&a, sizeof a) != 0) return MPI_ERR_OTHER;
  socklen_t alen = sizeof a;
  getsockname(g.listen_fd, (sockaddr *)&a, &alen);
  g.listen_port = ntohs(a.sin_port);
  listen(g.listen_fd, g.size + 4);
  g.accept_thread = std::thread(accept_loop);

  // modex (tcp.py _modex wire protocol).  ZMPI_COORD_EXTERNAL=1 means a
  // launcher (zmpirun) hosts the rendezvous and EVERY rank — including
  // rank 0 — joins as a client.
  const char *ext = getenv("ZMPI_COORD_EXTERNAL");
  bool external_coord = ext && ext[0] == '1';
  if (dvm_store) {
    // store-served modex (the --dvm shape): every rank is a store
    // client; the daemon hosting this rank holds (or leaf-caches) the
    // whole job's cards.  The lifeline then ties this process's life
    // to its daemon's.
    if (!pmix_modex(px)) return MPI_ERR_OTHER;
    const char *ll = getenv("ZMPI_LIFELINE");
    if (ll && ll[0]) arm_lifeline(ll);
  } else if (g.rank == 0 && !external_coord) {
    int srv = socket(AF_INET, SOCK_STREAM, 0);
    setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in ca{};
    ca.sin_family = AF_INET;
    ca.sin_port = htons((uint16_t)coord_port);
    inet_pton(AF_INET, coord_host.c_str(), &ca.sin_addr);
    if (bind(srv, (sockaddr *)&ca, sizeof ca) != 0) return MPI_ERR_OTHER;
    listen(srv, g.size + 4);
    g.book.assign(g.size, {"", 0});
    g.caps.assign(g.size, "");
    g.book[0] = {g.host, g.listen_port};
    if (sm_enabled()) g.caps[0] = "sm";
    std::vector<int> peers;
    for (int i = 0; i < g.size - 1; i++) {
      int c = accept(srv, nullptr, nullptr);
      std::string f;
      if (!recv_frame(c, f)) return MPI_ERR_OTHER;
      std::vector<DssVal> vals;
      if (!parse_all(f, vals) || vals.size() != 2) return MPI_ERR_OTHER;
      int peer = (int)vals[0].i;
      if (vals[1].items.size() < 2) return MPI_ERR_OTHER;
      g.book[peer] = {vals[1].items[0].s, (int)vals[1].items[1].i};
      // optional third card item: capability string (Python ranks
      // send 2-item cards and get "" — never routed to rings)
      if (vals[1].items.size() >= 3) g.caps[peer] = vals[1].items[2].s;
      peers.push_back(c);
    }
    std::string reply = pack_address_book(g.book, &g.caps);
    for (int c : peers) {
      send_frame(c, reply);
      close(c);
    }
    close(srv);
  } else {
    int c = tcp_connect(coord_host, coord_port);
    if (c < 0) return MPI_ERR_OTHER;
    std::string f;
    put_varint(f, 2);
    put_int(f, g.rank);
    f.push_back((char)T_LIST);
    bool sm = sm_enabled();
    put_varint(f, sm ? 3 : 2);
    put_str(f, g.host);
    put_int(f, g.listen_port);
    if (sm) put_str(f, "sm");  // this rank maps same-host rings
    if (!send_frame(c, f)) return MPI_ERR_OTHER;
    std::string reply;
    if (!recv_frame(c, reply)) return MPI_ERR_OTHER;
    close(c);
    std::vector<DssVal> vals;
    if (!parse_all(reply, vals) || vals.size() != 1) return MPI_ERR_OTHER;
    g.book.clear();
    g.caps.clear();
    for (auto &e : vals[0].items) {
      if (e.items.size() < 2) return MPI_ERR_OTHER;
      g.book.push_back({e.items[0].s, (int)e.items[1].i});
      g.caps.push_back(e.items.size() >= 3 ? e.items[2].s
                                           : std::string());
    }
  }

  // endpoint() reads g.book unlocked from several threads; reserving
  // once caps the universe (init ranks + spawned children) at BOOK_CAP
  // and guarantees spawn's push_back never reallocates under a reader
  g.book.reserve(Shim::BOOK_CAP);
  g.caps.resize(g.book.size(), "");
  g.caps.reserve(Shim::BOOK_CAP);

  // predefined communicators.  WORLD keeps the round-3 wire cids for
  // Python interop; SELF's context never leaves the process.
  g_comms.clear();
  g_next_comm = 2;
  CommObj world;
  const char *wb = getenv("ZMPI_WORLD_BASE");
  if (wb && wb[0]) {
    // SPAWNED process (comm_spawn.c's child side): the universe book
    // spans parent + children, but MPI_COMM_WORLD is the CHILDREN only
    // — a contiguous id block at `base`, with context ids the spawner
    // chose (so parent WORLD traffic and child WORLD traffic never
    // share a context)
    int base = atoi(wb);
    int wsize = atoi(getenv("ZMPI_WORLD_SIZE"));
    int64_t scid = atoll(getenv("ZMPI_SPAWN_CID"));
    world.group.resize(wsize);
    for (int i = 0; i < wsize; i++) world.group[i] = base + i;
    world.local_rank = g.rank - base;
    world.cid_pt2pt = scid + 3;  // the spawn intercomm owns scid..+2
    world.cid_coll = scid + 4;
    world.cid_bar = scid + 5;
  } else {
    world.group.resize(g.size);
    for (int i = 0; i < g.size; i++) world.group[i] = i;
    world.local_rank = g.rank;
    world.cid_pt2pt = 0;
    world.cid_coll = 0x7FFC;
    world.cid_bar = 0x7FFD;
  }
  g_comms[MPI_COMM_WORLD] = world;
  CommObj self;
  self.group = {g.rank};
  self.local_rank = 0;
  self.cid_pt2pt = 0x7F00;
  self.cid_coll = 0x7F01;
  self.cid_bar = 0x7F02;
  g_comms[MPI_COMM_SELF] = self;

  // same-host shared-memory transport for this init cohort (the
  // contiguous WORLD block that initialized together; spawn joins
  // stay TCP — see the sm design block)
  {
    int cohort_base = 0, cohort_size = g.size;
    if (wb && wb[0]) {
      cohort_base = atoi(wb);
      cohort_size = atoi(getenv("ZMPI_WORLD_SIZE"));
    }
    sm_setup(cohort_base, cohort_size);
  }

  extern void build_env_info_hook(void);
  build_env_info_hook();  // MPI_INFO_ENV startup snapshot (10.5.3)

  g.initialized = true;
  return MPI_SUCCESS;
}

int MPI_Initialized(int *flag) {
  *flag = g.initialized ? 1 : 0;
  return MPI_SUCCESS;
}

void finalize_attr_sweep(void);  // defined with the attribute machinery
void reap_spawned(void);         // defined with the spawn machinery

int MPI_Finalize(void) {
  reap_spawned();
  // Attribute delete callbacks fire for EVERY comm that still carries
  // attributes — including WORLD/SELF, the canonical library
  // finalize-hook idiom (MPI-3.1 §8.7.1 requires these deletions)
  finalize_attr_sweep();
  // Tear down without an implicit barrier: MPI allows but does not
  // require Finalize to synchronize, and an implicit barrier would
  // deadlock mixed C/Python jobs whose Python endpoints close() without
  // one.  Programs needing quiescence call MPI_Barrier themselves (the
  // examples do).
  g.closing.store(true);
  // shutdown -> join -> close: drain threads are blocked in recv on
  // these fds; shutdown delivers EOF on the still-valid descriptor, the
  // join guarantees no reader is parked on the fd when it is freed, and
  // only then is the descriptor closed (fd-reuse byte-stealing guard,
  // same discipline as the Python plane's close)
  shutdown(g.listen_fd, SHUT_RDWR);
  // join the accept loop FIRST: after it exits, no new drain can be
  // started, so the drain_fds sweep below cannot miss a late-accepted
  // connection and the threads vector can no longer be mutated under us
  if (g.accept_thread.joinable()) g.accept_thread.join();
  // correct programs have Wait-ed every send request, so inflight
  // rendezvous pushers are in their last few instructions; give them a
  // moment rather than racing their g accesses
  for (int i = 0; i < 500 && g.inflight_isends.load() > 0; i++)
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  {
    // close our cached bulk-send connections: the peers' bulk drains
    // see EOF and self-close (no local reader ever holds these fds)
    std::lock_guard<std::mutex> lk(g.bulk_mu);
    for (auto &e : g.bulk_conns) close(e.second);
    g.bulk_conns.clear();
  }
  {
    std::lock_guard<std::mutex> lk(g.threads_mu);
    for (int fd : g.drain_fds) shutdown(fd, SHUT_RDWR);
    // transient bulk drains self-close; only unblock them here
    for (int fd : g.bulk_fds) shutdown(fd, SHUT_RDWR);
  }
  // index-snapshot join: a drain processing a late RTS can still create
  // a connection (endpoint -> start_drain appends under threads_mu), so
  // the vector may grow while we join — never iterate it unlocked
  for (size_t i = 0;;) {
    std::thread t;
    {
      std::lock_guard<std::mutex> lk(g.threads_mu);
      if (i >= g.threads.size()) break;
      t = std::move(g.threads[i]);
      ++i;
    }
    if (t.joinable()) t.join();
  }
  close(g.listen_fd);
  // late-started drains were shut down by the closing guard in
  // start_drain; sweep whatever registered before the guard flipped
  {
    std::lock_guard<std::mutex> lk(g.threads_mu);
    for (int fd : g.drain_fds) close(fd);
    g.drain_fds.clear();
    g.threads.clear();
  }
  // wait for self-closing bulk drains: both the registered list and the
  // in-flight closes must drain before the application may reuse fd
  // numbers.  Shutdown already unblocked every reader, so this is
  // scheduler latency, not network time; warn if it somehow exceeds 10s.
  bool drained = false;
  for (int i = 0; i < 1000 && !drained; i++) {
    {
      std::lock_guard<std::mutex> lk(g.threads_mu);
      drained = g.bulk_fds.empty() && g.bulk_closing.load() == 0;
    }
    if (!drained)
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  if (!drained)
    fprintf(stderr,
            "zompi: warning: bulk-data drains still closing at "
            "MPI_Finalize exit\n");
  sm_teardown();  // poll thread saw g.closing; unmap + unlink rings
  {
    std::lock_guard<std::mutex> lk(g.conn_mu);
    g.conns.clear();
  }
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    g.posted.clear();
    for (auto &kv : g.reqs)
      if (kv.second->heap) delete kv.second;  // un-waited Isend/Irecv
    g.reqs.clear();
    g.unexpected.clear();
  }
  for (auto &kv : g_files) ::close(kv.second.fd);
  g_files.clear();
  g_groups.clear();
  g_next_group = 1;
  g_comms.clear();
  g_dtypes.clear();
  g_next_dtype = DERIVED_BASE;
  extern void clear_info_naming_state(void);
  clear_info_naming_state();
  g_errhandlers.clear();
  g_next_errh = 0x10;
  g_comm_errh.clear();
  g_win_errh.clear();
  g_file_errh.clear();
  g.initialized = false;
  g_finalized_flag = true;
  return MPI_SUCCESS;
}

int MPI_Comm_rank(MPI_Comm comm, int *rank) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  *rank = c->local_rank;
  return MPI_SUCCESS;
}

int MPI_Comm_size(MPI_Comm comm, int *size) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  *size = (int)c->group.size();
  return MPI_SUCCESS;
}

int MPI_Get_processor_name(char *name, int *resultlen) {
  if (gethostname(name, MPI_MAX_PROCESSOR_NAME - 1) != 0)
    return MPI_ERR_OTHER;
  name[MPI_MAX_PROCESSOR_NAME - 1] = '\0';
  *resultlen = (int)strlen(name);
  return MPI_SUCCESS;
}

// --------------------------------------------------------- communicator

int MPI_Comm_split(MPI_Comm comm, int color, int key, MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int n = (int)c->group.size();
  // allgather (color, key) over the parent (comm_split.c:40 gathers the
  // same tuples before sorting)
  std::vector<int64_t> mine = {color, key};
  std::vector<int64_t> all(2 * (size_t)n);
  int rc = c_allgather(*c, mine.data(), 2, MPI_LONG, all.data(), 2,
                       MPI_LONG);
  if (rc) return rc;
  uint64_t salt = color == MPI_UNDEFINED ? 0 : (uint64_t)(int64_t)color;
  // members of my color, ordered by (key, parent rank)
  std::vector<std::pair<int64_t, int>> members;  // (key, parent local)
  for (int r = 0; r < n; r++)
    if (all[2 * r] == color) members.push_back({all[2 * r + 1], r});
  std::stable_sort(members.begin(), members.end());
  // every parent member advances the creation sequence identically,
  // color or not — the deterministic-cid contract
  CommObj child;
  derive_cids(*c, salt, child);
  c->child_seq++;
  if (color == MPI_UNDEFINED) {
    *newcomm = MPI_COMM_NULL;
    return MPI_SUCCESS;
  }
  for (size_t i = 0; i < members.size(); i++) {
    child.group.push_back(c->group[members[i].second]);
    if (members[i].second == c->local_rank) child.local_rank = (int)i;
  }
  int handle = g_next_comm++;
  g_comms[handle] = child;
  *newcomm = handle;
  return MPI_SUCCESS;
}

// -------------------------------------------------- attribute caching
// comm_create_keyval.c family: keyvals with copy/delete callbacks, the
// MPI library-composition mechanism (attribute/attribute.c reduced to
// two maps — the object system is absorbed by STL).

struct KeyvalObj {
  MPI_Comm_copy_attr_function *copy_fn;
  MPI_Comm_delete_attr_function *delete_fn;
  void *extra_state;
  // MPI-3.1 6.7.2: a freed keyval's callbacks stay in effect until the
  // last attribute referencing it is deleted
  bool freed = false;
};
std::map<int, KeyvalObj> g_keyvals;
int g_next_keyval = 0;
// (comm handle, keyval) -> attribute pointer
std::map<std::pair<int, int>, void *> g_attrs;

bool keyval_referenced(int keyval) {
  for (auto &e : g_attrs)
    if (e.first.second == keyval) return true;
  return false;
}

void reap_keyval(int keyval) {
  auto it = g_keyvals.find(keyval);
  if (it != g_keyvals.end() && it->second.freed &&
      !keyval_referenced(keyval))
    g_keyvals.erase(it);
}

// delete every attribute cached on `comm`, running the delete
// callbacks (comm_free.c order); shared by Comm_free, the Comm_dup
// error unwind, and the Finalize sweep
void delete_comm_attrs(int comm) {
  for (auto it = g_attrs.begin(); it != g_attrs.end();) {
    if (it->first.first == comm) {
      int kvid = it->first.second;
      auto kv = g_keyvals.find(kvid);
      if (kv != g_keyvals.end() && kv->second.delete_fn)
        kv->second.delete_fn(comm, kvid, it->second,
                             kv->second.extra_state);
      it = g_attrs.erase(it);
      reap_keyval(kvid);
    } else {
      ++it;
    }
  }
}

void finalize_attr_sweep(void) {
  // MPI-3.1 8.7.1: Finalize behaves as if MPI_COMM_FREE(COMM_SELF) is
  // executed FIRST — the finalize-hook ordering libraries rely on
  delete_comm_attrs(MPI_COMM_SELF);
  std::vector<int> with_attrs;
  for (auto &e : g_attrs)
    if (with_attrs.empty() || with_attrs.back() != e.first.first)
      with_attrs.push_back(e.first.first);
  for (int comm : with_attrs) delete_comm_attrs(comm);
}

int MPI_Comm_create_keyval(MPI_Comm_copy_attr_function *copy_fn,
                           MPI_Comm_delete_attr_function *delete_fn,
                           int *keyval, void *extra_state) {
  if (!keyval) return MPI_ERR_ARG;
  int kv = g_next_keyval++;
  g_keyvals[kv] = {copy_fn, delete_fn, extra_state};
  *keyval = kv;
  return MPI_SUCCESS;
}

int MPI_Comm_free_keyval(int *keyval) {
  if (!keyval) return MPI_ERR_ARG;
  auto it = g_keyvals.find(*keyval);
  if (it == g_keyvals.end()) return MPI_ERR_ARG;
  // callbacks stay live while attributes still reference the keyval
  it->second.freed = true;
  reap_keyval(*keyval);
  *keyval = MPI_KEYVAL_INVALID;
  return MPI_SUCCESS;
}

int MPI_Comm_set_attr(MPI_Comm comm, int keyval, void *attribute_val) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  auto kv = g_keyvals.find(keyval);
  if (kv == g_keyvals.end() || kv->second.freed) return MPI_ERR_ARG;
  auto key = std::make_pair(comm, keyval);
  auto it = g_attrs.find(key);
  if (it != g_attrs.end() && kv->second.delete_fn) {
    int rc = kv->second.delete_fn(comm, keyval, it->second,
                                  kv->second.extra_state);
    if (rc != MPI_SUCCESS) return rc;
  }
  g_attrs[key] = attribute_val;
  return MPI_SUCCESS;
}

int MPI_Comm_get_attr(MPI_Comm comm, int keyval, void *attribute_val,
                      int *flag) {
  // predefined WORLD attributes (reserved keyvals; the value cells
  // live for the process, per the attribute-pointer contract)
  static int tag_ub = 0x7FFFFFFF;       // tags are int64 on the wire
  static int host_val = MPI_PROC_NULL;  // no distinguished host proc
  static int io_val = MPI_ANY_SOURCE;   // every rank can do IO
  static int wtime_global = 0;          // steady_clock is per-process
  if (keyval >= MPI_TAG_UB && keyval <= MPI_WTIME_IS_GLOBAL) {
    if (!lookup_comm(comm)) return MPI_ERR_COMM;
    if (comm != MPI_COMM_WORLD) {
      *flag = 0;  // cached on WORLD only (attribute.c's contract)
      return MPI_SUCCESS;
    }
    *flag = 1;
    switch (keyval) {
      case MPI_TAG_UB: *(void **)attribute_val = &tag_ub; break;
      case MPI_HOST: *(void **)attribute_val = &host_val; break;
      case MPI_IO: *(void **)attribute_val = &io_val; break;
      default: *(void **)attribute_val = &wtime_global; break;
    }
    return MPI_SUCCESS;
  }

  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  auto it = g_attrs.find({comm, keyval});
  *flag = it != g_attrs.end() ? 1 : 0;
  if (*flag) *(void **)attribute_val = it->second;
  return MPI_SUCCESS;
}

int MPI_Comm_delete_attr(MPI_Comm comm, int keyval) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  auto it = g_attrs.find({comm, keyval});
  if (it == g_attrs.end()) return MPI_ERR_ARG;
  auto kv = g_keyvals.find(keyval);
  if (kv != g_keyvals.end() && kv->second.delete_fn) {
    int rc = kv->second.delete_fn(comm, keyval, it->second,
                                  kv->second.extra_state);
    if (rc != MPI_SUCCESS) return rc;
  }
  g_attrs.erase(it);
  reap_keyval(keyval);
  return MPI_SUCCESS;
}

int MPI_Comm_dup(MPI_Comm comm, MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  CommObj child;
  derive_cids(*c, 0xD0B, child);
  c->child_seq++;
  child.group = c->group;
  child.local_rank = c->local_rank;
  child.remote = c->remote;  // dup of an intercomm stays an intercomm
  int handle = g_next_comm++;
  g_comms[handle] = child;
  *newcomm = handle;
  // attribute propagation through copy callbacks (MPI dup semantics:
  // the callback decides whether and what to copy)
  for (auto &e : g_attrs) {
    if (e.first.first != comm) continue;
    auto kv = g_keyvals.find(e.first.second);
    if (kv == g_keyvals.end() || !kv->second.copy_fn) continue;
    void *out = nullptr;
    int flag = 0;
    int rc = kv->second.copy_fn(comm, e.first.second,
                                kv->second.extra_state, e.second, &out,
                                &flag);
    if (rc != MPI_SUCCESS) {
      // unwind: already-copied attrs get their delete callbacks, then
      // the half-built comm dies (comm_dup.c's error contract)
      delete_comm_attrs(handle);
      g_comms.erase(handle);
      return rc;
    }
    if (flag) g_attrs[{handle, e.first.second}] = out;
  }
  return MPI_SUCCESS;
}

int MPI_Comm_free(MPI_Comm *comm) {
  if (!comm || *comm == MPI_COMM_WORLD || *comm == MPI_COMM_SELF)
    return MPI_ERR_COMM;
  if (!g_comms.count(*comm)) return MPI_ERR_COMM;
  // delete callbacks run BEFORE the handle dies (comm_free.c order)
  delete_comm_attrs(*comm);
  release_errh_ref(g_comm_errh, *comm);
  g_comms.erase(*comm);
  *comm = MPI_COMM_NULL;
  return MPI_SUCCESS;
}

// --------------------------------------------------------------- groups
// ompi/group reduced to rank-list algebra; set ops preserve the
// first-group order (the MPI-defined ordering for union/intersection/
// difference).

namespace {

const std::vector<int> *group_ranks(MPI_Group grp) {
  static const std::vector<int> empty;
  if (grp == MPI_GROUP_EMPTY) return &empty;
  GroupObj *g2 = lookup_group(grp);
  return g2 ? &g2->ranks : nullptr;
}

}  // namespace

int MPI_Comm_group(MPI_Comm comm, MPI_Group *group) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  *group = register_group(c->group);
  return MPI_SUCCESS;
}

int MPI_Group_size(MPI_Group group, int *size) {
  if (group == MPI_GROUP_EMPTY) {
    *size = 0;
    return MPI_SUCCESS;
  }
  GroupObj *gr = lookup_group(group);
  if (!gr) return MPI_ERR_GROUP;
  *size = (int)gr->ranks.size();
  return MPI_SUCCESS;
}

int MPI_Group_rank(MPI_Group group, int *rank) {
  if (group == MPI_GROUP_EMPTY) {
    *rank = MPI_UNDEFINED;
    return MPI_SUCCESS;
  }
  GroupObj *gr = lookup_group(group);
  if (!gr) return MPI_ERR_GROUP;
  *rank = MPI_UNDEFINED;
  for (size_t i = 0; i < gr->ranks.size(); i++)
    if (gr->ranks[i] == g.rank) *rank = (int)i;
  return MPI_SUCCESS;
}

int MPI_Group_incl(MPI_Group group, int n, const int ranks[],
                   MPI_Group *newgroup) {
  const std::vector<int> *base = group_ranks(group);
  if (!base) return MPI_ERR_GROUP;
  if (n == 0) {
    *newgroup = MPI_GROUP_EMPTY;
    return MPI_SUCCESS;
  }
  std::vector<bool> seen(base->size(), false);
  std::vector<int> out;
  for (int i = 0; i < n; i++) {
    if (ranks[i] < 0 || ranks[i] >= (int)base->size())
      return MPI_ERR_ARG;
    if (seen[ranks[i]]) return MPI_ERR_ARG;  // MPI: ranks distinct
    seen[ranks[i]] = true;
    out.push_back((*base)[ranks[i]]);
  }
  *newgroup = register_group(std::move(out));
  return MPI_SUCCESS;
}

int MPI_Group_excl(MPI_Group group, int n, const int ranks[],
                   MPI_Group *newgroup) {
  const std::vector<int> *base = group_ranks(group);
  if (!base) return MPI_ERR_GROUP;
  std::vector<bool> drop(base->size(), false);
  for (int i = 0; i < n; i++) {
    if (ranks[i] < 0 || ranks[i] >= (int)base->size())
      return MPI_ERR_ARG;
    if (drop[ranks[i]]) return MPI_ERR_ARG;  // MPI: ranks distinct
    drop[ranks[i]] = true;
  }
  std::vector<int> out;
  for (size_t i = 0; i < base->size(); i++)
    if (!drop[i]) out.push_back((*base)[i]);
  if (out.empty()) {
    *newgroup = MPI_GROUP_EMPTY;
    return MPI_SUCCESS;
  }
  *newgroup = register_group(std::move(out));
  return MPI_SUCCESS;
}

int MPI_Group_union(MPI_Group group1, MPI_Group group2,
                    MPI_Group *newgroup) {
  const std::vector<int> *a = group_ranks(group1);
  const std::vector<int> *b = group_ranks(group2);
  if (!a || !b) return MPI_ERR_GROUP;
  std::vector<int> out(*a);
  for (int r : *b)
    if (std::find(out.begin(), out.end(), r) == out.end())
      out.push_back(r);
  *newgroup = out.empty() ? MPI_GROUP_EMPTY
                          : register_group(std::move(out));
  return MPI_SUCCESS;
}

int MPI_Group_intersection(MPI_Group group1, MPI_Group group2,
                           MPI_Group *newgroup) {
  const std::vector<int> *a = group_ranks(group1);
  const std::vector<int> *b = group_ranks(group2);
  if (!a || !b) return MPI_ERR_GROUP;
  std::vector<int> out;
  for (int r : *a)
    if (std::find(b->begin(), b->end(), r) != b->end())
      out.push_back(r);
  *newgroup = out.empty() ? MPI_GROUP_EMPTY
                          : register_group(std::move(out));
  return MPI_SUCCESS;
}

int MPI_Group_difference(MPI_Group group1, MPI_Group group2,
                         MPI_Group *newgroup) {
  const std::vector<int> *a = group_ranks(group1);
  const std::vector<int> *b = group_ranks(group2);
  if (!a || !b) return MPI_ERR_GROUP;
  std::vector<int> out;
  for (int r : *a)
    if (std::find(b->begin(), b->end(), r) == b->end())
      out.push_back(r);
  *newgroup = out.empty() ? MPI_GROUP_EMPTY
                          : register_group(std::move(out));
  return MPI_SUCCESS;
}

int MPI_Group_translate_ranks(MPI_Group group1, int n, const int ranks1[],
                              MPI_Group group2, int ranks2[]) {
  const std::vector<int> *a = group_ranks(group1);
  const std::vector<int> *b = group_ranks(group2);
  if (!a || !b) return MPI_ERR_GROUP;
  for (int i = 0; i < n; i++) {
    if (ranks1[i] == MPI_PROC_NULL) {
      ranks2[i] = MPI_PROC_NULL;  // MPI-2.2: passes through
      continue;
    }
    if (ranks1[i] < 0 || ranks1[i] >= (int)a->size())
      return MPI_ERR_ARG;
    int world = (*a)[ranks1[i]];
    ranks2[i] = MPI_UNDEFINED;
    for (size_t j = 0; j < b->size(); j++)
      if ((*b)[j] == world) ranks2[i] = (int)j;
  }
  return MPI_SUCCESS;
}

int MPI_Group_free(MPI_Group *group) {
  if (!group) return MPI_ERR_GROUP;
  if (*group == MPI_GROUP_EMPTY) {
    *group = MPI_GROUP_NULL;
    return MPI_SUCCESS;
  }
  if (!g_groups.erase(*group)) return MPI_ERR_GROUP;
  *group = MPI_GROUP_NULL;
  return MPI_SUCCESS;
}

int MPI_Comm_compare(MPI_Comm comm1, MPI_Comm comm2, int *result) {
  CommObj *a = lookup_comm(comm1), *b = lookup_comm(comm2);
  if (!a || !b) return MPI_ERR_COMM;
  if (comm1 == comm2) {
    *result = MPI_IDENT;
    return MPI_SUCCESS;
  }
  if (a->group == b->group) {
    *result = MPI_CONGRUENT;  // same ranks, same order, distinct context
    return MPI_SUCCESS;
  }
  std::vector<int> sa(a->group), sb(b->group);
  std::sort(sa.begin(), sa.end());
  std::sort(sb.begin(), sb.end());
  *result = sa == sb ? MPI_SIMILAR : MPI_UNEQUAL;
  return MPI_SUCCESS;
}

// -------------------------------------------------------- point-to-point

int MPI_Send(const void *buf, int count, MPI_Datatype dt, int dest,
             int tag, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (dest == MPI_PROC_NULL) return MPI_SUCCESS;
  if (tag < 0) return dispatch_comm_err(comm, MPI_ERR_ARG);
  if (dest < 0 || dest >= (int)peer_group(*c).size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  return dispatch_comm_err(
      comm, raw_send(buf, count, dt, peer_world_of(*c, dest), tag,
                     c->cid_pt2pt, /*allow_rndv=*/true));
}

static int make_completed_req(MPI_Comm comm, Req **out = nullptr);
static int isend_rndv(const void *buf, int count, const DtView &v,
                      int dest, int tag, MPI_Comm comm, CommObj *c,
                      MPI_Request *request);

int MPI_Ssend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm) {
  // ssend.c: completion implies the receive is MATCHED — exactly the
  // rendezvous contract (CTS leaves at claim time), so a synchronous
  // send is a forced-rendezvous send at any size
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (dest == MPI_PROC_NULL) return MPI_SUCCESS;
  if (tag < 0) return MPI_ERR_ARG;
  if (dest < 0 || dest >= (int)peer_group(*c).size()) return MPI_ERR_ARG;
  return raw_send(buf, count, dt, peer_world_of(*c, dest), tag,
                  c->cid_pt2pt, /*allow_rndv=*/true, /*force_rndv=*/true);
}

int MPI_Rsend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm) {
  // rsend.c: ready-send may legally be implemented as standard send
  return MPI_Send(buf, count, dt, dest, tag, comm);
}

int MPI_Issend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request) {
  // issend.c: the request completes when the receive is MATCHED — the
  // shared rendezvous-isend lifecycle, forced at any size
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (dest == MPI_PROC_NULL) {
    *request = make_completed_req(comm);
    return MPI_SUCCESS;
  }
  if (tag < 0) return MPI_ERR_ARG;
  if (dest < 0 || dest >= (int)peer_group(*c).size()) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  return isend_rndv(buf, count, v, dest, tag, comm, c, request);
}

int MPI_Irsend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request) {
  return MPI_Isend(buf, count, dt, dest, tag, comm, request);
}

// allocate an already-completed heap request and register it (the
// eager-send/PROC_NULL request shape shared by Isend/Irecv/Ibsend);
// hands the Req back so callers can stamp status without a re-lookup
static int make_completed_req(MPI_Comm comm, Req **out) {
  Req *r = new Req;
  r->complete = true;
  r->heap = true;
  r->comm = comm;
  if (out) *out = r;
  std::lock_guard<std::mutex> lk(g.match_mu);
  int handle = g.next_req++;
  g.reqs[handle] = r;
  return handle;
}

// bsend.c family: buffered sends must complete without the receiver.
// The engine buffers internally (payloads serialize at send time and
// eager frames never wait for a match), so Bsend is an eager-forced
// send at any size below the frame bound; the user's attached buffer
// is tracked for the attach/detach contract but the internal buffering
// does the work (MPI allows the implementation to buffer elsewhere).
static void *g_bsend_buf = nullptr;
static int g_bsend_size = 0;

int MPI_Buffer_attach(void *buffer, int size) {
  if (g_bsend_buf) return MPI_ERR_ARG;  // one buffer at a time
  g_bsend_buf = buffer;
  g_bsend_size = size;
  return MPI_SUCCESS;
}

int MPI_Buffer_detach(void *buffer_addr, int *size) {
  // blocks until pending buffered sends complete — eager frames are on
  // the wire before Bsend returns, so nothing is pending here
  *(void **)buffer_addr = g_bsend_buf;
  *size = g_bsend_size;
  g_bsend_buf = nullptr;
  g_bsend_size = 0;
  return MPI_SUCCESS;
}

int MPI_Bsend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (dest == MPI_PROC_NULL) return MPI_SUCCESS;
  if (tag < 0) return MPI_ERR_ARG;
  if (dest < 0 || dest >= (int)peer_group(*c).size()) return MPI_ERR_ARG;
  // eager at any size: never blocks on the receiver
  return raw_send(buf, count, dt, peer_world_of(*c, dest), tag,
                  c->cid_pt2pt);
}

int MPI_Ibsend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request) {
  int rc = MPI_Bsend(buf, count, dt, dest, tag, comm);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(comm);
  return MPI_SUCCESS;
}

// the MPI-defined "empty" status (request.h's completed-null shape):
// no source, no tag, zero payload, not cancelled
static void empty_status(MPI_Status *status, int source = MPI_ANY_SOURCE) {
  if (!status) return;
  status->MPI_SOURCE = source;
  status->MPI_TAG = MPI_ANY_TAG;
  status->MPI_ERROR = MPI_SUCCESS;
  status->_count = 0;
  status->_cancelled = 0;
}

static int translate_status(CommObj *c, MPI_Status *status) {
  if (status && c) {
    // sources arrive as world ranks; on an intercommunicator they are
    // ranks of the REMOTE group
    int local = peer_local_of(*c, status->MPI_SOURCE);
    if (local != MPI_ANY_SOURCE) status->MPI_SOURCE = local;
  }
  return status ? status->MPI_ERROR : MPI_SUCCESS;
}

int MPI_Recv(void *buf, int count, MPI_Datatype dt, int source, int tag,
             MPI_Comm comm, MPI_Status *status) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (source == MPI_PROC_NULL) {
    empty_status(status, MPI_PROC_NULL);
    return MPI_SUCCESS;
  }
  DtView v;
  if (!resolve_dtype(dt, v))
    return dispatch_comm_err(comm, MPI_ERR_TYPE);
  int src_world = source == MPI_ANY_SOURCE
                      ? MPI_ANY_SOURCE
                      : peer_world_of(*c, source);
  if (source != MPI_ANY_SOURCE && src_world < 0)
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  MPI_Status st{};
  int rc = raw_recv(buf, count, dt, src_world, tag, c->cid_pt2pt, &st);
  if (status) {
    *status = st;
    translate_status(c, status);
  }
  return dispatch_comm_err(comm, rc);
}

int MPI_Get_count(const MPI_Status *status, MPI_Datatype dt, int *count) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t per_bytes = v.elems_per_item() * (int64_t)v.di.item;
  if (per_bytes == 0 || status->_count % per_bytes) {
    *count = MPI_UNDEFINED;
    return MPI_SUCCESS;
  }
  long long n = status->_count / per_bytes;
  // element counts above INT_MAX are unrepresentable in the int API
  *count = n > 2147483647LL ? MPI_UNDEFINED : (int)n;
  return MPI_SUCCESS;
}

// The rendezvous-isend lifecycle (pack-or-inplace, request
// registration, inline ANNOUNCE for wire order, detached CTS-wait +
// bulk push), shared by large MPI_Isend and every-size MPI_Issend.
static int isend_rndv(const void *buf, int count, const DtView &v,
                      int dest, int tag, MPI_Comm comm, CommObj *c,
                      MPI_Request *request) {
  auto *packed = new std::vector<char>;
  const void *src = buf;
  size_t n = (size_t)count * v.elems_per_item();
  if (!v.contiguous()) {
    pack_dtype(buf, count, v, *packed);
    src = packed->data();
    n = packed->size() / v.di.item;
  }
  Req *r = new Req;
  r->heap = true;
  r->comm = comm;
  int handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
  }
  int dest_world = peer_world_of(*c, dest);
  int64_t cid = c->cid_pt2pt;
  DtInfo di = v.di;
  int64_t rid;
  int cts_handle;
  int rc = rndv_announce(n, di, dest_world, tag, cid, rid, cts_handle);
  if (rc != MPI_SUCCESS) {
    delete packed;
    std::lock_guard<std::mutex> lk(g.match_mu);
    g.reqs.erase(handle);
    delete r;
    return rc;
  }
  g.inflight_isends.fetch_add(1);
  std::thread([=]() {
    int src_rc = rndv_complete(src, n, di, dest_world, rid, cts_handle);
    {
      std::lock_guard<std::mutex> lk(g.match_mu);
      r->status.MPI_ERROR = src_rc;
      r->status._count = (long long)(n * di.item);
      r->complete = true;
    }
    g.match_cv.notify_all();
    delete packed;
    g.inflight_isends.fetch_sub(1);
  }).detach();
  *request = handle;
  return MPI_SUCCESS;
}

int MPI_Isend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm, MPI_Request *request) {
  // Below the eager limit the payload is on the wire (or in the peer's
  // unexpected queue) before return, so the request is born complete —
  // pml_ob1's start_copy fast path (pml_ob1_sendreq.h:399-405).  Above
  // it the rendezvous runs on a background thread (CTS arrives only
  // when the receiver matches, so completing it inline would deadlock
  // the crossed-Isend idiom MPI guarantees): the request completes when
  // the bulk push lands, exactly pml_ob1's progressed send request.
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  int rc = MPI_SUCCESS;
  if (dest != MPI_PROC_NULL) {
    if (tag < 0) return dispatch_comm_err(comm, MPI_ERR_ARG);
    if (dest < 0 || dest >= (int)peer_group(*c).size())
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    DtView v;
    if (!resolve_dtype(dt, v))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    int64_t nbytes =
        (int64_t)count * v.elems_per_item() * (int64_t)v.di.item;
    if (nbytes > g.eager_limit)
      return dispatch_comm_err(
          comm, isend_rndv(buf, count, v, dest, tag, comm, c, request));
    rc = raw_send(buf, count, dt, peer_world_of(*c, dest), tag,
                  c->cid_pt2pt, /*allow_rndv=*/true);
    if (rc) return dispatch_comm_err(comm, rc);
  }
  *request = make_completed_req(comm);
  return rc;
}

int MPI_Irecv(void *buf, int count, MPI_Datatype dt, int source, int tag,
              MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  DtView v;
  if (!resolve_dtype(dt, v))
    return dispatch_comm_err(comm, MPI_ERR_TYPE);
  if (source == MPI_PROC_NULL) {
    Req *r;
    int handle = make_completed_req(comm, &r);
    r->status.MPI_SOURCE = MPI_PROC_NULL;
    r->status.MPI_TAG = MPI_ANY_TAG;
    *request = handle;
    return MPI_SUCCESS;
  }
  int src_world = source == MPI_ANY_SOURCE
                      ? MPI_ANY_SOURCE
                      : peer_world_of(*c, source);
  if (source != MPI_ANY_SOURCE && src_world < 0)
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  Req *r = new Req;
  r->is_recv = true;
  r->heap = true;
  r->comm = comm;
  r->user_buf = buf;
  r->count = count;
  *request = post_recv(r, v, c->cid_pt2pt, src_world, tag);
  return MPI_SUCCESS;
}

// ------------------------------------------------- persistent requests
// send_init.c / recv_init.c: the argument set is frozen once, Start
// re-fires it.  Persistent handles are NEGATIVE (disjoint from the
// active-request space), stay allocated across completions (Wait
// deactivates, never frees), and die at MPI_Request_free.

struct PersistentReq {
  bool is_recv;
  const void *sbuf;
  void *rbuf;
  int count;
  MPI_Datatype dt;
  int peer;
  int tag;
  MPI_Comm comm;
  MPI_Request active = MPI_REQUEST_NULL;  // inner handle when started
  int mode = 0;  // 0 standard, 1 synchronous, 2 buffered, 3 ready
};
std::map<int, PersistentReq> g_persistent;
int g_next_persistent = 2;  // public handle = -id (MPI_REQUEST_NULL=-1)

// MPI allows MPI_Type_free between init and Start: pin the typemap by
// registering a PRIVATE duplicate handle the request owns (freed with
// the request), so the user's handle may die independently.
static MPI_Datatype pin_dtype(MPI_Datatype dt) {
  if (dt < DERIVED_BASE) return dt;  // predefined: nothing to pin
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end()) return MPI_DATATYPE_NULL;
  MPI_Datatype priv = g_next_dtype++;
  g_dtypes[priv] = it->second;
  g_dtypes[priv].committed = true;
  return priv;
}

int MPI_Send_init(const void *buf, int count, MPI_Datatype dt, int dest,
                  int tag, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (dest != MPI_PROC_NULL &&
      (dest < 0 || dest >= (int)peer_group(*c).size()))
    return MPI_ERR_ARG;
  MPI_Datatype pinned = pin_dtype(dt);
  if (pinned == MPI_DATATYPE_NULL) return MPI_ERR_TYPE;
  int id = g_next_persistent++;
  g_persistent[id] = {false, buf, nullptr, count, pinned, dest, tag,
                      comm};
  *request = -id;
  return MPI_SUCCESS;
}

// send-mode persistent variants (ssend_init.c / bsend_init.c /
// rsend_init.c): same frozen argument set, Start fires the matching
// nonblocking mode
static int send_init_mode(const void *buf, int count, MPI_Datatype dt,
                          int dest, int tag, MPI_Comm comm,
                          MPI_Request *request, int mode) {
  int rc = MPI_Send_init(buf, count, dt, dest, tag, comm, request);
  if (rc != MPI_SUCCESS) return rc;
  g_persistent[-*request].mode = mode;
  return MPI_SUCCESS;
}

int MPI_Ssend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request) {
  return send_init_mode(buf, count, dt, dest, tag, comm, request, 1);
}

int MPI_Bsend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request) {
  return send_init_mode(buf, count, dt, dest, tag, comm, request, 2);
}

int MPI_Rsend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request) {
  return send_init_mode(buf, count, dt, dest, tag, comm, request, 3);
}

int MPI_Recv_init(void *buf, int count, MPI_Datatype dt, int source,
                  int tag, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (source != MPI_ANY_SOURCE && source != MPI_PROC_NULL &&
      (source < 0 || source >= (int)peer_group(*c).size()))
    return MPI_ERR_ARG;
  MPI_Datatype pinned = pin_dtype(dt);
  if (pinned == MPI_DATATYPE_NULL) return MPI_ERR_TYPE;
  int id = g_next_persistent++;
  g_persistent[id] = {true, nullptr, buf, count, pinned, source, tag,
                      comm};
  *request = -id;
  return MPI_SUCCESS;
}

int MPI_Start(MPI_Request *request) {
  if (!request || *request >= MPI_REQUEST_NULL) return MPI_ERR_REQUEST;
  auto it = g_persistent.find(-*request);
  if (it == g_persistent.end()) return MPI_ERR_REQUEST;
  PersistentReq &p = it->second;
  if (p.active != MPI_REQUEST_NULL) return MPI_ERR_REQUEST;  // running
  if (p.is_recv)
    return MPI_Irecv(p.rbuf, p.count, p.dt, p.peer, p.tag, p.comm,
                     &p.active);
  switch (p.mode) {
    case 1:
      return MPI_Issend(p.sbuf, p.count, p.dt, p.peer, p.tag, p.comm,
                        &p.active);
    case 2:
      return MPI_Ibsend(p.sbuf, p.count, p.dt, p.peer, p.tag, p.comm,
                        &p.active);
    case 3:
      return MPI_Irsend(p.sbuf, p.count, p.dt, p.peer, p.tag, p.comm,
                        &p.active);
  }
  return MPI_Isend(p.sbuf, p.count, p.dt, p.peer, p.tag, p.comm,
                   &p.active);
}

int MPI_Startall(int count, MPI_Request requests[]) {
  for (int i = 0; i < count; i++) {
    int rc = MPI_Start(&requests[i]);
    if (rc != MPI_SUCCESS) return rc;
  }
  return MPI_SUCCESS;
}

int MPI_Request_free(MPI_Request *request) {
  if (!request || *request == MPI_REQUEST_NULL) return MPI_ERR_REQUEST;
  if (*request < MPI_REQUEST_NULL) {
    auto it = g_persistent.find(-*request);
    if (it == g_persistent.end()) return MPI_ERR_REQUEST;
    if (it->second.active != MPI_REQUEST_NULL)
      return MPI_ERR_REQUEST;  // complete it first (the safe subset)
    if (it->second.dt >= DERIVED_BASE)
      g_dtypes.erase(it->second.dt);  // the request's private pin
    g_persistent.erase(it);
    *request = MPI_REQUEST_NULL;
    return MPI_SUCCESS;
  }
  // non-persistent: only a completed request may be freed here
  Req *r;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto it = g.reqs.find(*request);
    if (it == g.reqs.end() || !it->second->complete)
      return MPI_ERR_REQUEST;
    r = it->second;
    g.reqs.erase(it);
  }
  // the receive must still complete into the user buffer (MPI-3.1
  // 3.7.3): a derived-type recv parked in scratch gets its unpack
  finish_recv(r);
  if (r->heap) delete r;
  *request = MPI_REQUEST_NULL;
  return MPI_SUCCESS;
}

int MPI_Wait(MPI_Request *request, MPI_Status *status) {
  if (!request || *request == MPI_REQUEST_NULL) {
    empty_status(status);
    return MPI_SUCCESS;
  }
  if (*request < MPI_REQUEST_NULL) {
    // persistent: wait the inner active op, DEACTIVATE but never free
    auto it = g_persistent.find(-*request);
    if (it == g_persistent.end()) return MPI_ERR_REQUEST;
    PersistentReq &p = it->second;
    if (p.active == MPI_REQUEST_NULL) {
      // inactive persistent request: empty status, immediate return
      MPI_Request null_req = MPI_REQUEST_NULL;
      return MPI_Wait(&null_req, status);
    }
    int rc = MPI_Wait(&p.active, status);
    p.active = MPI_REQUEST_NULL;
    return rc;  // handle stays valid for the next Start
  }
  int comm_handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto it = g.reqs.find(*request);
    if (it == g.reqs.end()) return MPI_ERR_REQUEST;
    comm_handle = it->second->comm;
  }
  MPI_Status st{};
  int rc = wait_handle_impl(*request, &st);
  if (status) {
    *status = st;
    translate_status(lookup_comm(comm_handle), status);
  }
  *request = MPI_REQUEST_NULL;
  return rc;
}

int MPI_Test(MPI_Request *request, int *flag, MPI_Status *status) {
  if (!request || *request == MPI_REQUEST_NULL) {
    *flag = 1;
    empty_status(status);
    return MPI_SUCCESS;
  }
  if (*request < MPI_REQUEST_NULL) {
    auto it = g_persistent.find(-*request);
    if (it == g_persistent.end()) return MPI_ERR_REQUEST;
    PersistentReq &p = it->second;
    if (p.active == MPI_REQUEST_NULL) {
      *flag = 1;
      empty_status(status);
      return MPI_SUCCESS;
    }
    *flag = 0;
    int rc = MPI_Test(&p.active, flag, status);
    if (rc == MPI_SUCCESS && *flag) p.active = MPI_REQUEST_NULL;
    return rc;
  }
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto it = g.reqs.find(*request);
    if (it == g.reqs.end()) return MPI_ERR_REQUEST;
    if (!it->second->complete) {
      *flag = 0;
      return MPI_SUCCESS;
    }
  }
  *flag = 1;
  return MPI_Wait(request, status);
}

int MPI_Waitall(int count, MPI_Request requests[], MPI_Status statuses[]) {
  int rc = MPI_SUCCESS;
  for (int i = 0; i < count; i++) {
    int r = MPI_Wait(&requests[i],
                     statuses ? &statuses[i] : MPI_STATUS_IGNORE);
    if (r != MPI_SUCCESS) rc = r;
  }
  return rc;
}

int MPI_Sendrecv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                 int dest, int sendtag, void *recvbuf, int recvcount,
                 MPI_Datatype recvtype, int source, int recvtag,
                 MPI_Comm comm, MPI_Status *status) {
  // irecv-first so crossed Sendrecv pairs cannot deadlock
  // (coll_base_util.h:70-98's sendrecv primitive)
  MPI_Request rreq;
  int rc = MPI_Irecv(recvbuf, recvcount, recvtype, source, recvtag, comm,
                     &rreq);
  if (rc) return rc;
  rc = MPI_Send(sendbuf, sendcount, sendtype, dest, sendtag, comm);
  if (rc) return rc;
  return MPI_Wait(&rreq, status);
}

// ----------------------------------------------------------- collectives

int MPI_Barrier(MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(comm, c_barrier(*c));
}

int MPI_Bcast(void *buf, int count, MPI_Datatype dt, int root,
              MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  return dispatch_comm_err(comm, c_bcast(*c, buf, count, dt, root,
                                         0x7E01));
}

// IN_PLACE substitution (MPI-3.1 ch.5): clone the receive-side
// contribution into an extent-layout temp via pack/unpack — pack
// touches only typemap bytes, so the clone never overreads a strided
// type's trailing gap.
// NOTE: the per-collective slice/span arithmetic below is MIRRORED in
// the nonblocking wrappers (MPI_Iallreduce ... MPI_Ialltoallv, search
// icoll_inplace) — fix BOTH copies or extract a helper when touching
// either.
static int clone_region(const void *src, int count, MPI_Datatype dt,
                        std::vector<char> &tmp) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  std::vector<char> packed;
  pack_dtype(src, count, v, packed);
  tmp.assign(slot_bytes(v, count), 0);
  unpack_dtype(tmp.data(), count, v, packed.data(), packed.size());
  return MPI_SUCCESS;
}

int MPI_Allreduce(const void *sendbuf, void *recvbuf, int count,
                  MPI_Datatype dt, MPI_Op op, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int rc = clone_region(recvbuf, count, dt, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
  }
  return dispatch_comm_err(
      comm, c_allreduce(*c, sendbuf, recvbuf, count, dt, op));
}

int MPI_Reduce(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    // IN_PLACE is legal at the ROOT only (reduce.c)
    if (c->local_rank != root)
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    int rc = clone_region(recvbuf, count, dt, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
  }
  return dispatch_comm_err(
      comm, c_reduce(*c, sendbuf, recvbuf, count, dt, op, root));
}

int MPI_Gather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype,
               int root, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    // root's contribution already sits at its slot of recvbuf
    if (c->local_rank != root)
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    const char *slice =
        (const char *)recvbuf + (size_t)root * slot_bytes(rv, recvcount);
    int rc = clone_region(slice, recvcount, recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcount = recvcount;
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_gather(*c, sendbuf, sendcount, sendtype, recvbuf,
                     recvcount, recvtype, root));
}

int MPI_Scatter(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, int recvcount, MPI_Datatype recvtype,
                int root, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  std::vector<char> scratch;
  if (recvbuf == MPI_IN_PLACE) {
    // scatter.c: IN_PLACE recvbuf at the root — its slice stays in
    // sendbuf; receive into scratch and discard
    if (c->local_rank != root)
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    DtView sv;
    if (!resolve_dtype(sendtype, sv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    scratch.resize(slot_bytes(sv, sendcount));
    recvbuf = scratch.data();
    recvcount = sendcount;
    recvtype = sendtype;
  }
  return dispatch_comm_err(
      comm, c_scatter(*c, sendbuf, sendcount, sendtype, recvbuf,
                      recvcount, recvtype, root));
}

int MPI_Allgather(const void *sendbuf, int sendcount,
                  MPI_Datatype sendtype, void *recvbuf, int recvcount,
                  MPI_Datatype recvtype, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    const char *slice = (const char *)recvbuf +
                        (size_t)c->local_rank *
                            slot_bytes(rv, recvcount);
    int rc = clone_region(slice, recvcount, recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcount = recvcount;
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_allgather(*c, sendbuf, sendcount, sendtype, recvbuf,
                        recvcount, recvtype));
}

int MPI_Alltoall(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                 void *recvbuf, int recvcount, MPI_Datatype recvtype,
                 MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int n = (int)c->group.size();
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    int rc = clone_region(recvbuf, n * recvcount, recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcount = recvcount;
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_alltoall(*c, sendbuf, sendcount, sendtype, recvbuf,
                       recvcount, recvtype));
}

// ------------------------------------------------------------- datatypes

int MPI_Type_contiguous(int count, MPI_Datatype oldtype,
                        MPI_Datatype *newtype) {
  // type_contiguous.c analog; nesting flattens (old derived types
  // expand into their base blocks)
  if (count < 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(oldtype, v)) return MPI_ERR_TYPE;
  DtypeObj d;
  d.base = v.derived ? v.derived->base : oldtype;
  int64_t old_extent = v.derived ? v.derived->extent : 1;
  for (int c = 0; c < count; c++) {
    int64_t off = c * old_extent;
    if (v.derived) {
      for (auto &b : v.derived->blocks)
        d.blocks.push_back({off + b.first, b.second});
    } else {
      d.blocks.push_back({off, 1});
    }
  }
  coalesce_blocks(d.blocks);
  d.extent = count * old_extent;
  d.elems = count * v.elems_per_item();
  d.combiner = MPI_COMBINER_CONTIGUOUS;
  d.env_ints = {count};
  d.env_types = {oldtype};
  MPI_Datatype handle = g_next_dtype++;
  g_dtypes[handle] = d;
  *newtype = handle;
  return MPI_SUCCESS;
}

int MPI_Type_vector(int count, int blocklength, int stride,
                    MPI_Datatype oldtype, MPI_Datatype *newtype) {
  // type_vector.c analog; stride in units of oldtype extent
  if (count < 0 || blocklength < 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(oldtype, v)) return MPI_ERR_TYPE;
  DtypeObj d;
  d.base = v.derived ? v.derived->base : oldtype;
  int64_t old_extent = v.derived ? v.derived->extent : 1;
  d.lb = v.derived ? v.derived->lb : 0;  // min disp is 0; inner lb adds
  int64_t max_off = 0;
  for (int c = 0; c < count; c++) {
    for (int b = 0; b < blocklength; b++) {
      int64_t off = ((int64_t)c * stride + b) * old_extent;
      if (off < 0) return MPI_ERR_ARG;  // negative stride unsupported
      if (v.derived) {
        for (auto &bb : v.derived->blocks)
          d.blocks.push_back({off + bb.first, bb.second});
      } else {
        d.blocks.push_back({off, 1});
      }
      if (off + old_extent > max_off) max_off = off + old_extent;
    }
  }
  coalesce_blocks(d.blocks);
  d.extent = max_off;
  d.elems = (int64_t)count * blocklength * v.elems_per_item();
  d.combiner = MPI_COMBINER_VECTOR;
  d.env_ints = {count, blocklength, stride};
  d.env_types = {oldtype};
  MPI_Datatype handle = g_next_dtype++;
  g_dtypes[handle] = d;
  *newtype = handle;
  return MPI_SUCCESS;
}

int MPI_Type_indexed(int count, const int blocklengths[],
                     const int displacements[], MPI_Datatype oldtype,
                     MPI_Datatype *newtype) {
  // type_indexed.c analog: per-block lengths and displacements, both in
  // units of oldtype extent
  if (count < 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(oldtype, v)) return MPI_ERR_TYPE;
  DtypeObj d;
  d.base = v.derived ? v.derived->base : oldtype;
  int64_t old_extent = v.derived ? v.derived->extent : 1;
  int64_t old_lb = v.derived ? v.derived->lb : 0;
  int64_t max_off = 0, min_off = INT64_MAX;
  int64_t total = 0;
  for (int c = 0; c < count; c++) {
    if (blocklengths[c] < 0) return MPI_ERR_ARG;
    if (blocklengths[c] == 0) continue;
    if (!v.derived) {
      // predefined oldtype: the whole block is ONE contiguous run
      int64_t off = (int64_t)displacements[c];
      if (off < 0) return MPI_ERR_ARG;  // negative disp unsupported
      d.blocks.push_back({off, blocklengths[c]});
      int64_t end = off + blocklengths[c];
      if (end > max_off) max_off = end;
      if (off < min_off) min_off = off;
    } else {
      for (int b = 0; b < blocklengths[c]; b++) {
        int64_t off = ((int64_t)displacements[c] + b) * old_extent;
        if (off < 0) return MPI_ERR_ARG;
        for (auto &bb : v.derived->blocks)
          d.blocks.push_back({off + bb.first, bb.second});
        if (off + old_lb + old_extent > max_off)
          max_off = off + old_lb + old_extent;
        if (off + old_lb < min_off) min_off = off + old_lb;
      }
    }
    total += blocklengths[c];
  }
  if (total == 0) min_off = 0;
  // typemap order is DECLARATION order (pack serializes in this order,
  // MPI-3.1 §4.1) — never sort; coalescing only merges adjacent runs
  coalesce_blocks(d.blocks);
  // extent = ub - lb (MPI-3.1 §4.1.6), the oldtype's own lb included;
  // block offsets stay ABSOLUTE, so item k's typemap is d_i + k*extent,
  // exactly the standard's concatenation
  d.lb = min_off;
  d.extent = max_off - min_off;
  d.elems = total * v.elems_per_item();
  d.combiner = MPI_COMBINER_INDEXED;
  d.env_ints.push_back(count);
  for (int c2 = 0; c2 < count; c2++) d.env_ints.push_back(blocklengths[c2]);
  for (int c2 = 0; c2 < count; c2++)
    d.env_ints.push_back(displacements[c2]);
  d.env_types = {oldtype};
  MPI_Datatype handle = g_next_dtype++;
  g_dtypes[handle] = d;
  *newtype = handle;
  return MPI_SUCCESS;
}

int MPI_Type_create_indexed_block(int count, int blocklength,
                                  const int displacements[],
                                  MPI_Datatype oldtype,
                                  MPI_Datatype *newtype) {
  if (count < 0 || blocklength < 0) return MPI_ERR_ARG;
  std::vector<int> lens((size_t)count, blocklength);
  int rc = MPI_Type_indexed(count, lens.data(), displacements, oldtype,
                            newtype);
  if (rc != MPI_SUCCESS) return rc;
  DtypeObj &d = g_dtypes[*newtype];
  d.combiner = MPI_COMBINER_INDEXED_BLOCK;
  d.env_ints.assign({count, blocklength});
  for (int c2 = 0; c2 < count; c2++)
    d.env_ints.push_back(displacements[c2]);
  d.env_types = {oldtype};
  return MPI_SUCCESS;
}

int MPI_Type_commit(MPI_Datatype *datatype) {
  if (!datatype) return MPI_ERR_TYPE;
  if (*datatype < DERIVED_BASE) return MPI_SUCCESS;  // predefined
  auto it = g_dtypes.find(*datatype);
  if (it == g_dtypes.end()) return MPI_ERR_TYPE;
  it->second.committed = true;
  return MPI_SUCCESS;
}

void delete_type_attrs(MPI_Datatype dt);  // batch-8 section

int MPI_Type_free(MPI_Datatype *datatype) {
  if (!datatype || *datatype < DERIVED_BASE) return MPI_ERR_TYPE;
  if (!g_dtypes.count(*datatype)) return MPI_ERR_TYPE;
  // attribute delete callbacks run before the handle dies
  delete_type_attrs(*datatype);
  g_dtypes.erase(*datatype);
  *datatype = MPI_DATATYPE_NULL;
  return MPI_SUCCESS;
}

int MPI_Type_size(MPI_Datatype datatype, int *size) {
  DtView v;
  if (datatype >= DERIVED_BASE) {
    // committed not required for size queries
    auto it = g_dtypes.find(datatype);
    if (it == g_dtypes.end()) return MPI_ERR_TYPE;
    DtInfo di;
    if (!base_dtinfo(it->second.base, di)) return MPI_ERR_TYPE;
    int ptm = pair_typemap_size(it->second.base);
    *size = (int)(it->second.elems * (ptm ? (size_t)ptm : di.item));
    return MPI_SUCCESS;
  }
  if (!resolve_dtype(datatype, v)) return MPI_ERR_TYPE;
  // pair types: the TYPEMAP size (value + int), not the padded extent
  // (type_size.c: MPI_DOUBLE_INT is 12, its extent 16)
  int ptm = pair_typemap_size(datatype);
  *size = ptm ? ptm : (int)v.di.item;
  return MPI_SUCCESS;
}

// ------------------------------------------- datatype tier 2 (round 5)
// Byte-displacement constructors (type_create_hvector.c,
// type_create_struct.c, ...) flatten to BYTE typemaps: displacements
// need not be multiples of the base item, so the byte unit is the one
// common denominator.  The cluster is homogeneous (same reduction the
// convertor's external32 path documents), so no per-element identity
// is lost on the wire.

namespace {

// resolve a type for CONSTRUCTION (committed not required, unlike the
// communication-path resolve_dtype)
bool resolve_for_build(MPI_Datatype dt, DtView &v) {
  if (dt < DERIVED_BASE) return base_dtinfo(dt, v.di);
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end()) return false;
  v.derived = &it->second;
  return base_dtinfo(it->second.base, v.di);
}

// one item of `v` as BYTE blocks appended at byte offset `at`
void append_item_bytes(std::vector<std::pair<int64_t, int64_t>> &blocks,
                       const DtView &v, int64_t at) {
  int64_t item = (int64_t)v.di.item;
  if (!v.derived) {
    blocks.push_back({at, item});
    return;
  }
  for (auto &b : v.derived->blocks)
    blocks.push_back({at + b.first * item, b.second * item});
}

// extent/lb of one item in BYTES
int64_t extent_bytes_of(const DtView &v) {
  return (v.derived ? v.derived->extent : 1) * (int64_t)v.di.item;
}
int64_t lb_bytes_of(const DtView &v) {
  return (v.derived ? v.derived->lb : 0) * (int64_t)v.di.item;
}

// finalize a byte-based DtypeObj: elems = total bytes, base = BYTE.
// `swap_unit` records the uniform element size of the packed stream
// (0 for heterogeneous structs — external32 rejects those).
void seal_byte_type(DtypeObj &d, int swap_unit) {
  coalesce_blocks(d.blocks);
  d.base = MPI_BYTE;
  d.swap_unit = swap_unit;
  int64_t total = 0;
  for (auto &b : d.blocks) total += b.second;
  d.elems = total;
}

int register_dtype(DtypeObj d, MPI_Datatype *newtype) {
  MPI_Datatype handle = g_next_dtype++;
  g_dtypes[handle] = std::move(d);
  *newtype = handle;
  return MPI_SUCCESS;
}

}  // namespace

int MPI_Type_dup(MPI_Datatype oldtype, MPI_Datatype *newtype) {
  if (oldtype < DERIVED_BASE) {
    DtInfo di;
    if (!base_dtinfo(oldtype, di)) return MPI_ERR_TYPE;
    DtypeObj d;
    d.base = oldtype;
    d.blocks = {{0, 1}};
    d.extent = 1;
    d.elems = 1;
    d.combiner = MPI_COMBINER_DUP;
    d.env_types = {oldtype};
    return register_dtype(std::move(d), newtype);
  }
  auto it = g_dtypes.find(oldtype);
  if (it == g_dtypes.end()) return MPI_ERR_TYPE;
  DtypeObj d = it->second;
  d.combiner = MPI_COMBINER_DUP;
  d.env_ints.clear();
  d.env_aints.clear();
  d.env_types = {oldtype};
  d.committed = it->second.committed;  // dup of committed is committed
  return register_dtype(std::move(d), newtype);
}

int MPI_Type_create_resized(MPI_Datatype oldtype, MPI_Aint lb,
                            MPI_Aint extent, MPI_Datatype *newtype) {
  // type_create_resized.c: same typemap, caller-chosen lb/extent
  // (bytes) — the packing stride changes, the data does not
  DtView v;
  if (!resolve_for_build(oldtype, v)) return MPI_ERR_TYPE;
  DtypeObj d;
  append_item_bytes(d.blocks, v, 0);
  seal_byte_type(d, packed_unit_of(v.derived, oldtype, v.di.item));
  d.lb = lb;
  d.extent = extent;
  d.combiner = MPI_COMBINER_RESIZED;
  d.env_aints = {(long long)lb, (long long)extent};
  d.env_types = {oldtype};
  return register_dtype(std::move(d), newtype);
}

int MPI_Type_create_hvector(int count, int blocklength, MPI_Aint stride,
                            MPI_Datatype oldtype, MPI_Datatype *newtype) {
  // type_create_hvector.c: stride in BYTES
  if (count < 0 || blocklength < 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_for_build(oldtype, v)) return MPI_ERR_TYPE;
  int64_t oext = extent_bytes_of(v);
  DtypeObj d;
  int64_t max_ub = 0, min_lb = 0;
  for (int c = 0; c < count; c++) {
    int64_t base_off = (int64_t)c * stride;
    for (int b = 0; b < blocklength; b++) {
      int64_t off = base_off + (int64_t)b * oext;
      if (off < 0) return MPI_ERR_ARG;
      append_item_bytes(d.blocks, v, off);
      int64_t ilb = off + lb_bytes_of(v);
      if (ilb < min_lb) min_lb = ilb;
      if (ilb + oext > max_ub) max_ub = ilb + oext;
    }
  }
  seal_byte_type(d, packed_unit_of(v.derived, oldtype, v.di.item));
  d.lb = min_lb;
  d.extent = max_ub - min_lb;
  d.combiner = MPI_COMBINER_HVECTOR;
  d.env_ints = {count, blocklength};
  d.env_aints = {(long long)stride};
  d.env_types = {oldtype};
  return register_dtype(std::move(d), newtype);
}

static int hindexed_impl(int count, const int blocklengths[],
                         const MPI_Aint displacements[],
                         MPI_Datatype oldtype, MPI_Datatype *newtype,
                         int combiner) {
  // type_create_hindexed.c: displacements in BYTES
  if (count < 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_for_build(oldtype, v)) return MPI_ERR_TYPE;
  int64_t oext = extent_bytes_of(v);
  DtypeObj d;
  int64_t max_ub = INT64_MIN, min_lb = INT64_MAX;
  int64_t total = 0;
  for (int c = 0; c < count; c++) {
    if (blocklengths[c] < 0) return MPI_ERR_ARG;
    for (int b = 0; b < blocklengths[c]; b++) {
      int64_t off = (int64_t)displacements[c] + (int64_t)b * oext;
      if (off < 0) return MPI_ERR_ARG;
      append_item_bytes(d.blocks, v, off);
      int64_t ilb = off + lb_bytes_of(v);
      if (ilb < min_lb) min_lb = ilb;
      if (ilb + oext > max_ub) max_ub = ilb + oext;
    }
    total += blocklengths[c];
  }
  if (total == 0) { min_lb = 0; max_ub = 0; }
  seal_byte_type(d, packed_unit_of(v.derived, oldtype, v.di.item));
  d.lb = min_lb;
  d.extent = max_ub - min_lb;
  d.combiner = combiner;
  d.env_ints.push_back(count);
  if (combiner == MPI_COMBINER_HINDEXED_BLOCK) {
    d.env_ints.push_back(count ? blocklengths[0] : 0);
  } else {
    for (int c = 0; c < count; c++) d.env_ints.push_back(blocklengths[c]);
  }
  for (int c = 0; c < count; c++)
    d.env_aints.push_back((long long)displacements[c]);
  d.env_types = {oldtype};
  return register_dtype(std::move(d), newtype);
}

int MPI_Type_create_hindexed(int count, const int blocklengths[],
                             const MPI_Aint displacements[],
                             MPI_Datatype oldtype,
                             MPI_Datatype *newtype) {
  return hindexed_impl(count, blocklengths, displacements, oldtype,
                       newtype, MPI_COMBINER_HINDEXED);
}

int MPI_Type_create_hindexed_block(int count, int blocklength,
                                   const MPI_Aint displacements[],
                                   MPI_Datatype oldtype,
                                   MPI_Datatype *newtype) {
  if (count < 0 || blocklength < 0) return MPI_ERR_ARG;
  std::vector<int> lens((size_t)count, blocklength);
  return hindexed_impl(count, lens.data(), displacements, oldtype,
                       newtype, MPI_COMBINER_HINDEXED_BLOCK);
}

int MPI_Type_create_struct(int count, const int blocklengths[],
                           const MPI_Aint displacements[],
                           const MPI_Datatype types[],
                           MPI_Datatype *newtype) {
  // type_create_struct.c: heterogeneous fields — the one constructor
  // that FORCES the byte flattening
  if (count < 0) return MPI_ERR_ARG;
  DtypeObj d;
  int64_t max_ub = INT64_MIN, min_lb = INT64_MAX;
  int64_t total = 0;
  for (int c = 0; c < count; c++) {
    if (blocklengths[c] < 0) return MPI_ERR_ARG;
    DtView v;
    if (!resolve_for_build(types[c], v)) return MPI_ERR_TYPE;
    int64_t oext = extent_bytes_of(v);
    for (int b = 0; b < blocklengths[c]; b++) {
      int64_t off = (int64_t)displacements[c] + (int64_t)b * oext;
      if (off < 0) return MPI_ERR_ARG;
      append_item_bytes(d.blocks, v, off);
      int64_t ilb = off + lb_bytes_of(v);
      if (ilb < min_lb) min_lb = ilb;
      if (ilb + oext > max_ub) max_ub = ilb + oext;
    }
    total += blocklengths[c];
  }
  if (total == 0) { min_lb = 0; max_ub = 0; }
  // typemap stays in DECLARATION order (pack serializes field order);
  // a uniform field unit survives for canonical packing, mixed -> 0
  int su = -1;
  for (int c = 0; c < count; c++) {
    if (blocklengths[c] == 0) continue;
    DtView fv;
    resolve_for_build(types[c], fv);
    int u = packed_unit_of(fv.derived, types[c], fv.di.item);
    if (su < 0) su = u;
    else if (su != u) su = 0;
  }
  seal_byte_type(d, su < 0 ? 1 : su);
  d.lb = min_lb;
  d.extent = max_ub - min_lb;
  d.combiner = MPI_COMBINER_STRUCT;
  d.env_ints.push_back(count);
  for (int c = 0; c < count; c++) d.env_ints.push_back(blocklengths[c]);
  for (int c = 0; c < count; c++)
    d.env_aints.push_back((long long)displacements[c]);
  d.env_types.assign(types, types + count);
  return register_dtype(std::move(d), newtype);
}

namespace {

// shared emitter for subarray/darray: per-dimension index RUNS over a
// full array of `sizes`, emitted as oldtype-unit blocks.  `order`
// fixes which dimension is unit-stride (C: last, Fortran: first).
void emit_runs(const std::vector<std::vector<std::pair<int, int>>> &runs,
               const std::vector<int> &sizes, int order, const DtView &v,
               DtypeObj &d) {
  int nd = (int)sizes.size();
  std::vector<int64_t> stride((size_t)nd);  // in oldtype units
  int contig;
  if (order == MPI_ORDER_C) {
    contig = nd - 1;
    stride[(size_t)nd - 1] = 1;
    for (int i = nd - 2; i >= 0; i--)
      stride[(size_t)i] = stride[(size_t)i + 1] * sizes[(size_t)i + 1];
  } else {
    contig = 0;
    stride[0] = 1;
    for (int i = 1; i < nd; i++)
      stride[(size_t)i] = stride[(size_t)i - 1] * sizes[(size_t)i - 1];
  }
  int64_t oext = extent_bytes_of(v);
  // odometer over every non-contiguous dimension's individual indices;
  // the contiguous dimension emits whole runs
  std::function<void(int, int64_t)> rec = [&](int dim, int64_t off) {
    if (dim == nd) {
      for (auto &r : runs[(size_t)contig]) {
        int64_t at = (off + (int64_t)r.first * stride[(size_t)contig]) *
                     oext;
        for (int k = 0; k < r.second; k++)
          append_item_bytes(d.blocks, v, at + (int64_t)k * oext);
      }
      return;
    }
    if (dim == contig) {
      rec(dim + 1, off);
      return;
    }
    for (auto &r : runs[(size_t)dim])
      for (int k = 0; k < r.second; k++)
        rec(dim + 1, off + ((int64_t)r.first + k) * stride[(size_t)dim]);
  };
  rec(0, 0);
}

}  // namespace

int MPI_Type_create_subarray(int ndims, const int sizes[],
                             const int subsizes[], const int starts[],
                             int order, MPI_Datatype oldtype,
                             MPI_Datatype *newtype) {
  // type_create_subarray.c: extent spans the FULL array (lb 0), the
  // typemap covers the subarray block
  if (ndims <= 0) return MPI_ERR_ARG;
  if (order != MPI_ORDER_C && order != MPI_ORDER_FORTRAN)
    return MPI_ERR_ARG;
  DtView v;
  if (!resolve_for_build(oldtype, v)) return MPI_ERR_TYPE;
  std::vector<std::vector<std::pair<int, int>>> runs((size_t)ndims);
  int64_t full = 1;
  for (int i = 0; i < ndims; i++) {
    if (sizes[i] <= 0 || subsizes[i] < 0 || starts[i] < 0 ||
        starts[i] + subsizes[i] > sizes[i])
      return MPI_ERR_ARG;
    if (subsizes[i] > 0) runs[(size_t)i] = {{starts[i], subsizes[i]}};
    full *= sizes[i];
  }
  DtypeObj d;
  emit_runs(runs, std::vector<int>(sizes, sizes + ndims), order, v, d);
  seal_byte_type(d, packed_unit_of(v.derived, oldtype, v.di.item));
  d.lb = 0;
  d.extent = full * extent_bytes_of(v);
  d.combiner = MPI_COMBINER_SUBARRAY;
  d.env_ints.push_back(ndims);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(sizes[i]);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(subsizes[i]);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(starts[i]);
  d.env_ints.push_back(order);
  d.env_types = {oldtype};
  return register_dtype(std::move(d), newtype);
}

int MPI_Type_create_darray(int size, int rank, int ndims,
                           const int gsizes[], const int distribs[],
                           const int dargs[], const int psizes[],
                           int order, MPI_Datatype oldtype,
                           MPI_Datatype *newtype) {
  // type_create_darray.c: HPF-style distributions.  The process grid
  // is ALWAYS row-major over psizes (MPI-3.1 §4.1.4); `order` governs
  // only the array storage order.
  if (ndims <= 0 || size <= 0 || rank < 0 || rank >= size)
    return MPI_ERR_ARG;
  if (order != MPI_ORDER_C && order != MPI_ORDER_FORTRAN)
    return MPI_ERR_ARG;
  int64_t grid = 1;
  for (int i = 0; i < ndims; i++) {
    if (psizes[i] <= 0 || gsizes[i] <= 0) return MPI_ERR_ARG;
    if (distribs[i] == MPI_DISTRIBUTE_NONE && psizes[i] != 1)
      return MPI_ERR_ARG;
    grid *= psizes[i];
  }
  if (grid != size) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_for_build(oldtype, v)) return MPI_ERR_TYPE;
  // my coordinates, row-major
  std::vector<int> coord((size_t)ndims);
  int rem = rank;
  for (int i = ndims - 1; i >= 0; i--) {
    coord[(size_t)i] = rem % psizes[i];
    rem /= psizes[i];
  }
  std::vector<std::vector<std::pair<int, int>>> runs((size_t)ndims);
  int64_t full = 1;
  for (int i = 0; i < ndims; i++) {
    full *= gsizes[i];
    int n = gsizes[i], p = psizes[i], c = coord[(size_t)i];
    switch (distribs[i]) {
      case MPI_DISTRIBUTE_NONE:
        runs[(size_t)i] = {{0, n}};
        break;
      case MPI_DISTRIBUTE_BLOCK: {
        int b = dargs[i] == MPI_DISTRIBUTE_DFLT_DARG
                    ? (n + p - 1) / p
                    : dargs[i];
        if (b <= 0 || (int64_t)b * p < n) return MPI_ERR_ARG;
        int start = c * b;
        int len = start < n ? (start + b > n ? n - start : b) : 0;
        if (len > 0) runs[(size_t)i] = {{start, len}};
        break;
      }
      case MPI_DISTRIBUTE_CYCLIC: {
        int b = dargs[i] == MPI_DISTRIBUTE_DFLT_DARG ? 1 : dargs[i];
        if (b <= 0) return MPI_ERR_ARG;
        for (int64_t start = (int64_t)c * b; start < n;
             start += (int64_t)p * b) {
          int len = (int)(start + b > n ? n - start : b);
          runs[(size_t)i].push_back({(int)start, len});
        }
        break;
      }
      default:
        return MPI_ERR_ARG;
    }
  }
  DtypeObj d;
  emit_runs(runs, std::vector<int>(gsizes, gsizes + ndims), order, v, d);
  seal_byte_type(d, packed_unit_of(v.derived, oldtype, v.di.item));
  d.lb = 0;
  d.extent = full * extent_bytes_of(v);
  d.combiner = MPI_COMBINER_DARRAY;
  d.env_ints.push_back(size);
  d.env_ints.push_back(rank);
  d.env_ints.push_back(ndims);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(gsizes[i]);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(distribs[i]);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(dargs[i]);
  for (int i = 0; i < ndims; i++) d.env_ints.push_back(psizes[i]);
  d.env_ints.push_back(order);
  d.env_types = {oldtype};
  return register_dtype(std::move(d), newtype);
}

namespace {

// true extent: the typemap's actual byte span, resized lb/ub ignored
// (type_get_true_extent.c)
int true_extent_impl(MPI_Datatype dt, int64_t &tlb, int64_t &text) {
  if (dt < DERIVED_BASE) {
    DtInfo di;
    if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
    tlb = 0;
    text = (int64_t)di.item;
    return MPI_SUCCESS;
  }
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end()) return MPI_ERR_TYPE;
  DtInfo di;
  if (!base_dtinfo(it->second.base, di)) return MPI_ERR_TYPE;
  if (it->second.blocks.empty()) {
    tlb = 0;
    text = 0;
    return MPI_SUCCESS;
  }
  int64_t lo = INT64_MAX, hi = INT64_MIN;
  for (auto &b : it->second.blocks) {
    if (b.first < lo) lo = b.first;
    if (b.first + b.second > hi) hi = b.first + b.second;
  }
  tlb = lo * (int64_t)di.item;
  text = (hi - lo) * (int64_t)di.item;
  return MPI_SUCCESS;
}

}  // namespace

int MPI_Type_get_true_extent(MPI_Datatype dt, MPI_Aint *true_lb,
                             MPI_Aint *true_extent) {
  int64_t tlb, text;
  int rc = true_extent_impl(dt, tlb, text);
  if (rc != MPI_SUCCESS) return rc;
  *true_lb = (MPI_Aint)tlb;
  *true_extent = (MPI_Aint)text;
  return MPI_SUCCESS;
}

int MPI_Type_get_true_extent_x(MPI_Datatype dt, MPI_Count *true_lb,
                               MPI_Count *true_extent) {
  int64_t tlb, text;
  int rc = true_extent_impl(dt, tlb, text);
  if (rc != MPI_SUCCESS) return rc;
  *true_lb = (MPI_Count)tlb;
  *true_extent = (MPI_Count)text;
  return MPI_SUCCESS;
}

int MPI_Type_get_extent_x(MPI_Datatype dt, MPI_Count *lb,
                          MPI_Count *extent) {
  long l, e;
  int rc = MPI_Type_get_extent(dt, &l, &e);
  if (rc != MPI_SUCCESS) return rc;
  *lb = (MPI_Count)l;
  *extent = (MPI_Count)e;
  return MPI_SUCCESS;
}

int MPI_Type_size_x(MPI_Datatype dt, MPI_Count *size) {
  int s;
  int rc = MPI_Type_size(dt, &s);
  if (rc != MPI_SUCCESS) return rc;
  *size = (MPI_Count)s;
  return MPI_SUCCESS;
}

int MPI_Type_get_envelope(MPI_Datatype dt, int *num_integers,
                          int *num_addresses, int *num_datatypes,
                          int *combiner) {
  if (dt < DERIVED_BASE) {
    DtInfo di;
    if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
    *num_integers = *num_addresses = *num_datatypes = 0;
    *combiner = MPI_COMBINER_NAMED;
    return MPI_SUCCESS;
  }
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end()) return MPI_ERR_TYPE;
  *num_integers = (int)it->second.env_ints.size();
  *num_addresses = (int)it->second.env_aints.size();
  *num_datatypes = (int)it->second.env_types.size();
  *combiner = it->second.combiner;
  return MPI_SUCCESS;
}

int MPI_Type_get_contents(MPI_Datatype dt, int max_integers,
                          int max_addresses, int max_datatypes,
                          int integers[], MPI_Aint addresses[],
                          MPI_Datatype datatypes[]) {
  if (dt < DERIVED_BASE) return MPI_ERR_TYPE;  // NAMED has no contents
  auto it = g_dtypes.find(dt);
  if (it == g_dtypes.end()) return MPI_ERR_TYPE;
  DtypeObj &d = it->second;
  if (max_integers < (int)d.env_ints.size() ||
      max_addresses < (int)d.env_aints.size() ||
      max_datatypes < (int)d.env_types.size())
    return MPI_ERR_ARG;
  for (size_t i = 0; i < d.env_ints.size(); i++)
    integers[i] = d.env_ints[i];
  for (size_t i = 0; i < d.env_aints.size(); i++)
    addresses[i] = (MPI_Aint)d.env_aints[i];
  for (size_t i = 0; i < d.env_types.size(); i++)
    datatypes[i] = d.env_types[i];
  return MPI_SUCCESS;
}

int MPI_Type_hvector(int count, int blocklength, MPI_Aint stride,
                     MPI_Datatype oldtype, MPI_Datatype *newtype) {
  return MPI_Type_create_hvector(count, blocklength, stride, oldtype,
                                 newtype);
}

int MPI_Type_hindexed(int count, int blocklengths[],
                      MPI_Aint displacements[], MPI_Datatype oldtype,
                      MPI_Datatype *newtype) {
  return MPI_Type_create_hindexed(count, blocklengths, displacements,
                                  oldtype, newtype);
}

int MPI_Type_struct(int count, int blocklengths[],
                    MPI_Aint displacements[], MPI_Datatype types[],
                    MPI_Datatype *newtype) {
  return MPI_Type_create_struct(count, blocklengths, displacements,
                                types, newtype);
}

int MPI_Type_extent(MPI_Datatype dt, MPI_Aint *extent) {
  long lb, e;
  int rc = MPI_Type_get_extent(dt, &lb, &e);
  if (rc != MPI_SUCCESS) return rc;
  *extent = (MPI_Aint)e;
  return MPI_SUCCESS;
}

int MPI_Type_lb(MPI_Datatype dt, MPI_Aint *lb) {
  long l, e;
  int rc = MPI_Type_get_extent(dt, &l, &e);
  if (rc != MPI_SUCCESS) return rc;
  *lb = (MPI_Aint)l;
  return MPI_SUCCESS;
}

int MPI_Type_ub(MPI_Datatype dt, MPI_Aint *ub) {
  long l, e;
  int rc = MPI_Type_get_extent(dt, &l, &e);
  if (rc != MPI_SUCCESS) return rc;
  *ub = (MPI_Aint)(l + e);
  return MPI_SUCCESS;
}

// ---------------------------------------------------- probe / any / all

namespace {

int probe_impl(int source, int tag, CommObj *c, int *flag,
               MPI_Status *status, bool blocking) {
  int src_world = source == MPI_ANY_SOURCE ? MPI_ANY_SOURCE
                                           : peer_world_of(*c, source);
  if (source != MPI_ANY_SOURCE && src_world < 0) return MPI_ERR_ARG;
  std::unique_lock<std::mutex> lk(g.match_mu);
  while (true) {
    for (auto &m : g.unexpected) {
      if (m.mhandle) continue;  // owned by a matched probe
      if (m.cid != c->cid_pt2pt) continue;
      if (src_world != MPI_ANY_SOURCE && m.src != src_world) continue;
      if (tag != MPI_ANY_TAG && m.tag != tag) continue;
      if (status) {
        status->MPI_SOURCE = (int)m.src;
        status->MPI_TAG = (int)m.tag;
        status->MPI_ERROR = MPI_SUCCESS;
        // bytes (Get_count converts); an announced-but-not-landed
        // rendezvous reports the size its RTS declared
        status->_count = m.rndv_pending ? (long long)m.rndv_nbytes
                                         : (long long)m.data.size();
        status->_cancelled = 0;
      }
      if (flag) *flag = 1;
      return MPI_SUCCESS;
    }
    if (!blocking) {
      if (flag) *flag = 0;
      return MPI_SUCCESS;
    }
    g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
    if (g.closing.load()) return MPI_ERR_OTHER;
  }
}

}  // namespace

int MPI_Probe(int source, int tag, MPI_Comm comm, MPI_Status *status) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  MPI_Status st{};
  int rc = probe_impl(source, tag, c, nullptr, &st, true);
  if (rc == MPI_SUCCESS && status) {
    *status = st;
    translate_status(c, status);
  }
  return rc;
}

int MPI_Iprobe(int source, int tag, MPI_Comm comm, int *flag,
               MPI_Status *status) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  MPI_Status st{};
  int rc = probe_impl(source, tag, c, flag, &st, false);
  if (rc == MPI_SUCCESS && *flag && status) {
    *status = st;
    translate_status(c, status);
  }
  return rc;
}

// ----------------------------------------- matched probe (round 5)
// mprobe.c family: Improbe EXTRACTS the first matching message from
// the unexpected queue (marks it owned; ordinary matching skips it)
// so a later Mrecv receives exactly that message — the thread-safe
// probe+recv idiom.  A rendezvous-pending message is claimed at
// Improbe time (the CTS goes out immediately); its payload lands in
// place and Mrecv/Imrecv completes from there.

static int64_t g_next_msg = 1;
// extracted-message bookkeeping: mhandle -> owning comm handle
static std::map<int64_t, int> g_msgs;

int MPI_Improbe(int source, int tag, MPI_Comm comm, int *flag,
                MPI_Message *message, MPI_Status *status) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (source == MPI_PROC_NULL) {
    *flag = 1;
    *message = MPI_MESSAGE_NO_PROC;
    empty_status(status);
    if (status) status->MPI_SOURCE = MPI_PROC_NULL;
    return MPI_SUCCESS;
  }
  int src_world = source == MPI_ANY_SOURCE ? MPI_ANY_SOURCE
                                           : peer_world_of(*c, source);
  if (source != MPI_ANY_SOURCE && src_world < 0) return MPI_ERR_ARG;
  int64_t cts_src = -1, cts_rid = -1;
  bool found = false;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (auto &m : g.unexpected) {
      if (m.mhandle) continue;
      if (m.cid != c->cid_pt2pt) continue;
      if (src_world != MPI_ANY_SOURCE && m.src != src_world) continue;
      if (tag != MPI_ANY_TAG && m.tag != tag) continue;
      m.mhandle = g_next_msg++;
      g_msgs[m.mhandle] = comm;
      if (m.rndv_pending) {
        // extraction IS the claim: release the sender; the bulk data
        // fills this message in place (CTS goes out after the lock
        // drops — the engine's ordering invariant)
        cts_src = m.src;
        cts_rid = m.rndv_id;
      }
      *message = (MPI_Message)m.mhandle;
      if (status) {
        status->MPI_SOURCE = (int)m.src;
        status->MPI_TAG = (int)m.tag;
        status->MPI_ERROR = MPI_SUCCESS;
        status->_count = m.rndv_pending ? (long long)m.rndv_nbytes
                                        : (long long)m.data.size();
        status->_cancelled = 0;
        translate_status(c, status);
      }
      found = true;
      break;
    }
  }
  if (found) {
    if (cts_src >= 0) send_cts(cts_src, cts_rid);
    *flag = 1;
    return MPI_SUCCESS;
  }
  *flag = 0;
  *message = MPI_MESSAGE_NULL;
  return MPI_SUCCESS;
}

int MPI_Mprobe(int source, int tag, MPI_Comm comm, MPI_Message *message,
               MPI_Status *status) {
  while (true) {
    int flag = 0;
    int rc = MPI_Improbe(source, tag, comm, &flag, message, status);
    if (rc != MPI_SUCCESS || flag) return rc;
    std::unique_lock<std::mutex> lk(g.match_mu);
    g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
    if (g.closing.load()) return MPI_ERR_OTHER;
  }
}

int MPI_Imrecv(void *buf, int count, MPI_Datatype dt,
               MPI_Message *message, MPI_Request *request) {
  if (!message) return MPI_ERR_ARG;
  if (*message == MPI_MESSAGE_NO_PROC) {
    *message = MPI_MESSAGE_NULL;
    Req *r0;
    *request = make_completed_req(MPI_COMM_WORLD, &r0);
    r0->status.MPI_SOURCE = MPI_PROC_NULL;  // the Irecv PROC_NULL shape
    r0->status.MPI_TAG = MPI_ANY_TAG;
    return MPI_SUCCESS;
  }
  if (*message == MPI_MESSAGE_NULL) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  auto gm = g_msgs.find(*message);
  if (gm == g_msgs.end()) return MPI_ERR_ARG;
  int comm = gm->second;
  Req *r = new Req;
  r->heap = true;
  r->is_recv = true;
  r->comm = comm;
  r->user_buf = buf;
  r->count = count;
  size_t want;
  char *land = prepare_landing(r, v, want);
  int handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
    Posted p{r, 0, MPI_ANY_SOURCE, MPI_ANY_TAG, land, want, v.di.item};
    for (auto it = g.unexpected.begin(); it != g.unexpected.end();
         ++it) {
      if (it->mhandle != (int64_t)*message) continue;
      if (it->rndv_pending) {
        // payload still in flight: park the landing plan; the fill
        // path (land_rndv_data) completes it
        g_mrecv_wait[it->mhandle] = p;
      } else {
        deliver(p, *it);
        g.unexpected.erase(it);
      }
      g_msgs.erase(gm);
      *message = MPI_MESSAGE_NULL;
      *request = handle;
      return MPI_SUCCESS;
    }
  }
  // extracted message vanished: only possible via engine teardown
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    g.reqs.erase(handle);
  }
  delete r;
  return MPI_ERR_OTHER;
}

int MPI_Mrecv(void *buf, int count, MPI_Datatype dt,
              MPI_Message *message, MPI_Status *status) {
  if (message && *message == MPI_MESSAGE_NO_PROC) {
    *message = MPI_MESSAGE_NULL;
    empty_status(status);
    if (status) status->MPI_SOURCE = MPI_PROC_NULL;
    return MPI_SUCCESS;
  }
  MPI_Request req;
  int rc = MPI_Imrecv(buf, count, dt, message, &req);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_Wait(&req, status);
}

MPI_Fint MPI_Message_c2f(MPI_Message message) {
  return (MPI_Fint)message;
}
MPI_Message MPI_Message_f2c(MPI_Fint message) {
  return (MPI_Message)message;
}

int MPI_Testany(int count, MPI_Request requests[], int *index, int *flag,
                MPI_Status *status) {
  // testany.c: one non-blocking scan of the set; persistent handles
  // (< MPI_REQUEST_NULL) count as ready when inactive or when their
  // inner active op completed
  bool any_active = false;
  int ready = -1;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < count && ready < 0; i++) {
      MPI_Request h = requests[i];
      if (h == MPI_REQUEST_NULL) continue;
      any_active = true;
      if (h < MPI_REQUEST_NULL) {
        auto pit = g_persistent.find(-h);
        if (pit == g_persistent.end()) return MPI_ERR_REQUEST;
        if (pit->second.active == MPI_REQUEST_NULL) {
          ready = i;  // inactive persistent tests as complete
        } else {
          auto it = g.reqs.find(pit->second.active);
          if (it == g.reqs.end()) return MPI_ERR_REQUEST;
          if (it->second->complete) ready = i;
        }
        continue;
      }
      auto it = g.reqs.find(h);
      if (it == g.reqs.end()) return MPI_ERR_REQUEST;
      if (it->second->complete) ready = i;
    }
  }
  if (!any_active) {
    *index = MPI_UNDEFINED;
    *flag = 1;
    empty_status(status);
    return MPI_SUCCESS;
  }
  if (ready < 0) {
    *flag = 0;
    *index = MPI_UNDEFINED;
    return MPI_SUCCESS;
  }
  *flag = 1;
  *index = ready;
  return MPI_Wait(&requests[ready], status);
}

int MPI_Waitany(int count, MPI_Request requests[], int *index,
                MPI_Status *status) {
  bool any_active = false;
  for (int i = 0; i < count; i++)
    if (requests[i] != MPI_REQUEST_NULL) any_active = true;
  if (!any_active) {
    *index = MPI_UNDEFINED;
    return MPI_SUCCESS;
  }
  while (true) {
    int ready = -1;
    {
      std::unique_lock<std::mutex> lk(g.match_mu);
      for (int i = 0; i < count && ready < 0; i++) {
        if (requests[i] == MPI_REQUEST_NULL) continue;
        auto it = g.reqs.find(requests[i]);
        if (it == g.reqs.end()) return MPI_ERR_REQUEST;
        if (it->second->complete) ready = i;
      }
      if (ready < 0) {
        g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
        if (g.closing.load()) return MPI_ERR_OTHER;
      }
    }
    if (ready >= 0) {
      *index = ready;
      return MPI_Wait(&requests[ready], status);
    }
  }
}

int MPI_Testall(int count, MPI_Request requests[], int *flag,
                MPI_Status statuses[]) {
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < count; i++) {
      if (requests[i] == MPI_REQUEST_NULL) continue;
      auto it = g.reqs.find(requests[i]);
      if (it == g.reqs.end()) return MPI_ERR_REQUEST;
      if (!it->second->complete) {
        *flag = 0;
        return MPI_SUCCESS;
      }
    }
  }
  *flag = 1;
  return MPI_Waitall(count, requests,
                     statuses ? statuses : MPI_STATUSES_IGNORE);
}

// ------------------------------------------------- scan/v-collectives

static int scan_wrapper(const void *sendbuf, void *recvbuf, int count,
                        MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                        bool exclusive) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int rc = clone_region(recvbuf, count, dt, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
  }
  return dispatch_comm_err(
      comm, c_scan(*c, sendbuf, recvbuf, count, dt, op, exclusive));
}

int MPI_Scan(const void *sendbuf, void *recvbuf, int count,
             MPI_Datatype dt, MPI_Op op, MPI_Comm comm) {
  return scan_wrapper(sendbuf, recvbuf, count, dt, op, comm, false);
}

int MPI_Exscan(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, MPI_Comm comm) {
  return scan_wrapper(sendbuf, recvbuf, count, dt, op, comm, true);
}

int MPI_Gatherv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, const int recvcounts[], const int displs[],
                MPI_Datatype recvtype, int root, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    if (c->local_rank != root)
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    const char *slice = (const char *)recvbuf +
                        (size_t)displs[root] * slot_bytes(rv, 1);
    int rc = clone_region(slice, recvcounts[root], recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcount = recvcounts[root];
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_gatherv(*c, sendbuf, sendcount, sendtype, recvbuf,
                      recvcounts, displs, recvtype, root));
}

int MPI_Allgatherv(const void *sendbuf, int sendcount,
                   MPI_Datatype sendtype, void *recvbuf,
                   const int recvcounts[], const int displs[],
                   MPI_Datatype recvtype, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int me = c->local_rank;
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    const char *slice = (const char *)recvbuf +
                        (size_t)displs[me] * slot_bytes(rv, 1);
    int rc = clone_region(slice, recvcounts[me], recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcount = recvcounts[me];
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_allgatherv(*c, sendbuf, sendcount, sendtype, recvbuf,
                         recvcounts, displs, recvtype));
}

int MPI_Scatterv(const void *sendbuf, const int sendcounts[],
                 const int displs[], MPI_Datatype sendtype, void *recvbuf,
                 int recvcount, MPI_Datatype recvtype, int root,
                 MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  if (root < 0 || root >= (int)c->group.size())
    return dispatch_comm_err(comm, MPI_ERR_ARG);
  std::vector<char> scratch;
  if (recvbuf == MPI_IN_PLACE) {
    if (c->local_rank != root)
      return dispatch_comm_err(comm, MPI_ERR_ARG);
    DtView sv;
    if (!resolve_dtype(sendtype, sv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    scratch.resize(slot_bytes(sv, sendcounts[root]));
    recvbuf = scratch.data();
    recvcount = sendcounts[root];
    recvtype = sendtype;
  }
  return dispatch_comm_err(
      comm, c_scatterv(*c, sendbuf, sendcounts, displs, sendtype,
                       recvbuf, recvcount, recvtype, root));
}

int MPI_Reduce_scatter_block(const void *sendbuf, void *recvbuf,
                             int recvcount, MPI_Datatype dt, MPI_Op op,
                             MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    // reduce_scatter_block.c: input is the FULL n*recvcount vector in
    // recvbuf
    int rc = clone_region(recvbuf,
                          (int)c->group.size() * recvcount, dt, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
  }
  return dispatch_comm_err(
      comm,
      c_reduce_scatter_block(*c, sendbuf, recvbuf, recvcount, dt, op));
}

int MPI_Reduce_scatter(const void *sendbuf, void *recvbuf,
                       const int recvcounts[], MPI_Datatype dt, MPI_Op op,
                       MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int total = 0;
    for (int r = 0; r < (int)c->group.size(); r++)
      total += recvcounts[r];
    int rc = clone_region(recvbuf, total, dt, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
  }
  return dispatch_comm_err(
      comm, c_reduce_scatter(*c, sendbuf, recvbuf, recvcounts, dt, op));
}

int MPI_Alltoallv(const void *sendbuf, const int sendcounts[],
                  const int sdispls[], MPI_Datatype sendtype,
                  void *recvbuf, const int recvcounts[],
                  const int rdispls[], MPI_Datatype recvtype,
                  MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    // alltoallv.c IN_PLACE: counts/displacements/type come from the
    // receive side; clone the full spanned region
    int n = (int)c->group.size();
    DtView rv;
    if (!resolve_dtype(recvtype, rv))
      return dispatch_comm_err(comm, MPI_ERR_TYPE);
    int span = 0;
    for (int r = 0; r < n; r++)
      if (rdispls[r] + recvcounts[r] > span)
        span = rdispls[r] + recvcounts[r];
    int rc = clone_region(recvbuf, span, recvtype, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcounts = recvcounts;
    sdispls = rdispls;
    sendtype = recvtype;
  }
  return dispatch_comm_err(
      comm, c_alltoallv(*c, sendbuf, sendcounts, sdispls, sendtype,
                        recvbuf, recvcounts, rdispls, recvtype));
}

// alltoallw.c IN_PLACE: everything comes from the receive side; clone
// each peer's block (byte displacements, per-peer types) into `tmp`.
// Validates counts/displacements BEFORE dereferencing anything.
static int alltoallw_inplace_clone(int n, const void *recvbuf,
                                   const int recvcounts[],
                                   const int rdispls[],
                                   const MPI_Datatype recvtypes[],
                                   std::vector<char> &tmp) {
  int64_t span = 0;
  for (int r = 0; r < n; r++) {
    if (recvcounts[r] < 0 || rdispls[r] < 0) return MPI_ERR_ARG;
    DtView rv;
    if (recvcounts[r] == 0) continue;
    if (!resolve_dtype(recvtypes[r], rv)) return MPI_ERR_TYPE;
    int64_t end = rdispls[r] + (int64_t)slot_bytes(rv, recvcounts[r]);
    if (end > span) span = end;
  }
  tmp.assign((size_t)span, 0);
  for (int r = 0; r < n; r++) {
    if (recvcounts[r] == 0) continue;
    DtView rv;
    resolve_dtype(recvtypes[r], rv);
    std::vector<char> packed;
    pack_dtype((const char *)recvbuf + rdispls[r], recvcounts[r], rv,
               packed);
    unpack_dtype(tmp.data() + rdispls[r], recvcounts[r], rv,
                 packed.data(), packed.size());
  }
  return MPI_SUCCESS;
}

int MPI_Alltoallw(const void *sendbuf, const int sendcounts[],
                  const int sdispls[], const MPI_Datatype sendtypes[],
                  void *recvbuf, const int recvcounts[],
                  const int rdispls[], const MPI_Datatype recvtypes[],
                  MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  int n = (int)c->group.size();
  std::vector<char> tmp;
  if (sendbuf == MPI_IN_PLACE) {
    int rc = alltoallw_inplace_clone(n, recvbuf, recvcounts, rdispls,
                                     recvtypes, tmp);
    if (rc != MPI_SUCCESS) return dispatch_comm_err(comm, rc);
    sendbuf = tmp.data();
    sendcounts = recvcounts;
    sdispls = rdispls;
    sendtypes = recvtypes;
  }
  return dispatch_comm_err(
      comm, c_alltoallw(*c, sendbuf, sendcounts, sdispls, sendtypes,
                        recvbuf, recvcounts, rdispls, recvtypes));
}

// ------------------------------------------------------------ user ops

int MPI_Op_create(MPI_User_function *function, int commute, MPI_Op *op) {
  if (!function || !op) return MPI_ERR_ARG;
  MPI_Op handle = g_next_op++;
  g_user_ops[handle] = UserOp{function, commute != 0};
  *op = handle;
  return MPI_SUCCESS;
}

int MPI_Op_free(MPI_Op *op) {
  if (!op || !g_user_ops.erase(*op)) return MPI_ERR_OP;
  *op = MPI_OP_NULL;
  return MPI_SUCCESS;
}

// --------------------------------------------------------- diagnostics

// user-added error classes/codes/strings (add_error_class.c family)
static std::map<int, std::string> g_err_strings;
static std::map<int, int> g_err_class;  // user code -> its class
static int g_next_err = MPI_ERR_LASTCODE + 1;

int MPI_Error_string(int errorcode, char *string, int *resultlen) {
  auto uit = g_err_strings.find(errorcode);
  if (uit != g_err_strings.end()) {
    snprintf(string, MPI_MAX_ERROR_STRING, "%s", uit->second.c_str());
    *resultlen = (int)strlen(string);
    return MPI_SUCCESS;
  }
  const char *s;
  switch (errorcode) {
    case MPI_SUCCESS:      s = "MPI_SUCCESS: no error"; break;
    case MPI_ERR_COMM:     s = "MPI_ERR_COMM: invalid communicator"; break;
    case MPI_ERR_TYPE:     s = "MPI_ERR_TYPE: invalid datatype"; break;
    case MPI_ERR_OP:       s = "MPI_ERR_OP: invalid reduction operation";
                           break;
    case MPI_ERR_REQUEST:  s = "MPI_ERR_REQUEST: invalid request"; break;
    case MPI_ERR_ARG:      s = "MPI_ERR_ARG: invalid argument"; break;
    case MPI_ERR_COUNT:    s = "MPI_ERR_COUNT: invalid count (message "
                               "exceeds the 4 GiB frame bound)"; break;
    case MPI_ERR_TRUNCATE: s = "MPI_ERR_TRUNCATE: message truncated";
                           break;
    case MPI_ERR_IN_STATUS: s = "MPI_ERR_IN_STATUS: see the status "
                                "array for per-request error codes";
                            break;
    case MPI_ERR_OTHER:    s = "MPI_ERR_OTHER: known error not in list";
                           break;
    default:               s = "unknown error code"; break;
  }
  snprintf(string, MPI_MAX_ERROR_STRING, "%s", s);
  *resultlen = (int)strlen(string);
  return MPI_SUCCESS;
}

int MPI_Type_get_extent(MPI_Datatype dt, long *lb, long *extent) {
  DtView v;
  if (!resolve_dtype(dt, v)) {
    // allow uncommitted derived types for extent queries
    auto it = g_dtypes.find(dt);
    if (it == g_dtypes.end()) return MPI_ERR_TYPE;
    DtInfo di;
    if (!base_dtinfo(it->second.base, di)) return MPI_ERR_TYPE;
    *lb = (long)(it->second.lb * (int64_t)di.item);
    *extent = (long)(it->second.extent * (int64_t)di.item);
    return MPI_SUCCESS;
  }
  *lb = (long)((v.derived ? v.derived->lb : 0) * (int64_t)v.di.item);
  *extent = (long)slot_bytes(v, 1);
  return MPI_SUCCESS;
}

// --------------------------------------------------------------- MPI-IO
// Byte-view file surface over POSIX at-offset IO (the romio-level C
// semantics with the default MPI_BYTE etype; collective open/close via
// the communicator's barrier, matching io_ompio_file_open.c's shape).

namespace {

FileObj *lookup_file(MPI_File fh) {
  std::lock_guard<std::mutex> lk(g_files_mu);
  auto it = g_files.find(fh);
  return it == g_files.end() ? nullptr : &it->second;
}

// fill an MPI_Status for a file transfer of `nbytes`
void file_status(MPI_Status *status, size_t nbytes) {
  if (status) {
    status->MPI_SOURCE = MPI_ANY_SOURCE;
    status->MPI_TAG = MPI_ANY_TAG;
    status->MPI_ERROR = MPI_SUCCESS;
    status->_count = (long long)nbytes;
    status->_cancelled = 0;
  }
}

// ---- file views (io_ompio's etype/filetype template) ----
// Map payload byte `pos` within the tiled filetype to its absolute
// file offset runs; fn(file_off, payload_delta, len) per run.  The
// identity view short-circuits to one run.  (std::function rather
// than a template: this sits inside the extern "C" block.)
void view_runs(FileObj *f, int64_t payload_off, int64_t nbytes,
               const std::function<void(int64_t, int64_t, int64_t)> &fn) {
  if (f->identity_view) {
    fn(f->view_disp + payload_off, (int64_t)0, nbytes);
    return;
  }
  int64_t done = 0;
  while (done < nbytes) {
    int64_t pos = payload_off + done;
    int64_t tile = pos / f->vpayload;
    int64_t rem = pos % f->vpayload;
    int64_t acc = 0;
    for (auto &b : f->vblocks) {
      if (rem < acc + b.second) {
        int64_t inblk = rem - acc;
        int64_t len = b.second - inblk;
        if (len > nbytes - done) len = nbytes - done;
        fn(f->view_disp + tile * f->vtile + b.first + inblk, done, len);
        done += len;
        break;
      }
      acc += b.second;
    }
  }
}

// view-aware positioned IO on PAYLOAD bytes; reads stop at the first
// short read (EOF semantics), writes demand completeness
// returns bytes read (stopping at EOF), or -1 on a REAL IO error —
// EBADF/EIO must surface as errors, not as success-at-EOF
int64_t view_pread(FileObj *f, int64_t payload_off, char *buf,
                   int64_t nbytes) {
  int64_t total = 0;
  bool stop = false, err = false;
  view_runs(f, payload_off, nbytes,
            [&](int64_t off, int64_t delta, int64_t len) {
              if (stop) return;
              ssize_t got = pread(f->fd, buf + delta, (size_t)len,
                                  (off_t)off);
              if (got < 0) {
                err = true;
                stop = true;
                return;
              }
              total += got;
              if (got < len) stop = true;
            });
  return err ? -1 : total;
}

int view_pwrite(FileObj *f, int64_t payload_off, const char *buf,
                int64_t nbytes, int64_t *wrote) {
  int64_t total = 0;
  bool fail = false;
  view_runs(f, payload_off, nbytes,
            [&](int64_t off, int64_t delta, int64_t len) {
              if (fail) return;
              ssize_t put = pwrite(f->fd, buf + delta, (size_t)len,
                                   (off_t)off);
              if (put != (ssize_t)len) {
                fail = true;
                if (put > 0) total += put;
                return;
              }
              total += put;
            });
  *wrote = total;
  return fail ? MPI_ERR_OTHER : MPI_SUCCESS;
}

// ---- shared file pointer (sharedfp/lockedfile's shape) ----
// flock-serialized sidecar holding the pointer in ETYPES; every rank
// of every process sees one serialization point.
int sfp_update(FileObj *f, int64_t delta, bool set, int64_t setval,
               int64_t *old_out) {
  int sfd = ::open(f->sfp_path.c_str(), O_CREAT | O_RDWR, 0644);
  if (sfd < 0) return MPI_ERR_FILE;
  if (flock(sfd, LOCK_EX) != 0) {
    ::close(sfd);
    return MPI_ERR_OTHER;
  }
  int64_t cur = 0;
  ssize_t got = pread(sfd, &cur, sizeof cur, 0);
  if (got != (ssize_t)sizeof cur) cur = 0;
  if (old_out) *old_out = cur;
  int64_t next = set ? setval : cur + delta;
  int rc = MPI_SUCCESS;
  if (pwrite(sfd, &next, sizeof next, 0) != (ssize_t)sizeof next)
    rc = MPI_ERR_OTHER;
  flock(sfd, LOCK_UN);
  ::close(sfd);
  return rc;
}

}  // namespace

int MPI_File_open(MPI_Comm comm, const char *filename, int amode,
                  MPI_Info, MPI_File *fh) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int rw = amode & (MPI_MODE_RDONLY | MPI_MODE_WRONLY | MPI_MODE_RDWR);
  int flags;
  if (rw == MPI_MODE_RDONLY) flags = O_RDONLY;
  else if (rw == MPI_MODE_WRONLY) flags = O_WRONLY;
  else if (rw == MPI_MODE_RDWR) flags = O_RDWR;
  else return MPI_ERR_AMODE;
  // collective create: rank 0 creates (EXCL honored there), peers open
  // the existing file after the barrier — no O_CREAT races
  int fd = -1;
  if (c->local_rank == 0) {
    int f0 = flags;
    if (amode & MPI_MODE_CREATE) f0 |= O_CREAT;
    if (amode & MPI_MODE_EXCL) f0 |= O_EXCL;
    fd = ::open(filename, f0, 0644);
  }
  int rc = c_barrier(*c);
  if (rc) return rc;
  if (c->local_rank != 0) fd = ::open(filename, flags);
  // collective agreement: if ANY rank failed (rank 0's EEXIST under
  // EXCL, a peer's EMFILE...), every rank fails — divergent outcomes
  // would deadlock the next collective file op
  int32_t ok = fd >= 0 ? 1 : 0, all_ok = 0;
  rc = c_allreduce(*c, &ok, &all_ok, 1, MPI_INT, MPI_MIN);
  if (rc) return rc;
  if (!all_ok) {
    if (fd >= 0) ::close(fd);
    return MPI_ERR_NO_SUCH_FILE;
  }
  FileObj f;
  f.fd = fd;
  f.amode = amode;
  f.comm = comm;
  f.path = filename;
  // shared file pointer sidecar: rank 0 resets it (the shared pointer
  // starts at zero on open, MPI-3.1 13.6.4), peers see it post-barrier
  f.sfp_path = std::string(filename) + ".zsfp";
  if (c->local_rank == 0) {
    int sfd = ::open(f.sfp_path.c_str(), O_CREAT | O_RDWR | O_TRUNC,
                     0644);
    if (sfd >= 0) {
      int64_t zero = 0;
      (void)!write(sfd, &zero, sizeof zero);
      ::close(sfd);
    }
  }
  rc = c_barrier(*c);
  if (rc) return rc;
  if (amode & MPI_MODE_APPEND) {
    struct stat st{};
    if (fstat(fd, &st) == 0) f.pointer = (int64_t)st.st_size;
  }
  int handle;
  {
    std::lock_guard<std::mutex> lk(g_files_mu);
    handle = g_next_file++;
    g_files[handle] = f;
  }
  *fh = handle;
  return MPI_SUCCESS;
}

int MPI_File_close(MPI_File *fh) {
  FileObj *f = fh ? lookup_file(*fh) : nullptr;
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  if (c) c_barrier(*c);  // all IO quiescent before any unlink
  ::close(f->fd);
  if (c && c->local_rank == 0) {
    ::unlink(f->sfp_path.c_str());  // sidecar dies with the handle
    if (f->amode & MPI_MODE_DELETE_ON_CLOSE) ::unlink(f->path.c_str());
  }
  if (c) c_barrier(*c);
  release_errh_ref(g_file_errh, *fh);
  {
    std::lock_guard<std::mutex> lk(g_files_mu);
    g_files.erase(*fh);
  }
  *fh = MPI_FILE_NULL;
  return MPI_SUCCESS;
}

int MPI_File_delete(const char *filename, MPI_Info) {
  return ::unlink(filename) == 0 ? MPI_SUCCESS : MPI_ERR_NO_SUCH_FILE;
}

int MPI_File_read_at(MPI_File fh, MPI_Offset offset, void *buf, int count,
                     MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  size_t want = (size_t)count * v.elems_per_item() * v.di.item;
  // `offset` is in ETYPES of the current view (bytes for the default)
  int64_t payload = offset * f->etype_size;
  int64_t got;
  if (v.contiguous()) {
    got = view_pread(f, payload, (char *)buf, (int64_t)want);
    if (got < 0) return MPI_ERR_OTHER;
  } else {
    std::vector<char> tmp(want);
    got = view_pread(f, payload, tmp.data(), (int64_t)want);
    if (got < 0) return MPI_ERR_OTHER;
    // short read past EOF: deliver what exists (MPI count semantics)
    unpack_dtype(buf, count, v, tmp.data(), (size_t)got);
  }
  file_status(status, (size_t)got);
  return MPI_SUCCESS;
}

int MPI_File_write_at(MPI_File fh, MPI_Offset offset, const void *buf,
                      int count, MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t payload = offset * f->etype_size;
  int64_t put = 0;
  int rc;
  if (v.contiguous()) {
    size_t nbytes = (size_t)count * v.elems_per_item() * v.di.item;
    rc = view_pwrite(f, payload, (const char *)buf, (int64_t)nbytes,
                     &put);
  } else {
    std::vector<char> packed;
    pack_dtype(buf, count, v, packed);
    rc = view_pwrite(f, payload, packed.data(), (int64_t)packed.size(),
                     &put);
  }
  if (rc != MPI_SUCCESS) return rc;
  file_status(status, (size_t)put);
  return MPI_SUCCESS;
}

int MPI_File_read(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                  MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int64_t off = f->pointer;
  // always read through a real status: the pointer advances by bytes
  // ACTUALLY read (short reads at EOF must not strand the pointer past
  // the data), whether or not the caller passed MPI_STATUS_IGNORE
  MPI_Status st{};
  int rc = MPI_File_read_at(fh, off, buf, count, dt, &st);
  if (rc == MPI_SUCCESS) {
    // the pointer advances in ETYPES; the status carries bytes
    f->pointer = off + st._count / (f->etype_size ? f->etype_size : 1);
    if (status) *status = st;
  }
  return rc;
}

int MPI_File_write(MPI_File fh, const void *buf, int count,
                   MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int64_t off = f->pointer;
  MPI_Status st{};
  int rc = MPI_File_write_at(fh, off, buf, count, dt, &st);
  if (rc == MPI_SUCCESS) {
    f->pointer = off + st._count / (f->etype_size ? f->etype_size : 1);
    if (status) *status = st;
  }
  return rc;
}

int MPI_File_seek(MPI_File fh, MPI_Offset offset, int whence) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (whence == MPI_SEEK_SET) {
    f->pointer = (int64_t)offset;
  } else if (whence == MPI_SEEK_CUR) {
    f->pointer += (int64_t)offset;
  } else if (whence == MPI_SEEK_END) {
    struct stat st{};
    if (fstat(f->fd, &st) != 0) return MPI_ERR_OTHER;
    // the pointer is in ETYPES of the current view
    f->pointer = (int64_t)st.st_size /
                     (f->etype_size ? f->etype_size : 1) +
                 (int64_t)offset;
  } else {
    return MPI_ERR_ARG;
  }
  return f->pointer < 0 ? MPI_ERR_ARG : MPI_SUCCESS;
}

int MPI_File_get_position(MPI_File fh, MPI_Offset *offset) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  *offset = (MPI_Offset)f->pointer;
  return MPI_SUCCESS;
}

int MPI_File_get_size(MPI_File fh, MPI_Offset *size) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  struct stat st{};
  if (fstat(f->fd, &st) != 0) return MPI_ERR_OTHER;
  *size = (MPI_Offset)st.st_size;
  return MPI_SUCCESS;
}

int MPI_File_set_size(MPI_File fh, MPI_Offset size) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  if (c) {
    int rc = c_barrier(*c);  // collective
    if (rc) return rc;
  }
  int rc = MPI_SUCCESS;
  if (!c || c->local_rank == 0)
    if (ftruncate(f->fd, (off_t)size) != 0) rc = MPI_ERR_OTHER;
  if (c) c_barrier(*c);
  return rc;
}

int MPI_File_sync(MPI_File fh) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  fsync(f->fd);
  CommObj *c = lookup_comm(f->comm);
  return c ? c_barrier(*c) : MPI_SUCCESS;
}

// -------------------------------------------- MPI-IO tier 2 (round 5)
// Views (file_set_view.c), collective and split collective IO
// (file_read_all.c, file_read_all_begin.c), shared-pointer IO
// (file_read_shared.c, file_read_ordered.c), nonblocking IO
// (file_iread.c family), preallocate/atomicity.

int MPI_File_set_view(MPI_File fh, MPI_Offset disp, MPI_Datatype etype,
                      MPI_Datatype filetype, const char *datarep,
                      MPI_Info) {
  // file_set_view.c: collective; resets both pointers.  The filetype
  // tiles the file from `disp`; only "native" representation (the
  // cluster is homogeneous — external32 lives on the Python plane).
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (datarep && strcmp(datarep, "native") != 0) return MPI_ERR_ARG;
  DtView ev, fv;
  if (!resolve_dtype(etype, ev) || !resolve_dtype(filetype, fv))
    return MPI_ERR_TYPE;
  if (disp < 0) return MPI_ERR_ARG;
  int64_t esize = ev.elems_per_item() * (int64_t)ev.di.item;
  if (esize <= 0) return MPI_ERR_TYPE;
  // byte-flatten one filetype item
  std::vector<std::pair<int64_t, int64_t>> blocks;
  int64_t item = (int64_t)fv.di.item;
  if (!fv.derived) {
    blocks.push_back({0, item});
  } else {
    for (auto &b : fv.derived->blocks)
      blocks.push_back({b.first * item, b.second * item});
  }
  int64_t tile = (fv.derived ? fv.derived->extent : 1) * item;
  int64_t payload = 0;
  for (auto &b : blocks) payload += b.second;
  if (payload <= 0 || payload % esize)
    return MPI_ERR_ARG;  // filetype must hold whole etypes
  f->view_disp = (int64_t)disp;
  f->view_etype = etype;
  f->view_ftype = filetype;
  f->vblocks = std::move(blocks);
  f->vtile = tile;
  f->vpayload = payload;
  f->etype_size = esize;
  // identity = one gap-free block tiling the file: the single-run
  // fast path already adds view_disp, and the etype size only scales
  // offsets (callers convert before mapping), so neither disqualifies
  f->identity_view = f->vblocks.size() == 1 &&
                     f->vblocks[0].first == 0 &&
                     f->vpayload == f->vtile;
  f->pointer = 0;
  int rc = sfp_update(f, 0, true, 0, nullptr);  // shared ptr resets too
  if (rc != MPI_SUCCESS) return rc;
  CommObj *c = lookup_comm(f->comm);
  return c ? c_barrier(*c) : MPI_SUCCESS;
}

int MPI_File_get_view(MPI_File fh, MPI_Offset *disp, MPI_Datatype *etype,
                      MPI_Datatype *filetype, char *datarep) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  *disp = (MPI_Offset)f->view_disp;
  *etype = f->view_etype;
  *filetype = f->view_ftype;
  if (datarep) strcpy(datarep, "native");
  return MPI_SUCCESS;
}

int MPI_File_get_byte_offset(MPI_File fh, MPI_Offset offset,
                             MPI_Offset *byte_offset) {
  // file_get_byte_offset.c: absolute byte of a view offset (etypes)
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int64_t payload = offset * f->etype_size;
  if (f->identity_view) {
    *byte_offset = (MPI_Offset)(f->view_disp + payload);
    return MPI_SUCCESS;
  }
  int64_t tile = payload / f->vpayload;
  int64_t rem = payload % f->vpayload;
  int64_t acc = 0, inoff = 0;
  for (auto &b : f->vblocks) {
    if (rem < acc + b.second) {
      inoff = b.first + (rem - acc);
      break;
    }
    acc += b.second;
  }
  *byte_offset = (MPI_Offset)(f->view_disp + tile * f->vtile + inoff);
  return MPI_SUCCESS;
}

int MPI_File_get_type_extent(MPI_File fh, MPI_Datatype dt,
                             MPI_Offset *extent) {
  // native representation: file extent == memory extent
  if (!lookup_file(fh)) return MPI_ERR_FILE;
  long lb, ext;
  int rc = MPI_Type_get_extent(dt, &lb, &ext);
  if (rc != MPI_SUCCESS) return rc;
  *extent = (MPI_Offset)ext;
  return MPI_SUCCESS;
}

int MPI_File_preallocate(MPI_File fh, MPI_Offset size) {
  // collective; grows the file to at least `size` bytes
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (size < 0) return MPI_ERR_ARG;
  CommObj *c = lookup_comm(f->comm);
  int64_t rc = MPI_SUCCESS;
  if (!c || c->local_rank == 0) {
    struct stat st{};
    if (fstat(f->fd, &st) != 0) rc = MPI_ERR_OTHER;
    else if (st.st_size < (off_t)size &&
             ftruncate(f->fd, (off_t)size) != 0)
      rc = MPI_ERR_OTHER;
  }
  if (!c) return (int)rc;
  // rank 0's outcome is everyone's outcome (collective uniformity)
  int brc = c_bcast(*c, &rc, 1, MPI_LONG, 0, 0x7E32);
  return brc != MPI_SUCCESS ? brc : (int)rc;
}

int MPI_File_set_atomicity(MPI_File fh, int flag) {
  // every write here is one positioned syscall (kernel-atomic), so
  // atomic mode is a recorded promise the engine already keeps
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  f->atomic_mode = flag != 0;
  CommObj *c = lookup_comm(f->comm);
  return c ? c_barrier(*c) : MPI_SUCCESS;
}

int MPI_File_get_atomicity(MPI_File fh, int *flag) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  *flag = f->atomic_mode ? 1 : 0;
  return MPI_SUCCESS;
}

// ---- collective IO: the engine's independent IO is already safe for
// concurrent disjoint accesses; the collective forms add the
// synchronization the interface promises (fcoll/individual's shape) ----

int MPI_File_read_at_all(MPI_File fh, MPI_Offset offset, void *buf,
                         int count, MPI_Datatype dt,
                         MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  if (c) c_barrier(*c);  // writers before this collective are visible
  return MPI_File_read_at(fh, offset, buf, count, dt, status);
}

int MPI_File_write_at_all(MPI_File fh, MPI_Offset offset,
                          const void *buf, int count, MPI_Datatype dt,
                          MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int rc = MPI_File_write_at(fh, offset, buf, count, dt, status);
  CommObj *c = lookup_comm(f->comm);
  if (c) c_barrier(*c);  // all blocks on disk before anyone returns
  return rc;
}

int MPI_File_read_all(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                      MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  if (c) c_barrier(*c);
  return MPI_File_read(fh, buf, count, dt, status);
}

int MPI_File_write_all(MPI_File fh, const void *buf, int count,
                       MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int rc = MPI_File_write(fh, buf, count, dt, status);
  CommObj *c = lookup_comm(f->comm);
  if (c) c_barrier(*c);
  return rc;
}

// ---- split collectives: begin performs the operation, end hands the
// stashed status back (file_read_all_begin.c semantics allow the
// implementation to complete eagerly; one outstanding pair per file) ----

namespace {

int split_begin(FileObj *f, int rc, const MPI_Status &st) {
  if (f->split_active) return MPI_ERR_OTHER;  // one pair at a time
  f->split_active = true;
  f->split_status = st;
  return rc;
}

int split_end(MPI_File fh, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (!f->split_active) return MPI_ERR_OTHER;
  f->split_active = false;
  if (status) *status = f->split_status;
  return MPI_SUCCESS;
}

}  // namespace

int MPI_File_read_all_begin(MPI_File fh, void *buf, int count,
                            MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;  // before any side effect
  MPI_Status st{};
  int rc = MPI_File_read_all(fh, buf, count, dt, &st);
  return split_begin(f, rc, st);
}

int MPI_File_read_all_end(MPI_File fh, void *, MPI_Status *status) {
  return split_end(fh, status);
}

int MPI_File_write_all_begin(MPI_File fh, const void *buf, int count,
                             MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;
  MPI_Status st{};
  int rc = MPI_File_write_all(fh, buf, count, dt, &st);
  return split_begin(f, rc, st);
}

int MPI_File_write_all_end(MPI_File fh, const void *, MPI_Status *status) {
  return split_end(fh, status);
}

int MPI_File_read_at_all_begin(MPI_File fh, MPI_Offset offset, void *buf,
                               int count, MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;
  MPI_Status st{};
  int rc = MPI_File_read_at_all(fh, offset, buf, count, dt, &st);
  return split_begin(f, rc, st);
}

int MPI_File_read_at_all_end(MPI_File fh, void *, MPI_Status *status) {
  return split_end(fh, status);
}

int MPI_File_write_at_all_begin(MPI_File fh, MPI_Offset offset,
                                const void *buf, int count,
                                MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;
  MPI_Status st{};
  int rc = MPI_File_write_at_all(fh, offset, buf, count, dt, &st);
  return split_begin(f, rc, st);
}

int MPI_File_write_at_all_end(MPI_File fh, const void *,
                              MPI_Status *status) {
  return split_end(fh, status);
}

// ---- shared file pointer IO ----

int MPI_File_read_shared(MPI_File fh, void *buf, int count,
                         MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t want = (int64_t)count * v.elems_per_item() * v.di.item;
  int64_t etypes = want / (f->etype_size ? f->etype_size : 1);
  int64_t old = 0;
  int rc = sfp_update(f, etypes, false, 0, &old);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_File_read_at(fh, (MPI_Offset)old, buf, count, dt, status);
}

int MPI_File_write_shared(MPI_File fh, const void *buf, int count,
                          MPI_Datatype dt, MPI_Status *status) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t want = (int64_t)count * v.elems_per_item() * v.di.item;
  int64_t etypes = want / (f->etype_size ? f->etype_size : 1);
  int64_t old = 0;
  int rc = sfp_update(f, etypes, false, 0, &old);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_File_write_at(fh, (MPI_Offset)old, buf, count, dt, status);
}

int MPI_File_seek_shared(MPI_File fh, MPI_Offset offset, int whence) {
  // collective (file_seek_shared.c); rank 0 applies, all synchronize
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  int64_t rc = MPI_SUCCESS;
  if (!c || c->local_rank == 0) {
    int64_t base = 0;
    if (whence == MPI_SEEK_CUR) {
      rc = sfp_update(f, 0, false, 0, &base);
    } else if (whence == MPI_SEEK_END) {
      struct stat st{};
      if (fstat(f->fd, &st) != 0) rc = MPI_ERR_OTHER;
      else
        base = (int64_t)st.st_size /
               (f->etype_size ? f->etype_size : 1);
    } else if (whence != MPI_SEEK_SET) {
      rc = MPI_ERR_ARG;
    }
    if (rc == MPI_SUCCESS)
      rc = sfp_update(f, 0, true, base + (int64_t)offset, nullptr);
  }
  if (!c) return (int)rc;
  // rank 0's outcome rides to everyone (an early divergence would
  // leave peers believing the shared pointer moved)
  int brc = c_bcast(*c, &rc, 1, MPI_LONG, 0, 0x7E33);
  return brc != MPI_SUCCESS ? brc : (int)rc;
}

int MPI_File_get_position_shared(MPI_File fh, MPI_Offset *offset) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  int64_t cur = 0;
  int rc = sfp_update(f, 0, false, 0, &cur);
  if (rc != MPI_SUCCESS) return rc;
  *offset = (MPI_Offset)cur;
  return MPI_SUCCESS;
}

// ---- ordered (rank-sequential) shared IO: exscan computes each
// rank's slice of the shared region, the last total advances the
// pointer once (file_read_ordered.c semantics without serialization) ----

namespace {

int ordered_io(MPI_File fh, void *buf, int count, MPI_Datatype dt,
               MPI_Status *status, bool writing) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(f->comm);
  if (!c) return MPI_ERR_COMM;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t mine = ((int64_t)count * v.elems_per_item() * v.di.item) /
                 (f->etype_size ? f->etype_size : 1);
  int64_t prefix = 0, total = 0;
  int rc = c_scan(*c, &mine, &prefix, 1, MPI_LONG, MPI_SUM, true);
  if (rc != MPI_SUCCESS) return rc;
  rc = c_allreduce(*c, &mine, &total, 1, MPI_LONG, MPI_SUM);
  if (rc != MPI_SUCCESS) return rc;
  // rank 0 advances the shared pointer; its outcome rides the bcast so
  // a sidecar failure is UNIFORM (an early return would strand the
  // other ranks inside the bcast)
  int64_t msg[2] = {0, MPI_SUCCESS};
  if (c->local_rank == 0)
    msg[1] = sfp_update(f, total, false, 0, &msg[0]);
  rc = c_bcast(*c, msg, 2, MPI_LONG, 0, 0x7E31);
  if (rc != MPI_SUCCESS) return rc;
  if (msg[1] != MPI_SUCCESS) return (int)msg[1];
  MPI_Offset at = (MPI_Offset)(msg[0] + prefix);
  rc = writing ? MPI_File_write_at(fh, at, buf, count, dt, status)
               : MPI_File_read_at(fh, at, buf, count, dt, status);
  int rc2 = c_barrier(*c);  // ordered IO is collective
  return rc != MPI_SUCCESS ? rc : rc2;
}

}  // namespace

int MPI_File_read_ordered(MPI_File fh, void *buf, int count,
                          MPI_Datatype dt, MPI_Status *status) {
  return ordered_io(fh, buf, count, dt, status, false);
}

int MPI_File_write_ordered(MPI_File fh, const void *buf, int count,
                           MPI_Datatype dt, MPI_Status *status) {
  return ordered_io(fh, (void *)buf, count, dt, status, true);
}

int MPI_File_read_ordered_begin(MPI_File fh, void *buf, int count,
                                MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;
  MPI_Status st{};
  int rc = ordered_io(fh, buf, count, dt, &st, false);
  return split_begin(f, rc, st);
}

int MPI_File_read_ordered_end(MPI_File fh, void *, MPI_Status *status) {
  return split_end(fh, status);
}

int MPI_File_write_ordered_begin(MPI_File fh, const void *buf, int count,
                                 MPI_Datatype dt) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  if (f->split_active) return MPI_ERR_OTHER;
  MPI_Status st{};
  int rc = ordered_io(fh, (void *)buf, count, dt, &st, true);
  return split_begin(f, rc, st);
}

int MPI_File_write_ordered_end(MPI_File fh, const void *,
                               MPI_Status *status) {
  return split_end(fh, status);
}

// ---- nonblocking IO (file_iread.c family): the blocking form runs on
// a background thread and retires through the request engine, exactly
// the fbtl_posix ipreadv shape ----

namespace {

int file_ispawn(std::function<int(MPI_Status *)> body,
                MPI_Request *request) {
  Req *r = new Req;
  r->heap = true;
  r->comm = MPI_COMM_WORLD;
  int handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
  }
  std::thread t([r, body]() {
    MPI_Status st{};
    int rc = body(&st);
    std::lock_guard<std::mutex> lk(g.match_mu);
    r->status = st;
    r->status.MPI_ERROR = rc;
    r->complete = true;
    g.match_cv.notify_all();
  });
  {
    std::lock_guard<std::mutex> lk(g.threads_mu);
    g.threads.push_back(std::move(t));
  }
  *request = handle;
  return MPI_SUCCESS;
}

}  // namespace

int MPI_File_iread_at(MPI_File fh, MPI_Offset offset, void *buf,
                      int count, MPI_Datatype dt, MPI_Request *request) {
  if (!lookup_file(fh)) return MPI_ERR_FILE;
  return file_ispawn(
      [fh, offset, buf, count, dt](MPI_Status *st) {
        return MPI_File_read_at(fh, offset, buf, count, dt, st);
      },
      request);
}

int MPI_File_iwrite_at(MPI_File fh, MPI_Offset offset, const void *buf,
                       int count, MPI_Datatype dt,
                       MPI_Request *request) {
  if (!lookup_file(fh)) return MPI_ERR_FILE;
  return file_ispawn(
      [fh, offset, buf, count, dt](MPI_Status *st) {
        return MPI_File_write_at(fh, offset, buf, count, dt, st);
      },
      request);
}

int MPI_File_iread(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                   MPI_Request *request) {
  // the pointer advances NOW (the op owns its slice; a later iread
  // must not overlap it) — the data lands when the request completes
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t off = f->pointer;
  f->pointer += ((int64_t)count * v.elems_per_item() * v.di.item) /
                (f->etype_size ? f->etype_size : 1);
  return MPI_File_iread_at(fh, (MPI_Offset)off, buf, count, dt,
                           request);
}

int MPI_File_iwrite(MPI_File fh, const void *buf, int count,
                    MPI_Datatype dt, MPI_Request *request) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t off = f->pointer;
  f->pointer += ((int64_t)count * v.elems_per_item() * v.di.item) /
                (f->etype_size ? f->etype_size : 1);
  return MPI_File_iwrite_at(fh, (MPI_Offset)off, buf, count, dt,
                            request);
}

int MPI_File_iread_shared(MPI_File fh, void *buf, int count,
                          MPI_Datatype dt, MPI_Request *request) {
  // claim the shared slice NOW, read it in the background
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t etypes = ((int64_t)count * v.elems_per_item() * v.di.item) /
                   (f->etype_size ? f->etype_size : 1);
  int64_t old = 0;
  int rc = sfp_update(f, etypes, false, 0, &old);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_File_iread_at(fh, (MPI_Offset)old, buf, count, dt,
                           request);
}

int MPI_File_iwrite_shared(MPI_File fh, const void *buf, int count,
                           MPI_Datatype dt, MPI_Request *request) {
  FileObj *f = lookup_file(fh);
  if (!f) return MPI_ERR_FILE;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  int64_t etypes = ((int64_t)count * v.elems_per_item() * v.di.item) /
                   (f->etype_size ? f->etype_size : 1);
  int64_t old = 0;
  int rc = sfp_update(f, etypes, false, 0, &old);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_File_iwrite_at(fh, (MPI_Offset)old, buf, count, dt,
                            request);
}

int MPI_File_iread_at_all(MPI_File fh, MPI_Offset offset, void *buf,
                          int count, MPI_Datatype dt,
                          MPI_Request *request) {
  // "all" adds collectivity to completion, not initiation; the
  // independent nonblocking form satisfies both here
  return MPI_File_iread_at(fh, offset, buf, count, dt, request);
}

int MPI_File_iwrite_at_all(MPI_File fh, MPI_Offset offset,
                           const void *buf, int count, MPI_Datatype dt,
                           MPI_Request *request) {
  return MPI_File_iwrite_at(fh, offset, buf, count, dt, request);
}

int MPI_File_iread_all(MPI_File fh, void *buf, int count,
                       MPI_Datatype dt, MPI_Request *request) {
  return MPI_File_iread(fh, buf, count, dt, request);
}

int MPI_File_iwrite_all(MPI_File fh, const void *buf, int count,
                        MPI_Datatype dt, MPI_Request *request) {
  return MPI_File_iwrite(fh, buf, count, dt, request);
}

int MPI_Register_datarep(const char *datarep, void *, void *, void *,
                         void *) {
  // register_datarep.c surface: only "native" exists on this
  // homogeneous engine; registering it is idempotent, anything else
  // is rejected loudly rather than silently unconverted
  if (datarep && strcmp(datarep, "native") == 0) return MPI_SUCCESS;
  return MPI_ERR_ARG;
}

// ------------------------------------------------------- pack / unpack
// The convertor surface (ompi/mpi/c/pack.c:45): positions advance in
// bytes through a caller-owned packing buffer.

int MPI_Pack_size(int incount, MPI_Datatype dt, MPI_Comm, int *size) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  *size = (int)((int64_t)incount * v.elems_per_item() * v.di.item);
  return MPI_SUCCESS;
}

int MPI_Pack(const void *inbuf, int incount, MPI_Datatype dt,
             void *outbuf, int outsize, int *position, MPI_Comm) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  if (!position || *position < 0) return MPI_ERR_ARG;
  size_t nbytes = (size_t)incount * v.elems_per_item() * v.di.item;
  if ((size_t)*position + nbytes > (size_t)outsize) return MPI_ERR_TRUNCATE;
  char *dst = (char *)outbuf + *position;
  if (v.contiguous()) {
    memcpy(dst, inbuf, nbytes);
  } else {
    std::vector<char> packed;
    pack_dtype(inbuf, incount, v, packed);
    memcpy(dst, packed.data(), packed.size());
  }
  *position += (int)nbytes;
  return MPI_SUCCESS;
}

int MPI_Unpack(const void *inbuf, int insize, int *position, void *outbuf,
               int outcount, MPI_Datatype dt, MPI_Comm) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  if (!position || *position < 0) return MPI_ERR_ARG;
  size_t nbytes = (size_t)outcount * v.elems_per_item() * v.di.item;
  if ((size_t)*position + nbytes > (size_t)insize) return MPI_ERR_TRUNCATE;
  const char *src = (const char *)inbuf + *position;
  if (v.contiguous()) {
    memcpy(outbuf, src, nbytes);
  } else {
    unpack_dtype(outbuf, outcount, v, src, nbytes);
  }
  *position += (int)nbytes;
  return MPI_SUCCESS;
}

// --------------------------------------------- nonblocking collectives
// ibcast.c:36 family: the tag sequence is RESERVED at call time (fixing
// the op's place in the comm's collective order, MPI's same-order law),
// then the blocking algorithm runs against a comm snapshot on a
// background thread and retires through the request engine.

namespace {

int icoll_spawn(std::function<int()> body, MPI_Comm comm,
                MPI_Request *request) {
  Req *r = new Req;
  r->heap = true;
  r->comm = comm;
  int handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
  }
  g.inflight_isends.fetch_add(1);
  std::thread([body, r]() {
    int rc = body();
    {
      std::lock_guard<std::mutex> lk(g.match_mu);
      r->status.MPI_ERROR = rc;
      r->complete = true;
    }
    g.match_cv.notify_all();
    g.inflight_isends.fetch_sub(1);
  }).detach();
  *request = handle;
  return MPI_SUCCESS;
}

}  // namespace

namespace {

// snapshot the comm with this op's tag slot(s) RESERVED in program
// order; `slots` = number of coll_seq increments the algorithm performs
std::shared_ptr<CommObj> icoll_reserve(CommObj *c, int slots = 1) {
  auto snap = std::make_shared<CommObj>(*c);
  c->coll_seq += slots;
  return snap;
}

}  // namespace

int MPI_Ibcast(void *buf, int count, MPI_Datatype dt, int root,
               MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, buf, count, dt, root]() {
        return c_bcast(*snap, buf, count, dt, root, 0x7E01);
      },
      comm, request);
}

// MPI-3.1 5.12: IN_PLACE extends to every nonblocking collective.
// The receive-side contribution is cloned NOW (the caller may touch
// nothing until completion, but the engine must not read the sentinel
// address) and the clone is owned by each closure — captured
// EXPLICITLY, since [=] would not keep a shared_ptr the body never
// names alive.
// NOTE: the slice/span arithmetic MIRRORS the blocking wrappers
// (MPI_Allreduce ... MPI_Alltoallv above) — fix BOTH copies or
// extract a helper when touching either.
static int icoll_inplace(const void *&sendbuf, const void *src,
                         int count, MPI_Datatype dt,
                         std::shared_ptr<std::vector<char>> &keep) {
  if (sendbuf != MPI_IN_PLACE) return MPI_SUCCESS;
  keep = std::make_shared<std::vector<char>>();
  int rc = clone_region(src, count, dt, *keep);
  if (rc != MPI_SUCCESS) return rc;
  sendbuf = keep->data();
  return MPI_SUCCESS;
}

int MPI_Iallreduce(const void *sendbuf, void *recvbuf, int count,
                   MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                   MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::shared_ptr<std::vector<char>> keep;
  int rc = icoll_inplace(sendbuf, recvbuf, count, dt, keep);
  if (rc != MPI_SUCCESS) return rc;
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, recvbuf, count, dt, op]() {
        return c_allreduce(*snap, sendbuf, recvbuf, count, dt, op);
      },
      comm, request);
}

int MPI_Ireduce(const void *sendbuf, void *recvbuf, int count,
                MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm,
                MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    if (c->local_rank != root) return MPI_ERR_ARG;  // root only
    int rc = icoll_inplace(sendbuf, recvbuf, count, dt, keep);
    if (rc != MPI_SUCCESS) return rc;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, recvbuf, count, dt, op, root]() {
        return c_reduce(*snap, sendbuf, recvbuf, count, dt, op, root);
      },
      comm, request);
}

int MPI_Igather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, int recvcount, MPI_Datatype recvtype,
                int root, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    if (c->local_rank != root) return MPI_ERR_ARG;
    DtView rv;
    if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
    const char *slice =
        (const char *)recvbuf + (size_t)root * slot_bytes(rv, recvcount);
    int rc = icoll_inplace(sendbuf, slice, recvcount, recvtype, keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcount = recvcount;
    sendtype = recvtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, sendcount, sendtype, recvbuf, recvcount,
       recvtype, root]() {
        return c_gather(*snap, sendbuf, sendcount, sendtype, recvbuf,
                        recvcount, recvtype, root);
      },
      comm, request);
}

int MPI_Iscatter(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                 void *recvbuf, int recvcount, MPI_Datatype recvtype,
                 int root, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  std::shared_ptr<std::vector<char>> scratch;
  if (recvbuf == MPI_IN_PLACE) {
    if (c->local_rank != root) return MPI_ERR_ARG;
    DtView sv;
    if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
    scratch = std::make_shared<std::vector<char>>(
        slot_bytes(sv, sendcount));
    recvbuf = scratch->data();
    recvcount = sendcount;
    recvtype = sendtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, scratch, sendbuf, sendcount, sendtype, recvbuf, recvcount,
       recvtype, root]() {
        return c_scatter(*snap, sendbuf, sendcount, sendtype, recvbuf,
                         recvcount, recvtype, root);
      },
      comm, request);
}

int MPI_Iallgather(const void *sendbuf, int sendcount,
                   MPI_Datatype sendtype, void *recvbuf, int recvcount,
                   MPI_Datatype recvtype, MPI_Comm comm,
                   MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    DtView rv;
    if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
    const char *slice = (const char *)recvbuf +
                        (size_t)c->local_rank *
                            slot_bytes(rv, recvcount);
    int rc = icoll_inplace(sendbuf, slice, recvcount, recvtype, keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcount = recvcount;
    sendtype = recvtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, sendcount, sendtype, recvbuf, recvcount,
       recvtype]() {
        return c_allgather(*snap, sendbuf, sendcount, sendtype, recvbuf,
                           recvcount, recvtype);
      },
      comm, request);
}

int MPI_Ialltoall(const void *sendbuf, int sendcount,
                  MPI_Datatype sendtype, void *recvbuf, int recvcount,
                  MPI_Datatype recvtype, MPI_Comm comm,
                  MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    int rc = icoll_inplace(sendbuf, recvbuf,
                           (int)c->group.size() * recvcount, recvtype,
                           keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcount = recvcount;
    sendtype = recvtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, sendcount, sendtype, recvbuf, recvcount,
       recvtype]() {
        return c_alltoall(*snap, sendbuf, sendcount, sendtype, recvbuf,
                          recvcount, recvtype);
      },
      comm, request);
}

static int iscan_impl(const void *sendbuf, void *recvbuf, int count,
                      MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                      MPI_Request *request, bool exclusive) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::shared_ptr<std::vector<char>> keep;
  int rc = icoll_inplace(sendbuf, recvbuf, count, dt, keep);
  if (rc != MPI_SUCCESS) return rc;
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sendbuf, recvbuf, count, dt, op, exclusive]() {
        return c_scan(*snap, sendbuf, recvbuf, count, dt, op,
                      exclusive);
      },
      comm, request);
}

int MPI_Iscan(const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
              MPI_Request *request) {
  return iscan_impl(sendbuf, recvbuf, count, dt, op, comm, request,
                    false);
}

int MPI_Iexscan(const void *sendbuf, void *recvbuf, int count,
                MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                MPI_Request *request) {
  return iscan_impl(sendbuf, recvbuf, count, dt, op, comm, request,
                    true);
}

int MPI_Ireduce_scatter_block(const void *sendbuf, void *recvbuf,
                              int recvcount, MPI_Datatype dt, MPI_Op op,
                              MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    int rc = icoll_inplace(sendbuf, recvbuf,
                           (int)c->group.size() * recvcount, dt, keep);
    if (rc != MPI_SUCCESS) return rc;
  }
  auto snap = icoll_reserve(c, 2);  // reduce + scatter under the hood
  return icoll_spawn(
      [snap, keep, sendbuf, recvbuf, recvcount, dt, op]() {
        return c_reduce_scatter_block(*snap, sendbuf, recvbuf, recvcount,
                                      dt, op);
      },
      comm, request);
}

namespace {

// snapshot an int array the caller may reuse at return (MPI rule);
// roots_only captures nothing on non-roots (they may legally pass
// NULL).  data_or_null() is the unwrap the c_* helpers expect.
struct IcollArray {
  std::shared_ptr<std::vector<int>> v;
  IcollArray(const int *p, int n, bool capture)
      : v(std::make_shared<std::vector<int>>(
            capture ? std::vector<int>(p, p + n) : std::vector<int>())) {}
  const int *data_or_null() const {
    return v->empty() ? nullptr : v->data();
  }
};

}  // namespace

int MPI_Igatherv(const void *sendbuf, int sendcount,
                 MPI_Datatype sendtype, void *recvbuf,
                 const int recvcounts[], const int displs[],
                 MPI_Datatype recvtype, int root, MPI_Comm comm,
                 MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  int n = (int)c->group.size();
  bool im_root = c->local_rank == root;
  IcollArray rc_(recvcounts, n, im_root), dp(displs, n, im_root);
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    if (!im_root) return MPI_ERR_ARG;
    DtView rv;
    if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
    const char *slice = (const char *)recvbuf +
                        (size_t)displs[root] * slot_bytes(rv, 1);
    int rc = icoll_inplace(sendbuf, slice, recvcounts[root], recvtype,
                           keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcount = recvcounts[root];
    sendtype = recvtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, rc_, dp, sendbuf, sendcount, sendtype, recvbuf,
       recvtype, root]() {
        return c_gatherv(*snap, sendbuf, sendcount, sendtype, recvbuf,
                         rc_.data_or_null(), dp.data_or_null(), recvtype,
                         root);
      },
      comm, request);
}

int MPI_Iscatterv(const void *sendbuf, const int sendcounts[],
                  const int displs[], MPI_Datatype sendtype,
                  void *recvbuf, int recvcount, MPI_Datatype recvtype,
                  int root, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  int n = (int)c->group.size();
  bool im_root = c->local_rank == root;
  IcollArray sc(sendcounts, n, im_root), dp(displs, n, im_root);
  std::shared_ptr<std::vector<char>> scratch;
  if (recvbuf == MPI_IN_PLACE) {
    if (!im_root) return MPI_ERR_ARG;
    DtView sv;
    if (!resolve_dtype(sendtype, sv)) return MPI_ERR_TYPE;
    scratch = std::make_shared<std::vector<char>>(
        slot_bytes(sv, sendcounts[root]));
    recvbuf = scratch->data();
    recvcount = sendcounts[root];
    recvtype = sendtype;
  }
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, scratch, sc, dp, sendbuf, sendtype, recvbuf, recvcount,
       recvtype, root]() {
        return c_scatterv(*snap, sendbuf, sc.data_or_null(),
                          dp.data_or_null(), sendtype, recvbuf,
                          recvcount, recvtype, root);
      },
      comm, request);
}

int MPI_Iallgatherv(const void *sendbuf, int sendcount,
                    MPI_Datatype sendtype, void *recvbuf,
                    const int recvcounts[], const int displs[],
                    MPI_Datatype recvtype, MPI_Comm comm,
                    MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int n = (int)c->group.size();
  IcollArray rc_(recvcounts, n, true), dp(displs, n, true);
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    int me = c->local_rank;
    DtView rv;
    if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
    const char *slice = (const char *)recvbuf +
                        (size_t)displs[me] * slot_bytes(rv, 1);
    int rc = icoll_inplace(sendbuf, slice, recvcounts[me], recvtype,
                           keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcount = recvcounts[me];
    sendtype = recvtype;
  }
  auto snap = icoll_reserve(c, n);  // n rooted broadcasts inside
  return icoll_spawn(
      [snap, keep, rc_, dp, sendbuf, sendcount, sendtype, recvbuf,
       recvtype]() {
        return c_allgatherv(*snap, sendbuf, sendcount, sendtype, recvbuf,
                            rc_.data_or_null(), dp.data_or_null(),
                            recvtype);
      },
      comm, request);
}

int MPI_Ireduce_scatter(const void *sendbuf, void *recvbuf,
                        const int recvcounts[], MPI_Datatype dt,
                        MPI_Op op, MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int n = (int)c->group.size();
  auto counts = std::make_shared<std::vector<int>>(recvcounts,
                                                   recvcounts + n);
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    int total = 0;
    for (int r = 0; r < n; r++) total += recvcounts[r];
    int rc = icoll_inplace(sendbuf, recvbuf, total, dt, keep);
    if (rc != MPI_SUCCESS) return rc;
  }
  auto snap = icoll_reserve(c, 2);  // reduce + scatterv under the hood
  return icoll_spawn(
      [snap, keep, counts, sendbuf, recvbuf, dt, op]() {
        return c_reduce_scatter(*snap, sendbuf, recvbuf, counts->data(),
                                dt, op);
      },
      comm, request);
}

int MPI_Ialltoallv(const void *sendbuf, const int sendcounts[],
                   const int sdispls[], MPI_Datatype sendtype,
                   void *recvbuf, const int recvcounts[],
                   const int rdispls[], MPI_Datatype recvtype,
                   MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int n = (int)c->group.size();
  std::shared_ptr<std::vector<char>> keep;
  if (sendbuf == MPI_IN_PLACE) {
    // the receive side defines everything (alltoallv.c IN_PLACE)
    DtView rv;
    if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
    int span = 0;
    for (int r = 0; r < n; r++)
      if (rdispls[r] + recvcounts[r] > span)
        span = rdispls[r] + recvcounts[r];
    int rc = icoll_inplace(sendbuf, recvbuf, span, recvtype, keep);
    if (rc != MPI_SUCCESS) return rc;
    sendcounts = recvcounts;
    sdispls = rdispls;
    sendtype = recvtype;
  }
  // MPI lets the caller reuse the count/displacement arrays the moment
  // the call returns — snapshot them for the background thread
  auto sc = std::make_shared<std::vector<int>>(sendcounts, sendcounts + n);
  auto sd = std::make_shared<std::vector<int>>(sdispls, sdispls + n);
  auto rc_ = std::make_shared<std::vector<int>>(recvcounts,
                                                recvcounts + n);
  auto rd = std::make_shared<std::vector<int>>(rdispls, rdispls + n);
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [snap, keep, sc, sd, rc_, rd, sendbuf, sendtype, recvbuf,
       recvtype]() {
        return c_alltoallv(*snap, sendbuf, sc->data(), sd->data(),
                           sendtype, recvbuf, rc_->data(), rd->data(),
                           recvtype);
      },
      comm, request);
}

int MPI_Ialltoallw(const void *sendbuf, const int sendcounts[],
                   const int sdispls[], const MPI_Datatype sendtypes[],
                   void *recvbuf, const int recvcounts[],
                   const int rdispls[], const MPI_Datatype recvtypes[],
                   MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int n = (int)c->group.size();
  // MPI-3.1 5.12 extends IN_PLACE to the nonblocking collectives: the
  // send arrays are then absent (often NULL) — same clone as the
  // blocking wrapper, owned by the lambda so it outlives the run
  auto tmp = std::make_shared<std::vector<char>>();
  if (sendbuf == MPI_IN_PLACE) {
    int rc = alltoallw_inplace_clone(n, recvbuf, recvcounts, rdispls,
                                     recvtypes, *tmp);
    if (rc != MPI_SUCCESS) return rc;
    sendbuf = tmp->data();
    sendcounts = recvcounts;
    sdispls = rdispls;
    sendtypes = recvtypes;
  }
  auto sc = std::make_shared<std::vector<int>>(sendcounts,
                                               sendcounts + n);
  auto sd = std::make_shared<std::vector<int>>(sdispls, sdispls + n);
  auto st2 = std::make_shared<std::vector<MPI_Datatype>>(sendtypes,
                                                         sendtypes + n);
  auto rc_ = std::make_shared<std::vector<int>>(recvcounts,
                                                recvcounts + n);
  auto rd = std::make_shared<std::vector<int>>(rdispls, rdispls + n);
  auto rt2 = std::make_shared<std::vector<MPI_Datatype>>(recvtypes,
                                                         recvtypes + n);
  auto snap = icoll_reserve(c);
  // tmp is captured EXPLICITLY: sendbuf aliases tmp->data() on the
  // IN_PLACE path, and [=] alone would not keep the clone alive (the
  // lambda body never names tmp)
  return icoll_spawn(
      [snap, tmp, sendbuf, recvbuf, sc, sd, st2, rc_, rd, rt2]() {
        return c_alltoallw(*snap, sendbuf, sc->data(), sd->data(),
                           st2->data(), recvbuf, rc_->data(),
                           rd->data(), rt2->data());
      },
      comm, request);
}

int MPI_Ibarrier(MPI_Comm comm, MPI_Request *request) {
  // as a 1-int allreduce: the plain dissemination barrier's fixed tag
  // cannot distinguish overlapping instances, the reserved-seq
  // allreduce can (libnbc implements ibarrier the same way)
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  auto snap = std::make_shared<CommObj>(*c);
  c->coll_seq++;
  auto buf = std::make_shared<std::array<int, 2>>();
  return icoll_spawn(
      [snap, buf]() {
        (*buf)[0] = 1;
        return c_allreduce(*snap, buf->data(), buf->data() + 1, 1,
                           MPI_INT, MPI_SUM);
      },
      comm, request);
}

// -------------------------------------------------- Cartesian topology
// cart_create.c:45 family — pure index arithmetic over a derived comm.

int MPI_Dims_create(int nnodes, int ndims, int dims[]) {
  // balanced factorization honoring pre-set (nonzero) entries
  int fixed = 1, free_slots = 0;
  for (int i = 0; i < ndims; i++) {
    if (dims[i] > 0) fixed *= dims[i];
    else free_slots++;
  }
  if (fixed <= 0 || nnodes % fixed) return MPI_ERR_ARG;
  int rem = nnodes / fixed;
  if (free_slots == 0) return rem == 1 ? MPI_SUCCESS : MPI_ERR_ARG;
  // greedy: largest factor first into the earliest free slot
  std::vector<int> fill(free_slots, 1);
  for (int slot = 0; slot < free_slots; slot++) {
    int want = (int)std::round(
        std::pow((double)rem, 1.0 / (free_slots - slot)));
    int best = 1;
    for (int f = 1; f <= want; f++)
      if (rem % f == 0) best = f;
    fill[slot] = slot == free_slots - 1 ? rem : best;
    rem /= fill[slot];
  }
  std::sort(fill.rbegin(), fill.rend());
  int j = 0;
  for (int i = 0; i < ndims; i++)
    if (dims[i] <= 0) dims[i] = fill[j++];
  return MPI_SUCCESS;
}

int MPI_Cart_map(MPI_Comm comm, int ndims, const int dims[],
                 const int periods[], int *newrank) {
  // cart_map.c: the no-reorder mapping this shim's Cart_create also
  // uses — ranks below the grid size keep their rank, the rest get
  // MPI_UNDEFINED
  (void)periods;
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (ndims <= 0) return MPI_ERR_ARG;
  int64_t nnodes = 1;
  for (int d = 0; d < ndims; d++) {
    if (dims[d] <= 0) return MPI_ERR_ARG;
    nnodes *= dims[d];
  }
  if (nnodes > (int64_t)c->group.size()) return MPI_ERR_ARG;
  *newrank = c->local_rank < nnodes ? c->local_rank : MPI_UNDEFINED;
  return MPI_SUCCESS;
}

int MPI_Graph_map(MPI_Comm comm, int nnodes, const int index[],
                  const int edges[], int *newrank) {
  (void)index;
  (void)edges;
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (nnodes <= 0 || nnodes > (int)c->group.size()) return MPI_ERR_ARG;
  *newrank = c->local_rank < nnodes ? c->local_rank : MPI_UNDEFINED;
  return MPI_SUCCESS;
}

int MPI_Cart_create(MPI_Comm comm, int ndims, const int dims[],
                    const int periods[], int /*reorder*/,
                    MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (ndims <= 0) return MPI_ERR_ARG;
  int64_t total = 1;
  for (int i = 0; i < ndims; i++) {
    if (dims[i] <= 0) return MPI_ERR_ARG;
    total *= dims[i];
  }
  if (total > (int64_t)c->group.size()) return MPI_ERR_ARG;
  // ranks beyond the grid get MPI_COMM_NULL (cart_create.c's contract);
  // reorder is accepted and ignored (ranks are already arbitrary here)
  int color = c->local_rank < total ? 0 : MPI_UNDEFINED;
  int rc = MPI_Comm_split(comm, color, c->local_rank, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  if (*newcomm == MPI_COMM_NULL) return MPI_SUCCESS;
  CommObj *nc = lookup_comm(*newcomm);
  nc->cart_dims.assign(dims, dims + ndims);
  nc->cart_periods.assign(ndims, 0);
  if (periods)
    for (int i = 0; i < ndims; i++) nc->cart_periods[i] = periods[i] != 0;
  return MPI_SUCCESS;
}

int MPI_Cartdim_get(MPI_Comm comm, int *ndims) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (c->cart_dims.empty()) return MPI_ERR_ARG;
  *ndims = (int)c->cart_dims.size();
  return MPI_SUCCESS;
}

int MPI_Cart_get(MPI_Comm comm, int maxdims, int dims[], int periods[],
                 int coords[]) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nd = (int)c->cart_dims.size();
  if (nd == 0 || maxdims < nd) return MPI_ERR_ARG;
  for (int i = 0; i < nd; i++) {
    dims[i] = c->cart_dims[i];
    periods[i] = c->cart_periods[i];
  }
  return MPI_Cart_coords(comm, c->local_rank, maxdims, coords);
}

int MPI_Cart_rank(MPI_Comm comm, const int coords[], int *rank) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nd = (int)c->cart_dims.size();
  if (nd == 0) return MPI_ERR_ARG;
  int64_t r = 0;
  for (int i = 0; i < nd; i++) {
    int64_t coord = coords[i];
    int dim = c->cart_dims[i];
    if (coord < 0 || coord >= dim) {
      if (!c->cart_periods[i]) return MPI_ERR_ARG;  // out of a wall
      coord = ((coord % dim) + dim) % dim;
    }
    r = r * dim + coord;
  }
  *rank = (int)r;
  return MPI_SUCCESS;
}

int MPI_Cart_coords(MPI_Comm comm, int rank, int maxdims, int coords[]) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nd = (int)c->cart_dims.size();
  if (nd == 0 || maxdims < nd) return MPI_ERR_ARG;
  if (rank < 0 || rank >= (int)c->group.size()) return MPI_ERR_ARG;
  for (int i = nd - 1; i >= 0; i--) {
    coords[i] = rank % c->cart_dims[i];
    rank /= c->cart_dims[i];
  }
  return MPI_SUCCESS;
}

int MPI_Cart_sub(MPI_Comm comm, const int remain_dims[],
                 MPI_Comm *newcomm) {
  // cart_sub.c: slice the grid — ranks sharing the coordinates of the
  // DROPPED dimensions form a sub-grid over the kept ones
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nd = (int)c->cart_dims.size();
  if (nd == 0) return MPI_ERR_ARG;
  std::vector<int> coords(nd);
  int rc = MPI_Cart_coords(comm, c->local_rank, nd, coords.data());
  if (rc != MPI_SUCCESS) return rc;
  // color = the dropped-dim coordinates; key = row-major rank within
  // the kept dims (so the sub-grid keeps cartesian order)
  int color = 0, key = 0;
  for (int d = 0; d < nd; d++) {
    if (remain_dims[d]) key = key * c->cart_dims[d] + coords[d];
    else color = color * c->cart_dims[d] + coords[d];
  }
  rc = MPI_Comm_split(comm, color, key, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  CommObj *nc = lookup_comm(*newcomm);
  nc->cart_dims.clear();
  nc->cart_periods.clear();
  for (int d = 0; d < nd; d++) {
    if (remain_dims[d]) {
      nc->cart_dims.push_back(c->cart_dims[d]);
      nc->cart_periods.push_back(c->cart_periods[d]);
    }
  }
  if (nc->cart_dims.empty()) {
    // all dims dropped: a 1-rank "grid" of dimension 1 (cart_sub.c
    // returns a zero-dim cart comm; a single cell keeps the API total)
    nc->cart_dims.push_back(1);
    nc->cart_periods.push_back(0);
  }
  return MPI_SUCCESS;
}

int MPI_Cart_shift(MPI_Comm comm, int direction, int disp,
                   int *rank_source, int *rank_dest) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nd = (int)c->cart_dims.size();
  if (nd == 0 || direction < 0 || direction >= nd) return MPI_ERR_ARG;
  std::vector<int> coords(nd);
  int rc = MPI_Cart_coords(comm, c->local_rank, nd, coords.data());
  if (rc != MPI_SUCCESS) return rc;
  auto neighbor = [&](int delta, int *out) {
    std::vector<int> nb = coords;
    nb[direction] += delta;
    int dim = c->cart_dims[direction];
    if (nb[direction] < 0 || nb[direction] >= dim) {
      if (!c->cart_periods[direction]) {
        *out = MPI_PROC_NULL;
        return;
      }
      nb[direction] = ((nb[direction] % dim) + dim) % dim;
    }
    MPI_Cart_rank(comm, nb.data(), out);
  };
  neighbor(-disp, rank_source);
  neighbor(disp, rank_dest);
  return MPI_SUCCESS;
}

int MPI_Comm_create(MPI_Comm comm, MPI_Group group, MPI_Comm *newcomm) {
  // comm_create.c:40's semantics by reduction to split: members color
  // together, keyed by GROUP rank so the new comm preserves the
  // group's ordering; non-members get MPI_COMM_NULL
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  GroupObj *gr = lookup_group(group);
  if (!gr) return MPI_ERR_GROUP;
  int my_world = c->group[c->local_rank];
  int color = MPI_UNDEFINED, key = 0;
  for (size_t i = 0; i < gr->ranks.size(); i++) {
    if (gr->ranks[i] == my_world) {
      color = 0;
      key = (int)i;
      break;
    }
  }
  return MPI_Comm_split(comm, color, key, newcomm);
}

// ----------------------------------------------------- intercommunicators
// intercomm_create.c / intercomm_merge.c: two disjoint groups of ONE
// universe joined for remote-group point-to-point.  The context ids are
// computed, not negotiated: both sides hash the same (sorted union of
// world ranks, tag) so no extra agreement round exists — the same
// collapse as the deterministic-cid communicator algebra.

namespace {

void intercomm_cids(const std::vector<int> &a, const std::vector<int> &b,
                    int tag, CommObj &out) {
  std::vector<int> all(a);
  all.insert(all.end(), b.begin(), b.end());
  std::sort(all.begin(), all.end());
  uint64_t h = 0xCBF29CE484222325ULL ^ (uint64_t)(uint32_t)tag;
  for (int r : all) h = mix64(h ^ (uint64_t)(uint32_t)r);
  h = (h & 0x3FFFFFFFFFFFULL) | 0x10000ULL;
  out.cid_pt2pt = (int64_t)h;
  out.cid_coll = (int64_t)h + 1;
  out.cid_bar = (int64_t)h + 2;
}

}  // namespace

int MPI_Intercomm_create(MPI_Comm local_comm, int local_leader,
                         MPI_Comm peer_comm, int remote_leader, int tag,
                         MPI_Comm *newintercomm) {
  CommObj *lc = lookup_comm(local_comm);
  if (!lc || !lc->remote.empty()) return MPI_ERR_COMM;
  if (local_leader < 0 || local_leader >= (int)lc->group.size())
    return MPI_ERR_ARG;
  int n = (int)lc->group.size(), me = lc->local_rank;
  // the leaders swap group lists over peer_comm, then broadcast them
  // inside their local comms (intercomm_create.c's two-phase shape)
  std::vector<int> remote;
  if (me == local_leader) {
    CommObj *pc = lookup_comm(peer_comm);
    if (!pc) return MPI_ERR_COMM;
    long my_n = n;
    long their_n = 0;
    MPI_Status st{};
    int rc = MPI_Sendrecv(&my_n, 1, MPI_LONG, remote_leader, tag,
                          &their_n, 1, MPI_LONG, remote_leader, tag,
                          peer_comm, &st);
    if (rc != MPI_SUCCESS) return rc;
    remote.resize((size_t)their_n);
    rc = MPI_Sendrecv(lc->group.data(), n, MPI_INT, remote_leader, tag,
                      remote.data(), (int)their_n, MPI_INT,
                      remote_leader, tag, peer_comm, &st);
    if (rc != MPI_SUCCESS) return rc;
  }
  long rn = (long)remote.size();
  int rc = c_bcast(*lc, &rn, 1, MPI_LONG, local_leader, 0x7E12);
  if (rc != MPI_SUCCESS) return rc;
  remote.resize((size_t)rn);
  rc = c_bcast(*lc, remote.data(), (int)rn, MPI_INT, local_leader,
               0x7E13);
  if (rc != MPI_SUCCESS) return rc;
  CommObj inter;
  inter.group = lc->group;
  inter.local_rank = me;
  inter.remote = remote;
  intercomm_cids(lc->group, remote, tag, inter);
  int handle = g_next_comm++;
  g_comms[handle] = inter;
  *newintercomm = handle;
  return MPI_SUCCESS;
}

int MPI_Comm_remote_size(MPI_Comm comm, int *size) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (c->remote.empty()) return MPI_ERR_COMM;  // intracommunicator
  *size = (int)c->remote.size();
  return MPI_SUCCESS;
}

int MPI_Comm_test_inter(MPI_Comm comm, int *flag) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  *flag = c->remote.empty() ? 0 : 1;
  return MPI_SUCCESS;
}

int MPI_Intercomm_merge(MPI_Comm intercomm, int high, MPI_Comm *newintra) {
  // intercomm_merge.c: concatenate the two groups into one
  // intracommunicator; the `high` group goes SECOND.  Both sides must
  // pass complementary flags (spec requirement); equal flags fall back
  // to a deterministic order (smaller leading world rank first) so the
  // two sides still agree.
  CommObj *c = lookup_comm(intercomm);
  if (!c || c->remote.empty()) return MPI_ERR_COMM;
  // the two sides' flags must actually be COMPARED: deciding the order
  // from one side's flag alone silently diverges when both sides pass
  // the same value (the cids still agree — the union hash is
  // order-independent — so the corruption would be silent).  Leaders
  // swap flags over the intercomm, then broadcast inside each group
  // through a per-side local context derived from the intercomm cid.
  long my_flag = high ? 1 : 0, their_flag = -1;
  if (c->local_rank == 0) {
    // reserved context (cid_bar), NOT the user pt2pt cid: tag 0x7E14
    // is a legal user tag and an eager user message could otherwise
    // match this internal recv
    int remote_leader = c->remote[0];
    int rc = raw_send(&my_flag, 1, MPI_LONG, remote_leader, 0x7E14,
                      c->cid_bar);
    if (rc != MPI_SUCCESS) return rc;
    rc = raw_recv(&their_flag, 1, MPI_LONG, remote_leader, 0x7E14,
                  c->cid_bar, nullptr);
    if (rc != MPI_SUCCESS) return rc;
  }
  CommObj local_side;
  local_side.group = c->group;
  local_side.local_rank = c->local_rank;
  intercomm_cids(c->group, {},
                 (int)((c->cid_pt2pt ^ c->group.front()) & 0x3FFFFFFF),
                 local_side);
  int rc = c_bcast(local_side, &their_flag, 1, MPI_LONG, 0, 0x7E15);
  if (rc != MPI_SUCCESS) return rc;
  bool im_second;
  if (my_flag != their_flag) {
    im_second = my_flag == 1;  // the high group goes second (the spec)
  } else {
    // equal flags (erroneous per MPI, but detectable here): both sides
    // fall back to the same deterministic order — smaller leading
    // world rank first
    im_second = !(c->group.front() < c->remote.front());
  }
  std::vector<int> first = im_second ? c->remote : c->group;
  std::vector<int> second = im_second ? c->group : c->remote;
  CommObj merged;
  merged.group = first;
  merged.group.insert(merged.group.end(), second.begin(), second.end());
  int my_world = c->group[c->local_rank];
  for (size_t i = 0; i < merged.group.size(); i++)
    if (merged.group[i] == my_world) merged.local_rank = (int)i;
  // cids keyed by the parent intercomm's cid AND a per-merge sequence
  // (both sides advance it on every collective merge call), so repeated
  // merges of one intercomm get distinct contexts — the comm_split
  // child_seq discipline
  intercomm_cids(first, second,
                 (int)((c->cid_pt2pt ^
                        (int64_t)(c->child_seq * 0x9E3779B1ULL)) &
                       0x3FFFFFFF) ^
                     0x4D52,
                 merged);
  c->child_seq++;
  int handle = g_next_comm++;
  g_comms[handle] = merged;
  *newintra = handle;
  return MPI_SUCCESS;
}

// ------------------------------------------------------ dynamic spawn
// comm_spawn.c re-designed over universe EXTENSION: children join the
// SAME address book at offset ids (base..base+n), with their own
// MPI_COMM_WORLD context handed down by the spawner — so no second
// wire namespace exists and the spawn intercomm's remote-group pt2pt
// rides the ordinary endpoint machinery.  The root runs the children's
// modex coordinator inline (the standard init handshake, unchanged).
// Constraint (documented): spawns must be serialized across the
// universe — disjoint comms spawning concurrently would fork the book.

namespace {

int g_parent_comm_handle = -2;  // lazily built from the ZMPI_* env
std::vector<pid_t> g_spawned_pids;

}  // namespace

// reap exited children non-blockingly (called per spawn + at Finalize)
void reap_spawned(void) {
  for (auto it = g_spawned_pids.begin(); it != g_spawned_pids.end();) {
    if (waitpid(*it, nullptr, WNOHANG) > 0) it = g_spawned_pids.erase(it);
    else ++it;
  }
}

// one spawn engine for MPI_Comm_spawn AND MPI_Comm_spawn_multiple
// (comm_spawn_multiple.c): all blocks share ONE child world; child i
// runs the command of the block it falls into.
static int spawn_impl(int count, const char *commands[], char ***argvs,
                      const int maxprocs_arr[], int root, MPI_Comm comm,
                      MPI_Comm *intercomm, int errcodes[]) {
  CommObj *c = lookup_comm(comm);
  if (!c || !c->remote.empty()) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  int me = c->local_rank;
  reap_spawned();
  // hdr[0] < 0 signals a root-side failure to EVERY rank through the
  // broadcasts below — the collective-error-agreement discipline (the
  // Python plane's _rank0_collective): no early root return may strand
  // the other ranks inside c_bcast.
  long hdr[3] = {-1, 0, 0};  // maxprocs, spawn cid, base
  std::string flat;          // "host:port\n" per child
  int maxprocs = 0;  // total across blocks (root-significant)
  if (me == root) {
    // commands/argvs/maxprocs are root-significant (MPI-3.1 10.3.2)
    if (count <= 0) goto root_done;
    for (int b = 0; b < count; b++) {
      if (maxprocs_arr[b] <= 0 || !commands[b]) goto root_done;
      maxprocs += maxprocs_arr[b];
    }
    {
      int base = (int)g.book.size();
      // the bound is the CONSTANT, not capacity(): reserve guarantees
      // >= BOOK_CAP, and the no-reallocation invariant must hold on
      // every rank, not just wherever capacity happens to be larger
      if (base + maxprocs > (int)Shim::BOOK_CAP) goto root_done;
      int64_t scid =
          (int64_t)((mix64((uint64_t)base * 0x9E3779B97F4A7C15ULL) &
                     0x3FFFFFFFFFFFULL) |
                    0x200000000000ULL);
      // the children's modex coordinator (standard init handshake)
      int srv = socket(AF_INET, SOCK_STREAM, 0);
      set_cloexec(srv);
      int one = 1;
      setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
      sockaddr_in ca{};
      ca.sin_family = AF_INET;
      ca.sin_port = 0;
      inet_pton(AF_INET, g.host.c_str(), &ca.sin_addr);
      if (bind(srv, (sockaddr *)&ca, sizeof ca) != 0) {
        close(srv);
        goto root_done;
      }
      socklen_t alen = sizeof ca;
      getsockname(srv, (sockaddr *)&ca, &alen);
      int spawn_port = ntohs(ca.sin_port);
      listen(srv, maxprocs + 2);
      std::string pgroup;
      for (size_t i = 0; i < c->group.size(); i++) {
        if (i) pgroup += ",";
        pgroup += std::to_string(c->group[i]);
      }
      // argv/envp built BEFORE fork (threads hold malloc locks); the
      // filtered base environment is shared by every child.  One argv
      // vector per block; child i uses its block's.
      std::vector<std::vector<char *>> avs((size_t)count);
      std::vector<int> block_of((size_t)maxprocs);
      {
        int at = 0;
        for (int b = 0; b < count; b++) {
          avs[(size_t)b].push_back(const_cast<char *>(commands[b]));
          char **bargv = argvs ? argvs[b] : nullptr;
          if (bargv)
            for (int i = 0; bargv[i]; i++)
              avs[(size_t)b].push_back(bargv[i]);
          avs[(size_t)b].push_back(nullptr);
          for (int i = 0; i < maxprocs_arr[b]; i++)
            block_of[(size_t)at++] = b;
        }
      }
      extern char **environ;
      std::vector<std::string> base_envs;
      for (char **e = environ; *e; e++) {
        if (strncmp(*e, "ZMPI_RANK=", 10) &&
            strncmp(*e, "ZMPI_SIZE=", 10) &&
            strncmp(*e, "ZMPI_COORD_", 11) &&
            strncmp(*e, "ZMPI_WORLD_", 11) &&
            strncmp(*e, "ZMPI_SPAWN_", 11) &&
            strncmp(*e, "ZMPI_PARENT_", 12))
          base_envs.push_back(*e);
      }
      base_envs.push_back("ZMPI_SIZE=" + std::to_string(base + maxprocs));
      base_envs.push_back("ZMPI_COORD_HOST=" + g.host);
      base_envs.push_back("ZMPI_COORD_PORT=" + std::to_string(spawn_port));
      base_envs.push_back("ZMPI_WORLD_BASE=" + std::to_string(base));
      base_envs.push_back("ZMPI_WORLD_SIZE=" + std::to_string(maxprocs));
      base_envs.push_back("ZMPI_SPAWN_CID=" + std::to_string(scid));
      base_envs.push_back("ZMPI_PARENT_GROUP=" + pgroup);
      std::vector<pid_t> pids;
      std::vector<int> errpipes;  // CLOEXEC: closes on exec success
      bool launch_failed = false;
      for (int i = 0; i < maxprocs && !launch_failed; i++) {
        std::string rank_env = "ZMPI_RANK=" + std::to_string(base + i);
        std::vector<char *> ev;
        for (auto &x : base_envs) ev.push_back(const_cast<char *>(x.c_str()));
        ev.push_back(const_cast<char *>(rank_env.c_str()));
        ev.push_back(nullptr);
        int pfd[2];
        if (pipe(pfd) != 0) {
          launch_failed = true;
          break;
        }
        set_cloexec(pfd[0]);  // later siblings must not inherit it
        set_cloexec(pfd[1]);
        int blk = block_of[(size_t)i];
        pid_t pid = fork();
        if (pid == 0) {
          close(pfd[0]);
          execve(commands[blk], avs[(size_t)blk].data(), ev.data());
          // exec failed: the CLOEXEC pipe survived — report and die
          // (write is async-signal-safe)
          int err = errno;
          ssize_t ignored = write(pfd[1], &err, sizeof err);
          (void)ignored;
          _exit(127);
        }
        close(pfd[1]);
        if (pid < 0) {
          close(pfd[0]);
          launch_failed = true;
          break;
        }
        pids.push_back(pid);
        errpipes.push_back(pfd[0]);
      }
      // exec verdicts: EOF on the pipe = exec succeeded
      std::vector<int> codes((size_t)maxprocs, MPI_SUCCESS);
      for (size_t i = 0; i < errpipes.size(); i++) {
        int err = 0;
        if (read(errpipes[i], &err, sizeof err) > 0) {
          codes[i] = MPI_ERR_OTHER;
          launch_failed = true;
        }
        close(errpipes[i]);
      }
      if (launch_failed) {
        // no partial universes: kill whatever launched, reap, fail
        for (pid_t pid : pids) kill(pid, SIGKILL);
        for (pid_t pid : pids) waitpid(pid, nullptr, 0);
        close(srv);
        if (errcodes)
          for (int i = 0; i < maxprocs; i++) errcodes[i] = codes[(size_t)i];
        goto root_done;
      }
      for (pid_t pid : pids) g_spawned_pids.push_back(pid);
      // gather the children's cards, reply with the EXTENDED book.
      // accept() is POLLED so a child dying after exec but before its
      // modex connect (crash before MPI_Init) turns into an agreed
      // failure rather than an accept() that waits forever.
      std::vector<std::pair<std::string, int>> kids(maxprocs, {"", 0});
      std::vector<std::string> kidcaps((size_t)maxprocs, "");
      std::vector<int> conns;
      bool modex_ok = true;
      for (int i = 0; i < maxprocs && modex_ok; i++) {
        int fd = -1;
        for (;;) {
          fd_set rf;
          FD_ZERO(&rf);
          FD_SET(srv, &rf);
          timeval tv{1, 0};
          int sel = select(srv + 1, &rf, nullptr, nullptr, &tv);
          if (sel > 0) {
            fd = accept(srv, nullptr, nullptr);
            break;
          }
          // a second of silence: is any child already dead?
          bool died = false;
          for (pid_t pid : pids)
            if (waitpid(pid, nullptr, WNOHANG) > 0) died = true;
          if (died || sel < 0) break;
        }
        if (fd < 0) {
          modex_ok = false;
          break;
        }
        set_cloexec(fd);
        std::string f;
        std::vector<DssVal> vals;
        if (!recv_frame(fd, f) || !parse_all(f, vals) ||
            vals.size() != 2 || vals[1].tag != T_LIST ||
            vals[1].items.size() < 2 || vals[1].items[0].tag != T_STR ||
            vals[1].items[1].tag != T_INT) {
          close(fd);
          modex_ok = false;
          break;
        }
        int kr = (int)vals[0].i - base;
        if (kr >= 0 && kr < maxprocs) {
          kids[kr] = {vals[1].items[0].s, (int)vals[1].items[1].i};
          if (vals[1].items.size() >= 3)
            kidcaps[(size_t)kr] = vals[1].items[2].s;  // sibling sm
        }
        conns.push_back(fd);
      }
      if (!modex_ok) {
        for (int fd : conns) close(fd);
        close(srv);
        goto root_done;
      }
      auto book = g.book;
      auto caps = g.caps;
      caps.resize(book.size(), "");
      for (size_t k = 0; k < kids.size(); k++) {
        book.push_back(kids[k]);
        caps.push_back(kidcaps[k]);  // siblings ring each other
      }
      std::string reply = pack_address_book(book, &caps);
      for (int fd : conns) {
        send_frame(fd, reply);
        close(fd);
      }
      close(srv);
      // the ROOT extends its own book here; every other participant
      // extends from the broadcast below
      for (auto &k : kids) {
        g.book.push_back(k);
        g.caps.push_back("");  // cross-cohort stays TCP (see sm design)
      }
      hdr[0] = maxprocs;
      hdr[1] = scid;
      hdr[2] = base;
      for (auto &k : kids)
        flat += k.first + ":" + std::to_string(k.second) + "\n";
    }
  }
root_done:
  // distribute the outcome to every participant (hdr[0] < 0 = failure)
  int rc = c_bcast(*c, hdr, 3, MPI_LONG, root, 0x7E16);
  if (rc != MPI_SUCCESS) return rc;
  if (hdr[0] < 0) return MPI_ERR_OTHER;  // agreed failure, no deadlock
  long flen = (long)flat.size();
  rc = c_bcast(*c, &flen, 1, MPI_LONG, root, 0x7E17);
  if (rc != MPI_SUCCESS) return rc;
  flat.resize((size_t)flen);
  rc = c_bcast(*c, flat.data(), (int)flen, MPI_BYTE, root, 0x7E18);
  if (rc != MPI_SUCCESS) return rc;
  int base = (int)hdr[2];
  int nkids = (int)hdr[0];  // root-significant maxprocs, agreed via hdr
  if (me != root) {
    if ((int)g.book.size() != base) return MPI_ERR_OTHER;  // serialized-
    // spawn contract broken (see the section comment)
    if (base + nkids > (int)Shim::BOOK_CAP) return MPI_ERR_OTHER;
    size_t pos = 0;
    for (int i = 0; i < nkids; i++) {
      size_t nl = flat.find('\n', pos);
      std::string entry = flat.substr(pos, nl - pos);
      pos = nl + 1;
      size_t colon = entry.rfind(':');
      g.book.push_back({entry.substr(0, colon),
                        atoi(entry.c_str() + colon + 1)});
      g.caps.push_back("");  // cross-cohort stays TCP
    }
  }
  // the spawn intercommunicator: local = the spawn comm, remote = kids
  CommObj inter;
  inter.group = c->group;
  inter.local_rank = me;
  for (int i = 0; i < nkids; i++) inter.remote.push_back(base + i);
  inter.cid_pt2pt = hdr[1];
  inter.cid_coll = hdr[1] + 1;
  inter.cid_bar = hdr[1] + 2;
  int handle = g_next_comm++;
  g_comms[handle] = inter;
  *intercomm = handle;
  if (errcodes)
    for (int i = 0; i < nkids; i++) errcodes[i] = MPI_SUCCESS;
  return MPI_SUCCESS;
}

int MPI_Comm_spawn(const char *command, char *argv[], int maxprocs,
                   MPI_Info /*info*/, int root, MPI_Comm comm,
                   MPI_Comm *intercomm, int errcodes[]) {
  char **argvs1[1] = {argv};
  return spawn_impl(1, &command, argvs1, &maxprocs, root, comm,
                    intercomm, errcodes);
}

int MPI_Comm_spawn_multiple(int count, char *commands[],
                            char **argvs[], const int maxprocs[],
                            const MPI_Info /*infos*/[], int root,
                            MPI_Comm comm, MPI_Comm *intercomm,
                            int errcodes[]) {
  // comm_spawn_multiple.c: one child WORLD spanning every block.
  // count/commands/argvs/maxprocs are ROOT-significant (MPI-3.1
  // 10.3.2) — non-root ranks must not touch them
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::vector<const char *> cmds;
  if (c->local_rank == root && count > 0 && commands) {
    cmds.resize((size_t)count);
    for (int b = 0; b < count; b++) cmds[(size_t)b] = commands[b];
  }
  return spawn_impl(count, cmds.data(), argvs, maxprocs, root, comm,
                    intercomm, errcodes);
}

int MPI_Comm_get_parent(MPI_Comm *parent) {
  const char *wb = getenv("ZMPI_WORLD_BASE");
  if (!wb || !wb[0]) {
    *parent = MPI_COMM_NULL;
    return MPI_SUCCESS;
  }
  if (g_parent_comm_handle >= 0) {
    *parent = g_parent_comm_handle;
    return MPI_SUCCESS;
  }
  CommObj *w = lookup_comm(MPI_COMM_WORLD);
  if (!w) return MPI_ERR_COMM;
  CommObj inter;
  inter.group = w->group;
  inter.local_rank = w->local_rank;
  const char *pg = getenv("ZMPI_PARENT_GROUP");
  for (const char *p = pg; p && *p;) {
    inter.remote.push_back(atoi(p));
    const char *comma = strchr(p, ',');
    p = comma ? comma + 1 : nullptr;
  }
  int64_t scid = atoll(getenv("ZMPI_SPAWN_CID"));
  inter.cid_pt2pt = scid;
  inter.cid_coll = scid + 1;
  inter.cid_bar = scid + 2;
  g_parent_comm_handle = g_next_comm++;
  g_comms[g_parent_comm_handle] = inter;
  *parent = g_parent_comm_handle;
  return MPI_SUCCESS;
}

// ------------------------------------------------------ graph topology
// graph_create.c family: arbitrary neighbor lists in the standard
// index/edges encoding (index[i] = cumulative edge count through node i)

int MPI_Graph_create(MPI_Comm comm, int nnodes, const int index[],
                     const int edges[], int /*reorder*/,
                     MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (nnodes <= 0 || nnodes > (int)c->group.size()) return MPI_ERR_ARG;
  int nedges = index[nnodes - 1];
  for (int i = 0; i < nnodes; i++) {
    if (index[i] < (i ? index[i - 1] : 0)) return MPI_ERR_ARG;
  }
  for (int e = 0; e < nedges; e++)
    if (edges[e] < 0 || edges[e] >= nnodes) return MPI_ERR_ARG;
  int color = c->local_rank < nnodes ? 0 : MPI_UNDEFINED;
  int rc = MPI_Comm_split(comm, color, c->local_rank, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  if (*newcomm == MPI_COMM_NULL) return MPI_SUCCESS;
  CommObj *nc = lookup_comm(*newcomm);
  nc->graph_index.assign(index, index + nnodes);
  nc->graph_edges.assign(edges, edges + nedges);
  return MPI_SUCCESS;
}

int MPI_Graphdims_get(MPI_Comm comm, int *nnodes, int *nedges) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (c->graph_index.empty()) return MPI_ERR_ARG;
  *nnodes = (int)c->graph_index.size();
  *nedges = c->graph_index.back();
  return MPI_SUCCESS;
}

int MPI_Graph_get(MPI_Comm comm, int maxindex, int maxedges, int index[],
                  int edges[]) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (c->graph_index.empty()) return MPI_ERR_ARG;
  if (maxindex < (int)c->graph_index.size() ||
      maxedges < c->graph_index.back())
    return MPI_ERR_ARG;
  std::copy(c->graph_index.begin(), c->graph_index.end(), index);
  std::copy(c->graph_edges.begin(), c->graph_edges.end(), edges);
  return MPI_SUCCESS;
}

int MPI_Graph_neighbors_count(MPI_Comm comm, int rank, int *nneighbors) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nn = (int)c->graph_index.size();
  if (nn == 0 || rank < 0 || rank >= nn) return MPI_ERR_ARG;
  *nneighbors = c->graph_index[rank] - (rank ? c->graph_index[rank - 1]
                                             : 0);
  return MPI_SUCCESS;
}

int MPI_Graph_neighbors(MPI_Comm comm, int rank, int maxneighbors,
                        int neighbors[]) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  int nn = (int)c->graph_index.size();
  if (nn == 0 || rank < 0 || rank >= nn) return MPI_ERR_ARG;
  int lo = rank ? c->graph_index[rank - 1] : 0;
  int hi = c->graph_index[rank];
  if (maxneighbors < hi - lo) return MPI_ERR_ARG;
  for (int e = lo; e < hi; e++) neighbors[e - lo] = c->graph_edges[e];
  return MPI_SUCCESS;
}

int MPI_Topo_test(MPI_Comm comm, int *status) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (!c->cart_dims.empty()) *status = MPI_CART;
  else if (c->dist) *status = MPI_DIST_GRAPH;
  else if (!c->graph_index.empty()) *status = MPI_GRAPH;
  else *status = MPI_UNDEFINED;
  return MPI_SUCCESS;
}

int zompi_unweighted_[1];
int zompi_weights_empty_[1];

int MPI_Dist_graph_create_adjacent(
    MPI_Comm comm, int indegree, const int sources[],
    const int sourceweights[], int outdegree, const int destinations[],
    const int destweights[], MPI_Info /*info*/, int /*reorder*/,
    MPI_Comm *newcomm) {
  // dist_graph_create_adjacent.c: the adjacent form is fully LOCAL —
  // every rank already knows its own in/out lists, so the derived comm
  // needs no neighbor exchange at all (weights are accepted and
  // ignored, as coll components may)
  CommObj *c = lookup_comm(comm);
  if (!c || !c->remote.empty()) return MPI_ERR_COMM;
  if (indegree < 0 || outdegree < 0) return MPI_ERR_ARG;
  int n = (int)c->group.size();
  for (int i = 0; i < indegree; i++)
    if (sources[i] < 0 || sources[i] >= n) return MPI_ERR_ARG;
  for (int i = 0; i < outdegree; i++)
    if (destinations[i] < 0 || destinations[i] >= n) return MPI_ERR_ARG;
  // derive like Graph_create (split, NOT dup: topology constructors
  // must not run attribute copy callbacks)
  int rc = MPI_Comm_split(comm, 0, c->local_rank, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  CommObj *nc = lookup_comm(*newcomm);
  nc->dist = true;
  nc->dist_src.assign(sources, sources + indegree);
  nc->dist_dst.assign(destinations, destinations + outdegree);
  // MPI_UNWEIGHTED / MPI_WEIGHTS_EMPTY are distinct sentinel
  // addresses; a topology is weighted unless BOTH args say unweighted
  // (a zero-degree side passes WEIGHTS_EMPTY and stays
  // weighted-compatible, per the spec's adjacent-form contract)
  auto is_unw = [](const int *w) { return w == MPI_UNWEIGHTED; };
  auto is_empty = [](const int *w) { return w == MPI_WEIGHTS_EMPTY; };
  nc->dist_weighted = !is_unw(sourceweights) || !is_unw(destweights);
  if (nc->dist_weighted) {
    if (indegree > 0 && !is_unw(sourceweights) &&
        !is_empty(sourceweights) && sourceweights)
      nc->dist_srcw.assign(sourceweights, sourceweights + indegree);
    if (outdegree > 0 && !is_unw(destweights) && !is_empty(destweights) &&
        destweights)
      nc->dist_dstw.assign(destweights, destweights + outdegree);
  }
  return MPI_SUCCESS;
}

int MPI_Dist_graph_neighbors_count(MPI_Comm comm, int *indegree,
                                   int *outdegree, int *weighted) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (!c->dist) return MPI_ERR_ARG;
  *indegree = (int)c->dist_src.size();
  *outdegree = (int)c->dist_dst.size();
  *weighted = c->dist_weighted ? 1 : 0;
  return MPI_SUCCESS;
}

int MPI_Dist_graph_neighbors(MPI_Comm comm, int maxindegree,
                             int sources[], int sourceweights[],
                             int maxoutdegree, int destinations[],
                             int destweights[]) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (!c->dist) return MPI_ERR_ARG;
  if (maxindegree < (int)c->dist_src.size() ||
      maxoutdegree < (int)c->dist_dst.size())
    return MPI_ERR_ARG;
  std::copy(c->dist_src.begin(), c->dist_src.end(), sources);
  std::copy(c->dist_dst.begin(), c->dist_dst.end(), destinations);
  if (c->dist_weighted) {
    if (sourceweights && sourceweights != MPI_UNWEIGHTED &&
        sourceweights != MPI_WEIGHTS_EMPTY)
      std::copy(c->dist_srcw.begin(), c->dist_srcw.end(), sourceweights);
    if (destweights && destweights != MPI_UNWEIGHTED &&
        destweights != MPI_WEIGHTS_EMPTY)
      std::copy(c->dist_dstw.begin(), c->dist_dstw.end(), destweights);
  }
  return MPI_SUCCESS;
}

// ------------------------------------------ neighborhood collectives
// neighbor_allgather.c / neighbor_alltoall.c over the cart/graph
// topologies: standard neighbor order (cart: for each dim, -1 then +1;
// graph: the node's edge list).  Tag pairing makes the exchange exact
// even in degenerate topologies (a size-2 periodic ring where the
// minus and plus neighbor are the SAME process): cart sends carry the
// RECEIVER's slot (the complementary direction, slot^1); graph sends
// carry the edge's ordinal among the parallel edges to that neighbor
// (the symmetric-multiplicity convention).

namespace {

// local-rank neighbor lists in standard order; MPI_PROC_NULL at walls.
// For cart/graph the send and recv lists coincide; a distributed graph
// (adjacent form) has directed lists.  Cart neighbors come from
// MPI_Cart_shift — ONE copy of the wrap/encode rules.
int neighbor_list(MPI_Comm comm, CommObj &c, std::vector<int> &nbrs);

int neighbor_lists(MPI_Comm comm, CommObj &c, std::vector<int> &recv_from,
                   std::vector<int> &send_to) {
  if (c.dist) {
    recv_from = c.dist_src;
    send_to = c.dist_dst;
    return MPI_SUCCESS;
  }
  std::vector<int> nbrs;
  int rc = neighbor_list(comm, c, nbrs);
  if (rc != MPI_SUCCESS) return rc;
  recv_from = nbrs;
  send_to = nbrs;
  return MPI_SUCCESS;
}

int neighbor_list(MPI_Comm comm, CommObj &c, std::vector<int> &nbrs) {
  nbrs.clear();
  if (!c.cart_dims.empty()) {
    for (int d = 0; d < (int)c.cart_dims.size(); d++) {
      int minus, plus;
      int rc = MPI_Cart_shift(comm, d, 1, &minus, &plus);
      if (rc != MPI_SUCCESS) return rc;
      nbrs.push_back(minus);
      nbrs.push_back(plus);
    }
    return MPI_SUCCESS;
  }
  if (!c.graph_index.empty()) {
    int me = c.local_rank;
    int lo = me ? c.graph_index[me - 1] : 0;
    for (int e = lo; e < c.graph_index[me]; e++)
      nbrs.push_back(c.graph_edges[e]);
    return MPI_SUCCESS;
  }
  return MPI_ERR_ARG;  // no topology attached
}

// tag codes: receiver's slot for cart, parallel-edge ordinal for
// (dist) graphs — the i-th out-edge to a peer pairs with its i-th
// in-edge from us, the symmetric-multiplicity convention
void neighbor_codes(CommObj &c, const std::vector<int> &recv_from,
                    const std::vector<int> &send_to,
                    std::vector<int> &send_code,
                    std::vector<int> &recv_code) {
  bool cart = !c.cart_dims.empty();
  send_code.resize(send_to.size());
  recv_code.resize(recv_from.size());
  std::map<int, int> seen_s, seen_r;
  for (size_t i = 0; i < send_to.size(); i++)
    send_code[i] = cart ? ((int)i ^ 1) : seen_s[send_to[i]]++;
  for (size_t i = 0; i < recv_from.size(); i++)
    recv_code[i] = cart ? (int)i : seen_r[recv_from[i]]++;
}

int c_neighbor_exchange(MPI_Comm comm, CommObj &c, const void *sendbuf,
                        int scount, MPI_Datatype stype, void *recvbuf,
                        int rcount, MPI_Datatype rtype, bool alltoall) {
  if (!c.remote.empty()) return MPI_ERR_COMM;  // intercomm: pt2pt surface
  DtView sv, rv;
  if (!resolve_dtype(stype, sv) || !resolve_dtype(rtype, rv))
    return MPI_ERR_TYPE;
  std::vector<int> recv_from, send_to;
  int rc = neighbor_lists(comm, c, recv_from, send_to);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int> send_code, recv_code;
  neighbor_codes(c, recv_from, send_to, send_code, recv_code);
  int nr = (int)recv_from.size(), ns = (int)send_to.size();
  int64_t base = (c.coll_seq++ % 0x8000) << 16;
  // slot stride follows the EXTENT rule like every gather-family
  // collective (block i starts at i * slot_bytes), not the packed size
  size_t sslot = slot_bytes(sv, scount);
  size_t rslot = slot_bytes(rv, rcount);
  // post every receive first (the PROC_NULL blocks stay untouched)
  std::vector<Req> reqs(nr);
  std::vector<int> handles(nr, -1);
  // the stack Reqs must not outlive their registrations: every exit
  // path past this point deregisters whatever is still pending
  auto abort_all = [&](int err) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < nr; i++)
      if (handles[i] >= 0) deregister_locked(handles[i], &reqs[i]);
    return err;
  };
  for (int i = 0; i < nr; i++) {
    if (recv_from[i] == MPI_PROC_NULL) continue;
    reqs[i].is_recv = true;
    reqs[i].user_buf = (char *)recvbuf + (size_t)i * rslot;
    reqs[i].count = rcount;
    handles[i] = post_recv(&reqs[i], rv, c.cid_coll,
                           world_of(c, recv_from[i]),
                           base | (0x7E20 + recv_code[i]));
  }
  for (int i = 0; i < ns; i++) {
    if (send_to[i] == MPI_PROC_NULL) continue;
    const char *blk = alltoall ? (const char *)sendbuf + (size_t)i * sslot
                               : (const char *)sendbuf;
    rc = raw_send(blk, scount, stype, world_of(c, send_to[i]),
                  base | (0x7E20 + send_code[i]), c.cid_coll);
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  for (int i = 0; i < nr; i++) {
    if (handles[i] < 0) continue;
    rc = wait_handle(handles[i], nullptr);
    handles[i] = -1;  // consumed (success or not), never re-deregister
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  return MPI_SUCCESS;
}

// generalized neighborhood exchange: per-edge buffers/counts/types.
// The v/w variants (neighbor_allgatherv.c, neighbor_alltoallv.c,
// neighbor_alltoallw.c) all reduce to this shape; the callers compute
// the per-edge pointers (extent-scaled for v, byte displacements for
// w — MPI-3.1 §7.7).
int c_neighbor_general(MPI_Comm comm, CommObj &c,
                       const std::vector<const char *> &sptr,
                       const std::vector<int> &scnt,
                       const std::vector<MPI_Datatype> &stype,
                       const std::vector<char *> &rptr,
                       const std::vector<int> &rcnt,
                       const std::vector<MPI_Datatype> &rtype,
                       const std::vector<int> &recv_from,
                       const std::vector<int> &send_to) {
  std::vector<int> send_code, recv_code;
  neighbor_codes(c, recv_from, send_to, send_code, recv_code);
  int nr = (int)recv_from.size(), ns = (int)send_to.size();
  int64_t base = (c.coll_seq++ % 0x8000) << 16;
  std::vector<Req> reqs((size_t)nr);
  std::vector<int> handles((size_t)nr, -1);
  auto abort_all = [&](int err) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < nr; i++)
      if (handles[(size_t)i] >= 0)
        deregister_locked(handles[(size_t)i], &reqs[(size_t)i]);
    return err;
  };
  for (int i = 0; i < nr; i++) {
    if (recv_from[(size_t)i] == MPI_PROC_NULL) continue;
    DtView rv;
    if (!resolve_dtype(rtype[(size_t)i], rv))
      return abort_all(MPI_ERR_TYPE);
    reqs[(size_t)i].is_recv = true;
    reqs[(size_t)i].user_buf = rptr[(size_t)i];
    reqs[(size_t)i].count = rcnt[(size_t)i];
    handles[(size_t)i] =
        post_recv(&reqs[(size_t)i], rv, c.cid_coll,
                  world_of(c, recv_from[(size_t)i]),
                  base | (0x7E20 + recv_code[(size_t)i]));
  }
  for (int i = 0; i < ns; i++) {
    if (send_to[(size_t)i] == MPI_PROC_NULL) continue;
    int rc = raw_send(sptr[(size_t)i], scnt[(size_t)i],
                      stype[(size_t)i],
                      world_of(c, send_to[(size_t)i]),
                      base | (0x7E20 + send_code[(size_t)i]),
                      c.cid_coll);
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  for (int i = 0; i < nr; i++) {
    if (handles[(size_t)i] < 0) continue;
    int rc = wait_handle(handles[(size_t)i], nullptr);
    handles[(size_t)i] = -1;
    if (rc != MPI_SUCCESS) return abort_all(rc);
  }
  return MPI_SUCCESS;
}

int c_neighbor_allgatherv(MPI_Comm comm, CommObj &c, const void *sendbuf,
                          int sendcount, MPI_Datatype sendtype,
                          void *recvbuf, const int recvcounts[],
                          const int displs[], MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;
  DtView rv;
  if (!resolve_dtype(recvtype, rv)) return MPI_ERR_TYPE;
  std::vector<int> recv_from, send_to;
  int rc = neighbor_lists(comm, c, recv_from, send_to);
  if (rc != MPI_SUCCESS) return rc;
  size_t rstride = slot_bytes(rv, 1);
  int nr = (int)recv_from.size(), ns = (int)send_to.size();
  std::vector<const char *> sptr((size_t)ns, (const char *)sendbuf);
  std::vector<int> scnt((size_t)ns, sendcount);
  std::vector<MPI_Datatype> stypes((size_t)ns, sendtype);
  std::vector<char *> rptr((size_t)nr);
  std::vector<int> rcnt((size_t)nr);
  std::vector<MPI_Datatype> rtypes((size_t)nr, recvtype);
  for (int i = 0; i < nr; i++) {
    rptr[(size_t)i] = (char *)recvbuf + (size_t)displs[i] * rstride;
    rcnt[(size_t)i] = recvcounts[i];
  }
  return c_neighbor_general(comm, c, sptr, scnt, stypes, rptr, rcnt,
                            rtypes, recv_from, send_to);
}

int c_neighbor_alltoallv(MPI_Comm comm, CommObj &c, const void *sendbuf,
                         const int sendcounts[], const int sdispls[],
                         MPI_Datatype sendtype, void *recvbuf,
                         const int recvcounts[], const int rdispls[],
                         MPI_Datatype recvtype) {
  if (!c.remote.empty()) return MPI_ERR_COMM;
  DtView sv, rv;
  if (!resolve_dtype(sendtype, sv) || !resolve_dtype(recvtype, rv))
    return MPI_ERR_TYPE;
  std::vector<int> recv_from, send_to;
  int rc = neighbor_lists(comm, c, recv_from, send_to);
  if (rc != MPI_SUCCESS) return rc;
  size_t sstride = slot_bytes(sv, 1), rstride = slot_bytes(rv, 1);
  int nr = (int)recv_from.size(), ns = (int)send_to.size();
  std::vector<const char *> sptr((size_t)ns);
  std::vector<int> scnt((size_t)ns);
  std::vector<MPI_Datatype> stypes((size_t)ns, sendtype);
  std::vector<char *> rptr((size_t)nr);
  std::vector<int> rcnt((size_t)nr);
  std::vector<MPI_Datatype> rtypes((size_t)nr, recvtype);
  for (int i = 0; i < ns; i++) {
    sptr[(size_t)i] =
        (const char *)sendbuf + (size_t)sdispls[i] * sstride;
    scnt[(size_t)i] = sendcounts[i];
  }
  for (int i = 0; i < nr; i++) {
    rptr[(size_t)i] = (char *)recvbuf + (size_t)rdispls[i] * rstride;
    rcnt[(size_t)i] = recvcounts[i];
  }
  return c_neighbor_general(comm, c, sptr, scnt, stypes, rptr, rcnt,
                            rtypes, recv_from, send_to);
}

int c_neighbor_alltoallw(MPI_Comm comm, CommObj &c, const void *sendbuf,
                         const int sendcounts[],
                         const MPI_Aint sdispls[],
                         const MPI_Datatype sendtypes[], void *recvbuf,
                         const int recvcounts[],
                         const MPI_Aint rdispls[],
                         const MPI_Datatype recvtypes[]) {
  if (!c.remote.empty()) return MPI_ERR_COMM;
  std::vector<int> recv_from, send_to;
  int rc = neighbor_lists(comm, c, recv_from, send_to);
  if (rc != MPI_SUCCESS) return rc;
  int nr = (int)recv_from.size(), ns = (int)send_to.size();
  std::vector<const char *> sptr((size_t)ns);
  std::vector<int> scnt((size_t)ns);
  std::vector<MPI_Datatype> stypes((size_t)ns);
  std::vector<char *> rptr((size_t)nr);
  std::vector<int> rcnt((size_t)nr);
  std::vector<MPI_Datatype> rtypes((size_t)nr);
  for (int i = 0; i < ns; i++) {
    sptr[(size_t)i] = (const char *)sendbuf + (size_t)sdispls[i];
    scnt[(size_t)i] = sendcounts[i];
    stypes[(size_t)i] = sendtypes[i];
  }
  for (int i = 0; i < nr; i++) {
    rptr[(size_t)i] = (char *)recvbuf + (size_t)rdispls[i];
    rcnt[(size_t)i] = recvcounts[i];
    rtypes[(size_t)i] = recvtypes[i];
  }
  return c_neighbor_general(comm, c, sptr, scnt, stypes, rptr, rcnt,
                            rtypes, recv_from, send_to);
}

}  // namespace

int MPI_Neighbor_allgather(const void *sendbuf, int sendcount,
                           MPI_Datatype sendtype, void *recvbuf,
                           int recvcount, MPI_Datatype recvtype,
                           MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(
      comm, c_neighbor_exchange(comm, *c, sendbuf, sendcount, sendtype,
                                recvbuf, recvcount, recvtype, false));
}

int MPI_Neighbor_alltoall(const void *sendbuf, int sendcount,
                          MPI_Datatype sendtype, void *recvbuf,
                          int recvcount, MPI_Datatype recvtype,
                          MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(
      comm, c_neighbor_exchange(comm, *c, sendbuf, sendcount, sendtype,
                                recvbuf, recvcount, recvtype, true));
}

int MPI_Neighbor_allgatherv(const void *sendbuf, int sendcount,
                            MPI_Datatype sendtype, void *recvbuf,
                            const int recvcounts[], const int displs[],
                            MPI_Datatype recvtype, MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(
      comm, c_neighbor_allgatherv(comm, *c, sendbuf, sendcount,
                                  sendtype, recvbuf, recvcounts, displs,
                                  recvtype));
}

int MPI_Neighbor_alltoallv(const void *sendbuf, const int sendcounts[],
                           const int sdispls[], MPI_Datatype sendtype,
                           void *recvbuf, const int recvcounts[],
                           const int rdispls[], MPI_Datatype recvtype,
                           MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(
      comm, c_neighbor_alltoallv(comm, *c, sendbuf, sendcounts, sdispls,
                                 sendtype, recvbuf, recvcounts, rdispls,
                                 recvtype));
}

int MPI_Neighbor_alltoallw(const void *sendbuf, const int sendcounts[],
                           const MPI_Aint sdispls[],
                           const MPI_Datatype sendtypes[], void *recvbuf,
                           const int recvcounts[],
                           const MPI_Aint rdispls[],
                           const MPI_Datatype recvtypes[],
                           MPI_Comm comm) {
  CommObj *c = lookup_comm(comm);
  if (!c) return dispatch_comm_err(comm, MPI_ERR_COMM);
  return dispatch_comm_err(
      comm, c_neighbor_alltoallw(comm, *c, sendbuf, sendcounts, sdispls,
                                 sendtypes, recvbuf, recvcounts,
                                 rdispls, recvtypes));
}

// nonblocking neighborhood collectives (ineighbor_allgather.c family):
// the icoll engine — reserve the tag window, run the blocking form on
// a comm snapshot, retire through the request engine.  Array arguments
// are snapshotted by value (the standard lets the caller reuse them
// the moment the call returns).

int MPI_Ineighbor_allgather(const void *sendbuf, int sendcount,
                            MPI_Datatype sendtype, void *recvbuf,
                            int recvcount, MPI_Datatype recvtype,
                            MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [=]() {
        return c_neighbor_exchange(comm, *snap, sendbuf, sendcount,
                                   sendtype, recvbuf, recvcount,
                                   recvtype, false);
      },
      comm, request);
}

int MPI_Ineighbor_alltoall(const void *sendbuf, int sendcount,
                           MPI_Datatype sendtype, void *recvbuf,
                           int recvcount, MPI_Datatype recvtype,
                           MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [=]() {
        return c_neighbor_exchange(comm, *snap, sendbuf, sendcount,
                                   sendtype, recvbuf, recvcount,
                                   recvtype, true);
      },
      comm, request);
}

int MPI_Ineighbor_allgatherv(const void *sendbuf, int sendcount,
                             MPI_Datatype sendtype, void *recvbuf,
                             const int recvcounts[], const int displs[],
                             MPI_Datatype recvtype, MPI_Comm comm,
                             MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::vector<int> rf, st_;
  int rc = neighbor_lists(comm, *c, rf, st_);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int> rc_v(recvcounts, recvcounts + rf.size());
  std::vector<int> d_v(displs, displs + rf.size());
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [=]() {
        return c_neighbor_allgatherv(comm, *snap, sendbuf, sendcount,
                                     sendtype, recvbuf, rc_v.data(),
                                     d_v.data(), recvtype);
      },
      comm, request);
}

int MPI_Ineighbor_alltoallv(const void *sendbuf, const int sendcounts[],
                            const int sdispls[], MPI_Datatype sendtype,
                            void *recvbuf, const int recvcounts[],
                            const int rdispls[], MPI_Datatype recvtype,
                            MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::vector<int> rf, st_;
  int rc = neighbor_lists(comm, *c, rf, st_);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int> sc_v(sendcounts, sendcounts + st_.size());
  std::vector<int> sd_v(sdispls, sdispls + st_.size());
  std::vector<int> rc_v(recvcounts, recvcounts + rf.size());
  std::vector<int> rd_v(rdispls, rdispls + rf.size());
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [=]() {
        return c_neighbor_alltoallv(comm, *snap, sendbuf, sc_v.data(),
                                    sd_v.data(), sendtype, recvbuf,
                                    rc_v.data(), rd_v.data(), recvtype);
      },
      comm, request);
}

int MPI_Ineighbor_alltoallw(const void *sendbuf, const int sendcounts[],
                            const MPI_Aint sdispls[],
                            const MPI_Datatype sendtypes[],
                            void *recvbuf, const int recvcounts[],
                            const MPI_Aint rdispls[],
                            const MPI_Datatype recvtypes[],
                            MPI_Comm comm, MPI_Request *request) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  std::vector<int> rf, st_;
  int rc = neighbor_lists(comm, *c, rf, st_);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int> sc_v(sendcounts, sendcounts + st_.size());
  std::vector<MPI_Aint> sd_v(sdispls, sdispls + st_.size());
  std::vector<MPI_Datatype> stv(sendtypes, sendtypes + st_.size());
  std::vector<int> rc_v(recvcounts, recvcounts + rf.size());
  std::vector<MPI_Aint> rd_v(rdispls, rdispls + rf.size());
  std::vector<MPI_Datatype> rtv(recvtypes, recvtypes + rf.size());
  auto snap = icoll_reserve(c);
  return icoll_spawn(
      [=]() {
        return c_neighbor_alltoallw(comm, *snap, sendbuf, sc_v.data(),
                                    sd_v.data(), stv.data(), recvbuf,
                                    rc_v.data(), rd_v.data(),
                                    rtv.data());
      },
      comm, request);
}

// ------------------------------------------------------ one-sided RMA

int MPI_Win_create(void *base, MPI_Aint size, int disp_unit, MPI_Info,
                   MPI_Comm comm, MPI_Win *win) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (size < 0 || (size > 0 && !base) || disp_unit <= 0)
    return MPI_ERR_ARG;
  // the wire win-id is deterministic per comm (cid x per-comm counter):
  // every member computes the same id with no agreement round — the
  // same collapse as the deterministic-cid communicator algebra
  int64_t wid = (int64_t)((uint64_t)c->cid_pt2pt * 256u + c->win_seq++);
  WinObj *w = new WinObj;
  w->base = (char *)base;
  w->size = (int64_t)size;
  w->disp_unit = disp_unit;
  w->comm = *c;
  int handle;
  {
    std::lock_guard<std::mutex> lk(g_wins_mu);
    g_wins[wid] = w;
    handle = g_next_win_handle++;
    g_win_handles[handle] = wid;
  }
  // all windows registered before any rank may start an epoch
  int rc = c_barrier(*c);
  if (rc != MPI_SUCCESS) return rc;
  *win = handle;
  return MPI_SUCCESS;
}

namespace {

WinObj *lookup_win(MPI_Win win, int64_t *wid_out = nullptr) {
  std::lock_guard<std::mutex> lk(g_wins_mu);
  auto h = g_win_handles.find(win);
  if (h == g_win_handles.end()) return nullptr;
  auto it = g_wins.find(h->second);
  if (it == g_wins.end()) return nullptr;
  if (wid_out) *wid_out = h->second;
  return it->second;
}

// origin-side packing of (count, dtype) into contiguous base bytes
int pack_origin(const void *addr, int count, MPI_Datatype dt,
                std::vector<char> &out, DtInfo &di) {
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  di = v.di;
  pack_dtype(addr, count, v, out);
  return MPI_SUCCESS;
}

}  // namespace

int MPI_Put(const void *origin_addr, int origin_count,
            MPI_Datatype origin_datatype, int target_rank,
            MPI_Aint target_disp, int target_count,
            MPI_Datatype target_datatype, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;
  if (target_rank < 0 || target_rank >= (int)c.group.size())
    return MPI_ERR_ARG;
  DtView tv;
  if (!resolve_dtype(target_datatype, tv)) return MPI_ERR_TYPE;
  // the wire op writes contiguous bytes at the target; a strided
  // target typemap would be silently flattened — reject it
  if (!tv.contiguous()) return MPI_ERR_TYPE;
  std::vector<char> data;
  DtInfo di;
  int rc = pack_origin(origin_addr, origin_count, origin_datatype, data, di);
  if (rc != MPI_SUCCESS) return rc;
  size_t want =
      (size_t)target_count * tv.elems_per_item() * tv.di.item;
  if (data.size() != want) return MPI_ERR_TRUNCATE;
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  int tw = world_of(c, target_rank);
  if (tw == g.rank) {
    char *dst = win_dst(w, disp, (int64_t)data.size());
    if (!dst) return MPI_ERR_ARG;
    std::lock_guard<std::mutex> lk(w->mu);
    memcpy(dst, data.data(), data.size());
    return MPI_SUCCESS;
  }
  std::string t;
  t.push_back((char)T_TUPLE);
  put_varint(t, 4);
  put_str(t, "wput");
  put_int(t, wid);
  put_int(t, disp);
  put_ndarray_1d(t, di.tag, data.data(),
                 data.size() / di.item, di.item);
  rc = win_send_tuple(tw, t);
  if (rc == MPI_SUCCESS) {
    std::lock_guard<std::mutex> lk(w->dirty_mu);
    w->dirty.insert(tw);
  }
  return rc;
}

int MPI_Accumulate(const void *origin_addr, int origin_count,
                   MPI_Datatype origin_datatype, int target_rank,
                   MPI_Aint target_disp, int target_count,
                   MPI_Datatype target_datatype, MPI_Op op, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;
  if (target_rank < 0 || target_rank >= (int)c.group.size())
    return MPI_ERR_ARG;
  if (g_user_ops.count(op))
    return MPI_ERR_OP;  // MPI: accumulate takes predefined ops only
  DtView tv;
  if (!resolve_dtype(target_datatype, tv)) return MPI_ERR_TYPE;
  if (!tv.contiguous()) return MPI_ERR_TYPE;  // see MPI_Put
  {
    int oprc = check_acc_op_pairing(
        tv.derived ? tv.derived->base : target_datatype, op);
    if (oprc != MPI_SUCCESS) return oprc;
  }
  std::vector<char> data;
  DtInfo di;
  int rc = pack_origin(origin_addr, origin_count, origin_datatype, data,
                       di);
  if (rc != MPI_SUCCESS) return rc;
  size_t want =
      (size_t)target_count * tv.elems_per_item() * tv.di.item;
  if (data.size() != want) return MPI_ERR_TRUNCATE;
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  int tw = world_of(c, target_rank);
  int n = (int)(data.size() / tv.di.item);
  if (tw == g.rank) {
    char *dst = win_dst(w, disp, (int64_t)data.size());
    if (!dst) return MPI_ERR_ARG;
    std::lock_guard<std::mutex> lk(w->mu);
    return reduce_buf(dst, data.data(), n,
                      tv.derived ? tv.derived->base : target_datatype, op);
  }
  std::string t;
  t.push_back((char)T_TUPLE);
  put_varint(t, 6);
  put_str(t, "wacc");
  put_int(t, wid);
  put_int(t, disp);
  put_int(t, (int64_t)op);
  put_int(t, (int64_t)(tv.derived ? tv.derived->base : target_datatype));
  put_ndarray_1d(t, di.tag, data.data(), data.size() / di.item, di.item);
  rc = win_send_tuple(tw, t);
  if (rc == MPI_SUCCESS) {
    std::lock_guard<std::mutex> lk(w->dirty_mu);
    w->dirty.insert(tw);
  }
  return rc;
}

int MPI_Get(void *origin_addr, int origin_count,
            MPI_Datatype origin_datatype, int target_rank,
            MPI_Aint target_disp, int target_count,
            MPI_Datatype target_datatype, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;
  if (target_rank < 0 || target_rank >= (int)c.group.size())
    return MPI_ERR_ARG;
  DtView ov, tv;
  if (!resolve_dtype(origin_datatype, ov) ||
      !resolve_dtype(target_datatype, tv))
    return MPI_ERR_TYPE;
  if (!tv.contiguous()) return MPI_ERR_TYPE;  // see MPI_Put
  size_t nbytes = (size_t)target_count * tv.elems_per_item() * tv.di.item;
  if (nbytes > 0x7FFFFFFFull) return MPI_ERR_COUNT;  // int request count
  size_t obytes = (size_t)origin_count * ov.elems_per_item() * ov.di.item;
  if (nbytes != obytes) return MPI_ERR_TRUNCATE;
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  int tw = world_of(c, target_rank);
  std::vector<char> raw(nbytes);
  if (tw == g.rank) {
    char *src_p = win_dst(w, (int64_t)disp, (int64_t)nbytes);
    if (!src_p) return MPI_ERR_ARG;
    std::lock_guard<std::mutex> lk(w->mu);
    memcpy(raw.data(), src_p, nbytes);
  } else {
    // RPC: post the reply recv, send the request, wait (the epoch is
    // active-target, so a blocking get inside it is the natural shape)
    int64_t rtag = g_next_reply_tag.fetch_add(1);
    Req r;
    r.is_recv = true;
    r.user_buf = raw.data();
    r.count = (int)nbytes;
    DtView bv;
    bv.di = {"|u1", 1};
    int handle = post_recv(&r, bv, WIN_CID, tw, rtag);
    std::string t;
    t.push_back((char)T_TUPLE);
    put_varint(t, 5);
    put_str(t, "wget");
    put_int(t, wid);
    put_int(t, disp);
    put_int(t, (int64_t)nbytes);
    put_int(t, rtag);
    int rc = win_send_tuple(tw, t);
    if (rc != MPI_SUCCESS) {
      std::lock_guard<std::mutex> lk(g.match_mu);
      deregister_locked(handle, &r);
      return rc;
    }
    MPI_Status st{};
    rc = wait_handle_impl(handle, &st, g.cts_timeout);
    if (rc != MPI_SUCCESS) return rc;
    if ((size_t)st._count != nbytes) return MPI_ERR_ARG;  // oob at target
  }
  if (ov.contiguous()) {
    memcpy(origin_addr, raw.data(), nbytes);
  } else {
    unpack_dtype(origin_addr, origin_count, ov, raw.data(), nbytes);
  }
  return MPI_SUCCESS;
}

/* Nonblocking window get (the shmem_get_nbi substrate): posts the
 * reply recv into `dest` and fires the wget RPC, returning a request
 * handle the caller completes with zompi_win_get_wait (normally from
 * shmem_quiet).  Not part of mpi.h. */
std::map<int, long long> g_nbi_want;  // handle -> expected reply bytes
std::mutex g_nbi_want_mu;

int zompi_win_get_start(MPI_Win win, int target_rank,
                        long long disp_bytes, long long nbytes,
                        void *dest, int *handle_out) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (target_rank < 0 || target_rank >= (int)c.group.size())
    return MPI_ERR_ARG;
  if (nbytes <= 0 || nbytes > 0x7FFFFFFFll || disp_bytes < 0)
    return MPI_ERR_ARG;
  int tw = world_of(c, target_rank);
  if (tw == g.rank) {
    if (disp_bytes + nbytes > w->size) return MPI_ERR_ARG;
    {
      std::lock_guard<std::mutex> lk(w->mu);
      memcpy(dest, w->base + disp_bytes, (size_t)nbytes);
    }
    Req *r;
    *handle_out = make_completed_req(MPI_COMM_WORLD, &r);
    r->status._count = nbytes;
    return MPI_SUCCESS;
  }
  int64_t rtag = g_next_reply_tag.fetch_add(1);
  Req *r = new Req;
  r->is_recv = true;
  r->heap = true;
  r->user_buf = dest;
  r->count = (int)nbytes;
  DtView bv;
  bv.di = {"|u1", 1};
  int handle = post_recv(r, bv, WIN_CID, tw, rtag);
  std::string t;
  t.push_back((char)T_TUPLE);
  put_varint(t, 5);
  put_str(t, "wget");
  put_int(t, wid);
  put_int(t, disp_bytes);
  put_int(t, nbytes);
  put_int(t, rtag);
  int rc = win_send_tuple(tw, t);
  if (rc != MPI_SUCCESS) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    deregister_locked(handle, r);
    delete r;
    return rc;
  }
  {
    std::lock_guard<std::mutex> lk(g_nbi_want_mu);
    g_nbi_want[handle] = nbytes;
  }
  *handle_out = handle;
  return MPI_SUCCESS;
}

int zompi_win_get_wait(int handle) {
  long long want = -1;
  {
    std::lock_guard<std::mutex> lk(g_nbi_want_mu);
    auto it = g_nbi_want.find(handle);
    if (it != g_nbi_want.end()) {
      want = it->second;
      g_nbi_want.erase(it);
    }
  }
  MPI_Status st{};
  int rc = wait_handle_impl(handle, &st, g.cts_timeout);
  if (rc != MPI_SUCCESS) return rc;
  // the target answers out-of-range requests with an EMPTY reply
  // (blocking MPI_Get has the same check): a short reply must surface
  if (want >= 0 && st._count != want) return MPI_ERR_ARG;
  return MPI_SUCCESS;
}

/* Fetch-AMO on a window cell (the C OSHMEM layer's substrate; not part
 * of mpi.h).  subkind: "add" | "set" | "swap" | "cas" | "fetch"; for
 * cas `operand` carries [compare][value].  Fills `old_out` (di.item
 * bytes) with the pre-op value.  Atomic at the target: the drain
 * applies under the window lock. */
int zompi_win_amo(MPI_Win win, int target_rank, long long disp_bytes,
                  const char *subkind, MPI_Datatype dt,
                  const void *operand, int operand_items, void *old_out) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (target_rank < 0 || target_rank >= (int)c.group.size())
    return MPI_ERR_ARG;
  DtInfo di;
  if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
  // NOTE: no bounds check against w->size here — windows are per-rank
  // sized (asymmetric exposure is legal), so only the TARGET can
  // validate the displacement (apply_amo does, on both paths)
  if (disp_bytes < 0) return MPI_ERR_ARG;
  std::string sub = subkind;
  // operand_items is the ELEMENT count: cas carries [compare][value]
  // (2, one result element), fetch carries none (count = items), the
  // rest carry `items` elements and return as many
  bool is_cas = sub == "cas";
  bool is_fetch = sub == "fetch";
  if (operand_items <= 0 || (is_cas && operand_items != 2))
    return MPI_ERR_ARG;
  int payload_items = is_fetch ? 0 : operand_items;
  if (payload_items > 0 && operand == nullptr) return MPI_ERR_ARG;
  int result_items = is_cas ? 1 : operand_items;
  int tw = world_of(c, target_rank);
  if (tw == g.rank) {
    std::vector<char> old;
    if (!apply_amo(w, disp_bytes, sub, dt, (const char *)operand,
                   (size_t)payload_items * di.item, old,
                   is_fetch ? operand_items : 1))
      return MPI_ERR_ARG;
    memcpy(old_out, old.data(), (size_t)result_items * di.item);
    return MPI_SUCCESS;
  }
  int64_t rtag = g_next_reply_tag.fetch_add(1);
  Req r;
  r.is_recv = true;
  r.user_buf = old_out;
  r.count = (int)((size_t)result_items * di.item);
  DtView bv;
  bv.di = {"|u1", 1};
  int handle = post_recv(&r, bv, WIN_CID, tw, rtag);
  char subbuf[24];
  const char *wire_sub = sub.c_str();
  if (is_fetch) {
    snprintf(subbuf, sizeof subbuf, "fetch:%d", operand_items);
    wire_sub = subbuf;
  }
  std::string t;
  t.push_back((char)T_TUPLE);
  put_varint(t, 7);
  put_str(t, "wamo");
  put_int(t, wid);
  put_int(t, disp_bytes);
  put_str(t, wire_sub);
  put_int(t, (int64_t)dt);
  put_ndarray_1d(t, di.tag, payload_items ? operand : "",
                 (uint64_t)payload_items, di.item);
  put_int(t, rtag);
  int rc = win_send_tuple(tw, t);
  if (rc != MPI_SUCCESS) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    deregister_locked(handle, &r);
    return rc;
  }
  MPI_Status st{};
  rc = wait_handle_impl(handle, &st, g.cts_timeout);
  if (rc != MPI_SUCCESS) return rc;
  if (st._count != (long long)((size_t)result_items * di.item))
    return MPI_ERR_ARG;
  return MPI_SUCCESS;
}

/* Flush this origin's outstanding puts/accumulates on the window (an
 * ack round-trip per dirty target; per-origin FIFO proves application).
 * Exported for the C OSHMEM layer's shmem_quiet, which completes
 * without the fence's closing barrier. */
int zompi_win_flush(MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  std::vector<int> targets;
  {
    std::lock_guard<std::mutex> lk(w->dirty_mu);
    targets.assign(w->dirty.begin(), w->dirty.end());
    w->dirty.clear();
  }
  for (size_t i = 0; i < targets.size(); i++) {
    int tw = targets[i];
    if (tw == g.rank) continue;
    int64_t rtag = g_next_reply_tag.fetch_add(1);
    Req r;
    char dummy;
    r.is_recv = true;
    r.user_buf = &dummy;
    r.count = 0;
    DtView bv;
    bv.di = {"|u1", 1};
    int handle = post_recv(&r, bv, WIN_CID, tw, rtag);
    std::string t;
    t.push_back((char)T_TUPLE);
    put_varint(t, 3);
    put_str(t, "wflush");
    put_int(t, wid);
    put_int(t, rtag);
    int rc = win_send_tuple(tw, t);
    if (rc == MPI_SUCCESS) {
      MPI_Status st{};
      rc = wait_handle_impl(handle, &st, g.cts_timeout);
    } else {
      std::lock_guard<std::mutex> lk(g.match_mu);
      deregister_locked(handle, &r);
    }
    if (rc != MPI_SUCCESS) {
      // unacknowledged targets stay dirty — a later flush/fence must
      // not report completion for unconfirmed puts
      std::lock_guard<std::mutex> lk(w->dirty_mu);
      for (size_t j = i; j < targets.size(); j++)
        w->dirty.insert(targets[j]);
      return rc;
    }
  }
  return MPI_SUCCESS;
}

int MPI_Win_fence(int /*assert_*/, MPI_Win win) {
  // flush every dirty target, then close the exposure epoch collectively
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  int rc = zompi_win_flush(win);
  if (rc != MPI_SUCCESS) return rc;
  return c_barrier(w->comm);
}

void delete_win_attrs(int win);  // defined with the win tier 2 section

int MPI_Win_free(MPI_Win *win) {
  if (!win) return MPI_ERR_ARG;
  int64_t wid;
  WinObj *w = lookup_win(*win, &wid);
  if (!w) return MPI_ERR_WIN;
  // attribute delete callbacks run BEFORE the handle dies (the
  // comm_free ordering, applied to windows)
  delete_win_attrs(*win);
  release_errh_ref(g_win_errh, *win);
  // quiesce: a conforming program has fenced/unlocked, so after this
  // barrier no peer can still address the window
  int rc = c_barrier(w->comm);
  {
    std::lock_guard<std::mutex> lk(g_wins_mu);
    g_wins.erase(wid);
    g_win_handles.erase(*win);
  }
  if (w->shm) {
    munmap(w->shm_map, w->shm_len);
    if (w->comm.local_rank == 0) shm_unlink(w->shm_path.c_str());
  } else if (w->owns_base) {
    free(w->base);
  }
  delete w;
  *win = MPI_WIN_NULL;
  return rc;
}

int MPI_Win_allocate(MPI_Aint size, int disp_unit, MPI_Info info,
                     MPI_Comm comm, void *baseptr, MPI_Win *win) {
  if (size < 0 || !baseptr) return MPI_ERR_ARG;
  void *base = size ? calloc(1, (size_t)size) : nullptr;
  if (size && !base) return MPI_ERR_OTHER;
  int rc = MPI_Win_create(base, size, disp_unit, info, comm, win);
  if (rc != MPI_SUCCESS) {
    free(base);
    return rc;
  }
  lookup_win(*win)->owns_base = true;
  *(void **)baseptr = base;
  return MPI_SUCCESS;
}

// passive target (win_lock.c / the AM plane's _LockManager): the
// target's drain arbitrates grants; a self-target acquire polls the
// local manager (no fairness guarantee, per MPI).

namespace {

int win_lock_rpc(WinObj *w, int64_t wid, int tw, const std::string &kind,
                 int lock_type) {
  int64_t rtag = g_next_reply_tag.fetch_add(1);
  Req r;
  char dummy;
  r.is_recv = true;
  r.user_buf = &dummy;
  r.count = 0;
  DtView bv;
  bv.di = {"|u1", 1};
  int handle = post_recv(&r, bv, WIN_CID, tw, rtag);
  std::string t;
  t.push_back((char)T_TUPLE);
  put_varint(t, kind == "wlock" ? 4 : 3);
  put_str(t, kind);
  put_int(t, wid);
  if (kind == "wlock") put_int(t, lock_type);
  put_int(t, rtag);
  int rc = win_send_tuple(tw, t);
  if (rc != MPI_SUCCESS) {
    std::lock_guard<std::mutex> lk(g.match_mu);
    deregister_locked(handle, &r);
    return rc;
  }
  MPI_Status st{};
  // lock grants legally wait for another origin's unlock: no timeout
  return wait_handle_impl(
      handle, &st, kind == "wlock" ? -1.0 : g.cts_timeout.load());
}

}  // namespace

int MPI_Win_lock(int lock_type, int rank, int /*assert_*/, MPI_Win win) {
  if (lock_type != MPI_LOCK_EXCLUSIVE && lock_type != MPI_LOCK_SHARED)
    return MPI_ERR_ARG;
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (rank < 0 || rank >= (int)c.group.size()) return MPI_ERR_ARG;
  int tw = world_of(c, rank);
  if (tw == g.rank) {
    for (;;) {
      {
        std::lock_guard<std::mutex> lk(w->lock_mu);
        if (lock_type == MPI_LOCK_EXCLUSIVE) {
          if (w->lock_excl_holder < 0 && w->lock_shared == 0) {
            w->lock_excl_holder = g.rank;
            return MPI_SUCCESS;
          }
        } else if (w->lock_excl_holder < 0) {
          w->lock_shared++;
          return MPI_SUCCESS;
        }
      }
      std::this_thread::sleep_for(std::chrono::microseconds(200));
      if (g.closing.load()) return MPI_ERR_OTHER;
    }
  }
  return win_lock_rpc(w, wid, tw, "wlock", lock_type);
}

int MPI_Win_unlock(int rank, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (rank < 0 || rank >= (int)c.group.size()) return MPI_ERR_ARG;
  // MPI: unlock completes all ops of the epoch at origin AND target
  int rc = MPI_Win_flush(rank, win);
  if (rc != MPI_SUCCESS) return rc;
  int tw = world_of(c, rank);
  if (tw == g.rank) {
    auto grants = release_and_grants(w, g.rank);
    for (auto &gr : grants) win_reply(gr[0], gr[2], "", 0);
    return MPI_SUCCESS;
  }
  return win_lock_rpc(w, wid, tw, "wunlock", 0);
}

int MPI_Win_flush(int rank, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (rank < 0 || rank >= (int)c.group.size()) return MPI_ERR_ARG;
  int tw = world_of(c, rank);
  {
    std::lock_guard<std::mutex> lk(w->dirty_mu);
    if (!w->dirty.count(tw)) return MPI_SUCCESS;
    w->dirty.erase(tw);
  }
  if (tw == g.rank) return MPI_SUCCESS;
  int rc = win_lock_rpc(w, wid, tw, "wflush", 0);
  if (rc != MPI_SUCCESS) {
    // an unacknowledged target stays dirty: a later flush/fence/unlock
    // must not report completion for puts that were never confirmed
    std::lock_guard<std::mutex> lk(w->dirty_mu);
    w->dirty.insert(tw);
  }
  return rc;
}

int MPI_Win_flush_all(MPI_Win win) { return zompi_win_flush(win); }

int MPI_Win_get_group(MPI_Win win, MPI_Group *group) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  *group = register_group(w->comm.group);
  return MPI_SUCCESS;
}

// PSCW active-target epochs (win_post.c family; the AM plane's
// identity-checked PSCW): post/complete notifications are plain empty
// messages on WIN_CID in tag ranges disjoint from the RPC reply tags.

namespace {

constexpr int64_t PSCW_POST_BASE = 1LL << 40;
constexpr int64_t PSCW_DONE_BASE = 1LL << 41;

int pscw_notify(int tw, int64_t tag) {
  if (tw == g.rank) {
    Message m;
    m.src = g.rank;
    m.tag = tag;
    m.cid = WIN_CID;
    m.seq = g.seq++;
    push_message(std::move(m));
    return MPI_SUCCESS;
  }
  std::string f;
  put_varint(f, 5);
  put_int(f, g.rank);
  put_int(f, tag);
  put_int(f, WIN_CID);
  put_int(f, g.seq++);
  put_bytes(f, "", 0);
  return peer_send_frame(tw, f);
}

int pscw_await(int from_world, int64_t tag) {
  Req r;
  char dummy;
  r.is_recv = true;
  r.user_buf = &dummy;
  r.count = 0;
  DtView bv;
  bv.di = {"|u1", 1};
  int handle = post_recv(&r, bv, WIN_CID, from_world, tag);
  MPI_Status st{};
  return wait_handle_impl(handle, &st);  // epochs legally wait
}

}  // namespace

int MPI_Win_post(MPI_Group group, int /*assert_*/, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  if (w->pscw_post_open) return MPI_ERR_ARG;  // epoch already open
  // group_ranks handles the MPI_GROUP_EMPTY sentinel (an empty epoch
  // is legal: a rank with no partners this round, MPI-3.1 11.5.2)
  const std::vector<int> *er = group_ranks(group);
  if (!er) return MPI_ERR_GROUP;
  w->pscw_post = *er;
  w->pscw_post_open = true;
  for (int tw : w->pscw_post) {
    int rc = pscw_notify(tw, PSCW_POST_BASE + wid);
    if (rc != MPI_SUCCESS) {
      w->pscw_post.clear();  // a wedged epoch would block forever
      w->pscw_post_open = false;
      return rc;
    }
  }
  return MPI_SUCCESS;  // post never blocks (win_post.c)
}

int MPI_Win_start(MPI_Group group, int /*assert_*/, MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  if (w->pscw_start_open) return MPI_ERR_ARG;
  const std::vector<int> *sr = group_ranks(group);
  if (!sr) return MPI_ERR_GROUP;
  w->pscw_start = *sr;
  w->pscw_start_open = true;
  // access epoch opens when every target has exposed (start MAY block)
  for (int tw : w->pscw_start) {
    int rc = pscw_await(tw, PSCW_POST_BASE + wid);
    if (rc != MPI_SUCCESS) {
      // a half-open epoch would wedge the window AND let a recovery
      // complete() replay DONE into unconsumed POSTs
      w->pscw_start.clear();
      w->pscw_start_open = false;
      return rc;
    }
  }
  return MPI_SUCCESS;
}

int MPI_Win_complete(MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  if (!w->pscw_start_open) return MPI_ERR_ARG;
  // ops must be APPLIED at the targets before the completion signal.
  // The epoch closes WHATEVER happens below: leaving pscw_start set
  // would let a retry re-send DONE to targets that already got one,
  // and a stale DONE would terminate their NEXT exposure epoch early.
  int rc = zompi_win_flush(win);
  for (int tw : w->pscw_start) {
    if (rc != MPI_SUCCESS) break;  // don't signal unflushed ops
    rc = pscw_notify(tw, PSCW_DONE_BASE + wid);
  }
  w->pscw_start.clear();
  w->pscw_start_open = false;
  return rc;
}

int MPI_Win_wait(MPI_Win win) {
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  if (!w->pscw_post_open) return MPI_ERR_ARG;
  for (int ow : w->pscw_post) {
    int rc = pscw_await(ow, PSCW_DONE_BASE + wid);
    if (rc != MPI_SUCCESS) return rc;
  }
  w->pscw_post.clear();
  w->pscw_post_open = false;
  return MPI_SUCCESS;
}

int MPI_Fetch_and_op(const void *origin_addr, void *result_addr,
                     MPI_Datatype dt, int target_rank,
                     MPI_Aint target_disp, MPI_Op op, MPI_Win win) {
  // fetch_and_op.c: single-element atomic fetch+op, predefined ops plus
  // MPI_REPLACE / MPI_NO_OP — all lower onto the wamo substrate
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;  // RMA no-op
  if (g_user_ops.count(op)) return MPI_ERR_OP;
  {
    int oprc = check_acc_op_pairing(dt, op);  // origin-side, like acc
    if (oprc != MPI_SUCCESS) return oprc;
  }
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  const char *sub;
  char subbuf[16];
  if (op == MPI_NO_OP) sub = "fetch";
  else if (op == MPI_REPLACE) sub = "swap";
  else if (op == MPI_SUM) sub = "add";
  else {
    snprintf(subbuf, sizeof subbuf, "aop:%d", op);
    sub = subbuf;
  }
  return zompi_win_amo(win, target_rank, disp, sub, dt,
                       op == MPI_NO_OP ? nullptr : origin_addr, 1,
                       result_addr);
}

int MPI_Get_accumulate(const void *origin_addr, int origin_count,
                       MPI_Datatype origin_datatype, void *result_addr,
                       int result_count, MPI_Datatype result_datatype,
                       int target_rank, MPI_Aint target_disp,
                       int target_count, MPI_Datatype target_datatype,
                       MPI_Op op, MPI_Win win) {
  // get_accumulate.c: atomic multi-element fetch+op; the whole span is
  // read and updated under the target's window lock (the wamo
  // substrate's generalized form)
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;
  if (g_user_ops.count(op)) return MPI_ERR_OP;
  DtView tv, rv;
  if (!resolve_dtype(target_datatype, tv) ||
      !resolve_dtype(result_datatype, rv))
    return MPI_ERR_TYPE;
  {
    // origin-side pairing check on the RESOLVED base (see Accumulate)
    int oprc = check_acc_op_pairing(
        tv.derived ? tv.derived->base : target_datatype, op);
    if (oprc != MPI_SUCCESS) return oprc;
  }
  if (!tv.contiguous()) return MPI_ERR_TYPE;  // see MPI_Put
  MPI_Datatype base_dt = tv.derived ? tv.derived->base : target_datatype;
  DtInfo di;
  if (!base_dtinfo(base_dt, di)) return MPI_ERR_TYPE;
  int64_t nelems = (int64_t)target_count * tv.elems_per_item();
  if (nelems == 0) return MPI_SUCCESS;  // zero-count no-op, like Put
  size_t nbytes = (size_t)nelems * di.item;
  if (nbytes > 0x7FFFFFFFull) return MPI_ERR_COUNT;  // int request count
  if ((size_t)result_count * rv.elems_per_item() * rv.di.item != nbytes)
    return MPI_ERR_TRUNCATE;
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  std::vector<char> origin;
  const char *sub;
  char subbuf[16];
  if (op == MPI_NO_OP) {
    sub = "fetch";
  } else {
    DtInfo odi;
    int rc = pack_origin(origin_addr, origin_count, origin_datatype,
                         origin, odi);
    if (rc != MPI_SUCCESS) return rc;
    if (origin.size() != nbytes) return MPI_ERR_TRUNCATE;
    if (op == MPI_REPLACE) sub = "swap";
    else if (op == MPI_SUM) sub = "add";
    else {
      snprintf(subbuf, sizeof subbuf, "aop:%d", op);
      sub = subbuf;
    }
  }
  std::vector<char> old(nbytes);
  int rc = zompi_win_amo(win, target_rank, disp, sub, base_dt,
                         op == MPI_NO_OP ? nullptr : origin.data(),
                         (int)nelems, old.data());
  if (rc != MPI_SUCCESS) return rc;
  if (rv.contiguous()) memcpy(result_addr, old.data(), nbytes);
  else unpack_dtype(result_addr, result_count, rv, old.data(), nbytes);
  return MPI_SUCCESS;
}

int MPI_Compare_and_swap(const void *origin_addr, const void *compare_addr,
                         void *result_addr, MPI_Datatype dt,
                         int target_rank, MPI_Aint target_disp,
                         MPI_Win win) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (target_rank == MPI_PROC_NULL) return MPI_SUCCESS;  // RMA no-op
  DtInfo di;
  if (!base_dtinfo(dt, di)) return MPI_ERR_TYPE;
  std::vector<char> opnd(2 * di.item);
  memcpy(opnd.data(), compare_addr, di.item);
  memcpy(opnd.data() + di.item, origin_addr, di.item);
  int64_t disp = (int64_t)target_disp * w->disp_unit;
  return zompi_win_amo(win, target_rank, disp, "cas", dt, opnd.data(), 2,
                       result_addr);
}

// ----------------------------------------------- utilities (round 5)
// Versions/threads, error classes, memory, local reduction, request
// and status utilities, Fortran handle conversion.  Reference bindings:
// get_version.c, init_thread.c, add_error_class.c, alloc_mem.c,
// reduce_local.c, request_get_status.c, waitsome.c, cancel.c,
// sendrecv_replace.c, comm_c2f.c et al.

int MPI_Get_version(int *version, int *subversion) {
  *version = MPI_VERSION;
  *subversion = MPI_SUBVERSION;
  return MPI_SUCCESS;
}

int MPI_Get_library_version(char *version, int *resultlen) {
  snprintf(version, MPI_MAX_LIBRARY_VERSION_STRING,
           "zhpe-ompi-tpu C shim (mpi.h-compatible host plane), "
           "MPI %d.%d surface", MPI_VERSION, MPI_SUBVERSION);
  *resultlen = (int)strlen(version);
  return MPI_SUCCESS;
}

int MPI_Init_thread(int *argc, char ***argv, int required, int *provided) {
  // the engine's internal locks serialize the matching/send paths;
  // SERIALIZED is the honest ceiling (init_thread.c's shape: provided
  // = min(required, ceiling))
  int ceiling = MPI_THREAD_SERIALIZED;
  int rc = MPI_Init(argc, argv);
  if (rc != MPI_SUCCESS) return rc;
  g_thread_level = required < ceiling ? required : ceiling;
  if (g_thread_level < MPI_THREAD_SINGLE)
    g_thread_level = MPI_THREAD_SINGLE;
  if (provided) *provided = g_thread_level;
  extern void build_env_info_hook(void);
  build_env_info_hook();  // the snapshot's thread_level key moved
  return MPI_SUCCESS;
}

int MPI_Query_thread(int *provided) {
  *provided = g_thread_level;
  return MPI_SUCCESS;
}

int MPI_Is_thread_main(int *flag) {
  *flag = std::this_thread::get_id() == g_main_tid ? 1 : 0;
  return MPI_SUCCESS;
}

int MPI_Finalized(int *flag) {
  *flag = g_finalized_flag ? 1 : 0;
  return MPI_SUCCESS;
}

int MPI_Error_class(int errorcode, int *errorclass) {
  auto it = g_err_class.find(errorcode);
  *errorclass = it != g_err_class.end() ? it->second : errorcode;
  return MPI_SUCCESS;
}

int MPI_Add_error_class(int *errorclass) {
  int c = g_next_err++;
  g_err_class[c] = c;
  *errorclass = c;
  return MPI_SUCCESS;
}

int MPI_Add_error_code(int errorclass, int *errorcode) {
  int c = g_next_err++;
  g_err_class[c] = errorclass;
  *errorcode = c;
  return MPI_SUCCESS;
}

int MPI_Add_error_string(int errorcode, const char *string) {
  g_err_strings[errorcode] = string ? string : "";
  return MPI_SUCCESS;
}

int MPI_Alloc_mem(MPI_Aint size, MPI_Info, void *baseptr) {
  if (size < 0) return MPI_ERR_ARG;
  void *p = malloc(size ? (size_t)size : 1);
  if (!p) return MPI_ERR_OTHER;
  *(void **)baseptr = p;
  return MPI_SUCCESS;
}

int MPI_Free_mem(void *base) {
  free(base);
  return MPI_SUCCESS;
}

int MPI_Get_address(const void *location, MPI_Aint *address) {
  *address = (MPI_Aint)(uintptr_t)location;
  return MPI_SUCCESS;
}

int MPI_Address(void *location, MPI_Aint *address) {
  return MPI_Get_address(location, address);
}

MPI_Aint MPI_Aint_add(MPI_Aint base, MPI_Aint disp) {
  // aint_add.c: defined in terms of char* arithmetic
  return (MPI_Aint)(uintptr_t)((char *)(uintptr_t)base + disp);
}

MPI_Aint MPI_Aint_diff(MPI_Aint addr1, MPI_Aint addr2) {
  return (MPI_Aint)((char *)(uintptr_t)addr1 -
                    (char *)(uintptr_t)addr2);
}

int MPI_Op_commutative(MPI_Op op, int *commute) {
  auto uit = g_user_ops.find(op);
  if (uit != g_user_ops.end()) {
    *commute = uit->second.commute ? 1 : 0;
    return MPI_SUCCESS;
  }
  if (op < 0 || op > MPI_NO_OP) return MPI_ERR_OP;
  *commute = 1;  // every predefined op here is commutative
  return MPI_SUCCESS;
}

int MPI_Reduce_local(const void *inbuf, void *inoutbuf, int count,
                     MPI_Datatype dt, MPI_Op op) {
  // reduce_local.c: inout = in (op) inout, invec the LEFT operand
  if (count < 0) return MPI_ERR_COUNT;
  auto uit = g_user_ops.find(op);
  if (uit != g_user_ops.end()) {
    // exactly the user-function contract — no copies needed
    int len = count;
    MPI_Datatype d = dt;
    uit->second.fn((void *)inbuf, inoutbuf, &len, &d);
    return MPI_SUCCESS;
  }
  // predefined ops are commutative, so acc-left reduce_buf matches
  return reduce_buf(inoutbuf, inbuf, count, dt, op);
}

int MPI_Request_get_status(MPI_Request request, int *flag,
                           MPI_Status *status) {
  // request_get_status.c: non-destructive completion query — the
  // request is neither freed nor deactivated
  if (request == MPI_REQUEST_NULL) {
    *flag = 1;
    empty_status(status);
    return MPI_SUCCESS;
  }
  int inner = request;
  if (request < MPI_REQUEST_NULL) {
    auto pit = g_persistent.find(-request);
    if (pit == g_persistent.end()) return MPI_ERR_REQUEST;
    if (pit->second.active == MPI_REQUEST_NULL) {
      MPI_Request nullr = MPI_REQUEST_NULL;
      return MPI_Request_get_status(nullr, flag, status);
    }
    inner = pit->second.active;
  }
  Req *r;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto it = g.reqs.find(inner);
    if (it == g.reqs.end()) return MPI_ERR_REQUEST;
    r = it->second;
    if (!r->complete) {
      *flag = 0;
      return MPI_SUCCESS;
    }
  }
  // The operation is being REPORTED complete, so the receive buffer
  // must be usable now: run the derived-type unpack (idempotent; the
  // later Wait/Test sees needs_unpack already cleared).  Outside
  // match_mu — a multi-MB unpack must not stall the matching threads —
  // which is safe at the declared MPI_THREAD_SERIALIZED level: only
  // the (single) app thread completes requests, so `r` cannot be
  // Wait-freed concurrently.
  finish_recv(r);
  *flag = 1;
  if (status) {
    *status = r->status;
    translate_status(lookup_comm(r->comm), status);
  }
  return MPI_SUCCESS;
}

namespace {

// one completion sweep shared by Waitsome/Testsome: harvest every
// currently-complete ACTIVE request, Wait-ing each to run its normal
// retire path.  Null handles and inactive persistent handles do not
// participate (waitsome.c: outcount is MPI_UNDEFINED when no handle is
// active).  *any_active reports whether an active handle exists; on an
// error mid-harvest, *outcount counts only the fully-retired entries,
// so indices/statuses[0..outcount) are always valid.  match_mu must
// NOT be held.
int harvest_some(int incount, MPI_Request requests[], int *outcount,
                 int indices[], MPI_Status statuses[], bool *any_active) {
  std::vector<int> ready;
  *any_active = false;
  *outcount = 0;  // defined even on an early MPI_ERR_REQUEST return
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (int i = 0; i < incount; i++) {
      MPI_Request h = requests[i];
      if (h == MPI_REQUEST_NULL) continue;
      int inner = h;
      if (h < MPI_REQUEST_NULL) {
        auto pit = g_persistent.find(-h);
        if (pit == g_persistent.end()) return MPI_ERR_REQUEST;
        if (pit->second.active == MPI_REQUEST_NULL)
          continue;  // inactive persistent: not a participant
        inner = pit->second.active;
      }
      auto it = g.reqs.find(inner);
      if (it == g.reqs.end()) return MPI_ERR_REQUEST;
      *any_active = true;
      if (it->second->complete) ready.push_back(i);
    }
  }
  int first_err = MPI_SUCCESS;
  for (size_t k = 0; k < ready.size(); k++) {
    indices[k] = ready[k];
    MPI_Status tmp;
    MPI_Status *sp = statuses ? &statuses[k] : &tmp;
    int rc = MPI_Wait(&requests[ready[k]], sp);
    *outcount = (int)k + 1;  // the completion is REPORTED even on error
    if (rc != MPI_SUCCESS) {
      // waitsome.c contract: per-request failures surface as
      // MPI_ERR_IN_STATUS with the code in statuses[k].MPI_ERROR; the
      // harvest continues so no completed request is silently lost
      sp->MPI_ERROR = rc;
      if (first_err == MPI_SUCCESS) first_err = MPI_ERR_IN_STATUS;
    }
  }
  return first_err;
}

}  // namespace

int MPI_Waitsome(int incount, MPI_Request requests[], int *outcount,
                 int indices[], MPI_Status statuses[]) {
  while (true) {
    bool any_active = false;
    int rc = harvest_some(incount, requests, outcount, indices, statuses,
                          &any_active);
    if (rc != MPI_SUCCESS) return rc;
    if (!any_active) {
      *outcount = MPI_UNDEFINED;
      return MPI_SUCCESS;
    }
    if (*outcount > 0) return MPI_SUCCESS;
    std::unique_lock<std::mutex> lk(g.match_mu);
    g.match_cv.wait_for(lk, std::chrono::milliseconds(100));
    if (g.closing.load()) return MPI_ERR_OTHER;
  }
}

int MPI_Testsome(int incount, MPI_Request requests[], int *outcount,
                 int indices[], MPI_Status statuses[]) {
  bool any_active = false;
  int rc = harvest_some(incount, requests, outcount, indices, statuses,
                        &any_active);
  if (rc != MPI_SUCCESS) return rc;
  if (!any_active) *outcount = MPI_UNDEFINED;
  return MPI_SUCCESS;
}

int MPI_Cancel(MPI_Request *request) {
  // cancel.c semantics, reduced to the deterministically-cancellable
  // case: an UNMATCHED posted receive is withdrawn and completes with
  // the cancelled bit; anything else (sends, matched receives) is left
  // to complete normally — MPI_Test_cancelled then reports false,
  // which is a legal outcome of MPI_Cancel
  if (!request || *request == MPI_REQUEST_NULL) return MPI_ERR_REQUEST;
  if (*request < MPI_REQUEST_NULL) return MPI_ERR_REQUEST;
  std::lock_guard<std::mutex> lk(g.match_mu);
  auto it = g.reqs.find(*request);
  if (it == g.reqs.end()) return MPI_ERR_REQUEST;
  Req *r = it->second;
  if (!r->is_recv || r->complete) return MPI_SUCCESS;
  for (auto pit = g.posted.begin(); pit != g.posted.end(); ++pit) {
    if (pit->req == r) {
      g.posted.erase(pit);
      r->status.MPI_SOURCE = MPI_ANY_SOURCE;
      r->status.MPI_TAG = MPI_ANY_TAG;
      r->status.MPI_ERROR = MPI_SUCCESS;
      r->status._count = 0;
      r->status._cancelled = 1;
      r->complete = true;
      g.match_cv.notify_all();
      return MPI_SUCCESS;
    }
  }
  return MPI_SUCCESS;  // matched already (e.g. parked rendezvous)
}

int MPI_Test_cancelled(const MPI_Status *status, int *flag) {
  *flag = status->_cancelled ? 1 : 0;
  return MPI_SUCCESS;
}

int MPI_Status_set_cancelled(MPI_Status *status, int flag) {
  status->_cancelled = flag ? 1 : 0;
  return MPI_SUCCESS;
}

int MPI_Get_elements_x(const MPI_Status *status, MPI_Datatype dt,
                       MPI_Count *count) {
  // get_elements.c: BASIC-element count, partial items included —
  // _count carries wire bytes of packed base elements.  A pair record
  // holds TWO basic elements (value + index), MPI-3.1 §5.9.4.
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  if (v.di.item == 0) return MPI_ERR_TYPE;
  MPI_Datatype base = v.derived ? v.derived->base : dt;
  long long units = status->_count / (long long)v.di.item;
  if (is_pair_dtype(base)) {
    // 2 basics per record; a half-record remainder counts as 1 (the
    // set_elements inverse stores count*item/2 bytes, so odd counts
    // round-trip exactly)
    long long rem = status->_count % (long long)v.di.item;
    *count = (MPI_Count)(units * 2 + (rem > 0 ? 1 : 0));
  } else {
    *count = (MPI_Count)units;
  }
  return MPI_SUCCESS;
}

int MPI_Get_elements(const MPI_Status *status, MPI_Datatype dt,
                     int *count) {
  MPI_Count n;
  int rc = MPI_Get_elements_x(status, dt, &n);
  if (rc != MPI_SUCCESS) return rc;
  *count = n > 2147483647LL ? MPI_UNDEFINED : (int)n;
  return MPI_SUCCESS;
}

int MPI_Status_set_elements_x(MPI_Status *status, MPI_Datatype dt,
                              MPI_Count count) {
  // status_set_elements.c contract: a subsequent Get_elements returns
  // EXACTLY `count` — for pair types that means count BASIC elements
  // (2 per record), so store half an item per basic
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  MPI_Datatype base = v.derived ? v.derived->base : dt;
  if (is_pair_dtype(base))
    status->_count = (long long)count * (long long)v.di.item / 2;
  else
    status->_count = (long long)count * (long long)v.di.item;
  return MPI_SUCCESS;
}

int MPI_Status_set_elements(MPI_Status *status, MPI_Datatype dt,
                            int count) {
  return MPI_Status_set_elements_x(status, dt, (MPI_Count)count);
}

int MPI_Sendrecv_replace(void *buf, int count, MPI_Datatype dt, int dest,
                         int sendtag, int source, int recvtag,
                         MPI_Comm comm, MPI_Status *status) {
  // sendrecv_replace.c: snapshot the full extent region, post the
  // receive into the user buffer, send from the snapshot (same
  // typemap, so layout is preserved), then wait both
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  DtView v;
  if (!resolve_dtype(dt, v)) return MPI_ERR_TYPE;
  // pack touches only typemap bytes — a raw extent-sized memcpy would
  // overread the trailing gap of a strided type (a conforming buffer
  // may end at the last typemap byte).  The wire carries packed base
  // elements for any send, so the snapshot goes out as base elements
  // directly: identical bytes to sending `buf` with `dt`.
  std::vector<char> packed;
  pack_dtype(buf, count, v, packed);
  MPI_Datatype base_dt = v.derived ? v.derived->base : dt;
  int base_elems = (int)((int64_t)count * v.elems_per_item());
  MPI_Request rreq;
  int rc = MPI_Irecv(buf, count, dt, source, recvtag, comm, &rreq);
  if (rc != MPI_SUCCESS) return rc;
  rc = MPI_Send(packed.data(), base_elems, base_dt, dest, sendtag, comm);
  if (rc != MPI_SUCCESS) {
    // never leave a posted receive aimed at the caller's buffer: a
    // later matching message would land in a dead stack frame
    MPI_Cancel(&rreq);
    MPI_Wait(&rreq, MPI_STATUS_IGNORE);
    return rc;
  }
  return MPI_Wait(&rreq, status);
}

int MPI_Pcontrol(const int, ...) { return MPI_SUCCESS; }

MPI_Fint MPI_Comm_c2f(MPI_Comm comm) { return (MPI_Fint)comm; }
MPI_Comm MPI_Comm_f2c(MPI_Fint comm) { return (MPI_Comm)comm; }
MPI_Fint MPI_Type_c2f(MPI_Datatype dt) { return (MPI_Fint)dt; }
MPI_Datatype MPI_Type_f2c(MPI_Fint dt) { return (MPI_Datatype)dt; }
MPI_Fint MPI_Group_c2f(MPI_Group group) { return (MPI_Fint)group; }
MPI_Group MPI_Group_f2c(MPI_Fint group) { return (MPI_Group)group; }
MPI_Fint MPI_Op_c2f(MPI_Op op) { return (MPI_Fint)op; }
MPI_Op MPI_Op_f2c(MPI_Fint op) { return (MPI_Op)op; }
MPI_Fint MPI_Request_c2f(MPI_Request request) { return (MPI_Fint)request; }
MPI_Request MPI_Request_f2c(MPI_Fint request) {
  return (MPI_Request)request;
}
MPI_Fint MPI_Win_c2f(MPI_Win win) { return (MPI_Fint)win; }
MPI_Win MPI_Win_f2c(MPI_Fint win) { return (MPI_Win)win; }
MPI_Fint MPI_File_c2f(MPI_File file) { return (MPI_Fint)file; }
MPI_File MPI_File_f2c(MPI_Fint file) { return (MPI_File)file; }
MPI_Fint MPI_Info_c2f(MPI_Info info) { return (MPI_Fint)info; }
MPI_Info MPI_Info_f2c(MPI_Fint info) { return (MPI_Info)info; }

int MPI_Status_c2f(const MPI_Status *c_status, MPI_Fint *f_status) {
  f_status[0] = c_status->MPI_SOURCE;
  f_status[1] = c_status->MPI_TAG;
  f_status[2] = c_status->MPI_ERROR;
  f_status[3] = (MPI_Fint)(c_status->_count & 0x7FFFFFFF);
  f_status[4] = (MPI_Fint)(c_status->_count >> 31);
  f_status[5] = c_status->_cancelled;
  return MPI_SUCCESS;
}

int MPI_Status_f2c(const MPI_Fint *f_status, MPI_Status *c_status) {
  c_status->MPI_SOURCE = f_status[0];
  c_status->MPI_TAG = f_status[1];
  c_status->MPI_ERROR = f_status[2];
  c_status->_count =
      (long long)f_status[3] | ((long long)f_status[4] << 31);
  c_status->_cancelled = f_status[5];
  return MPI_SUCCESS;
}

// --------------------------------------------- win tier 2 (round 5)
// win_lock_all.c, win_sync.c, win_test.c, win_create_dynamic.c,
// win_allocate_shared.c, win_create_keyval.c families.

int MPI_Win_lock_all(int /*assert_*/, MPI_Win win) {
  // a shared lock on every member: shared grants coexist, so the
  // rank-ordered loop cannot deadlock (win_lock_all.c semantics)
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  int n = (int)w->comm.group.size();
  for (int r = 0; r < n; r++) {
    int rc = MPI_Win_lock(MPI_LOCK_SHARED, r, 0, win);
    if (rc != MPI_SUCCESS) return rc;
  }
  return MPI_SUCCESS;
}

int MPI_Win_unlock_all(MPI_Win win) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  int n = (int)w->comm.group.size();
  int first_err = MPI_SUCCESS;
  for (int r = 0; r < n; r++) {
    int rc = MPI_Win_unlock(r, win);
    if (rc != MPI_SUCCESS && first_err == MPI_SUCCESS) first_err = rc;
  }
  return first_err;
}

int MPI_Win_flush_local(int rank, MPI_Win win) {
  // every op packs its origin buffer into the wire frame AT CALL TIME
  // (pack_origin / put_ndarray_1d copies), so local completion is
  // immediate — the reference's osc_rdma distinguishes these; here
  // local-flush is a no-op by construction
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  CommObj &c = w->comm;
  if (rank < 0 || rank >= (int)c.group.size()) return MPI_ERR_ARG;
  return MPI_SUCCESS;
}

int MPI_Win_flush_local_all(MPI_Win win) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  return MPI_SUCCESS;
}

int MPI_Win_sync(MPI_Win win) {
  // win_sync.c: memory-barrier the public/private window copies; the
  // shim's window IS process memory, so a hardware fence suffices
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return MPI_SUCCESS;
}

int MPI_Win_test(MPI_Win win, int *flag) {
  // win_test.c: nonblocking Win_wait — consume whatever DONE
  // notifications have arrived; the epoch closes when all are in
  int64_t wid;
  WinObj *w = lookup_win(win, &wid);
  if (!w) return MPI_ERR_WIN;
  if (!w->pscw_post_open) return MPI_ERR_ARG;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    for (auto it = w->pscw_post.begin(); it != w->pscw_post.end();) {
      bool got = false;
      for (auto u = g.unexpected.begin(); u != g.unexpected.end(); ++u) {
        if (u->mhandle) continue;
        if (u->cid == WIN_CID && u->src == *it &&
            u->tag == PSCW_DONE_BASE + wid) {
          g.unexpected.erase(u);
          got = true;
          break;
        }
      }
      if (got) it = w->pscw_post.erase(it);
      else ++it;
    }
  }
  if (w->pscw_post.empty()) {
    w->pscw_post_open = false;
    *flag = 1;
  } else {
    *flag = 0;
  }
  return MPI_SUCCESS;
}

int MPI_Win_create_dynamic(MPI_Info info, MPI_Comm comm, MPI_Win *win) {
  // win_create_dynamic.c: no storage at creation; Win_attach exposes
  // regions, target_disp addresses absolute bytes (win_dst validates)
  int rc = MPI_Win_create(nullptr, 0, 1, info, comm, win);
  if (rc != MPI_SUCCESS) return rc;
  lookup_win(*win)->dynamic = true;
  return MPI_SUCCESS;
}

int MPI_Win_attach(MPI_Win win, void *base, MPI_Aint size) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (!w->dynamic) return MPI_ERR_WIN;
  if (!base || size < 0) return MPI_ERR_ARG;
  std::lock_guard<std::mutex> lk(w->attach_mu);
  w->attached.push_back({(uint64_t)(uintptr_t)base, (uint64_t)size});
  return MPI_SUCCESS;
}

int MPI_Win_detach(MPI_Win win, const void *base) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (!w->dynamic) return MPI_ERR_WIN;
  std::lock_guard<std::mutex> lk(w->attach_mu);
  for (auto it = w->attached.begin(); it != w->attached.end(); ++it)
    if (it->first == (uint64_t)(uintptr_t)base) {
      w->attached.erase(it);
      return MPI_SUCCESS;
    }
  return MPI_ERR_ARG;
}

int MPI_Win_allocate_shared(MPI_Aint size, int disp_unit, MPI_Info info,
                            MPI_Comm comm, void *baseptr, MPI_Win *win) {
  // win_allocate_shared.c: one POSIX shm segment per window, every
  // member maps the whole thing; rank r's slice starts at the sum of
  // earlier sizes.  Requires same-host members (Comm_split_type's
  // SHARED comm is the intended parent).
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (size < 0 || disp_unit <= 0 || !baseptr) return MPI_ERR_ARG;
  int n = (int)c->group.size();
  std::vector<int64_t> mine = {(int64_t)size, (int64_t)disp_unit};
  std::vector<int64_t> all(2 * (size_t)n);
  int rc = c_allgather(*c, mine.data(), 2, MPI_LONG, all.data(), 2,
                       MPI_LONG);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int64_t> sizes((size_t)n), offsets((size_t)n);
  std::vector<int> units((size_t)n);
  int64_t total = 0;
  for (int r = 0; r < n; r++) {
    sizes[(size_t)r] = all[2 * (size_t)r];
    units[(size_t)r] = (int)all[2 * (size_t)r + 1];
    offsets[(size_t)r] = total;
    total += sizes[(size_t)r];
  }
  // deterministic segment name: every member computes the same (the
  // same collapse as the wire win-id)
  char path[128];
  snprintf(path, sizeof path, "/zompi_shm_%s_%llx_%llu", session_tag(),
           (unsigned long long)c->cid_pt2pt,
           (unsigned long long)c->win_seq);
  size_t map_len = total > 0 ? (size_t)total : 1;
  int fd;
  if (c->local_rank == 0) {
    shm_unlink(path);  // stale segment from a crashed job
    fd = shm_open(path, O_CREAT | O_RDWR, 0600);
    if (fd >= 0 && ftruncate(fd, (off_t)map_len) != 0) {
      close(fd);
      fd = -1;
    }
    rc = c_barrier(*c);  // segment exists before peers open
  } else {
    rc = c_barrier(*c);
    fd = rc == MPI_SUCCESS ? shm_open(path, O_RDWR, 0600) : -1;
  }
  char *map = (char *)MAP_FAILED;
  if (fd >= 0) {
    map = (char *)mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
                       MAP_SHARED, fd, 0);
    close(fd);
  }
  // agree on success: a lone failing rank (ENOSPC truncate, failed
  // open/mmap) must produce a UNIFORM error, never a half-entered
  // Win_create barrier (collective hang)
  int64_t ok = (rc == MPI_SUCCESS && fd >= 0 && map != MAP_FAILED)
                   ? 1 : 0;
  std::vector<int64_t> oks((size_t)n);
  int rc2 = c_allgather(*c, &ok, 1, MPI_LONG, oks.data(), 1, MPI_LONG);
  bool all_ok = rc2 == MPI_SUCCESS;
  for (int r = 0; all_ok && r < n; r++) all_ok = oks[(size_t)r] == 1;
  if (!all_ok) {
    if (map != MAP_FAILED) munmap(map, map_len);
    if (c->local_rank == 0) shm_unlink(path);
    return MPI_ERR_OTHER;
  }
  char *my_base = map + offsets[(size_t)c->local_rank];
  rc = MPI_Win_create(size ? my_base : nullptr, size, disp_unit, info,
                      comm, win);
  if (rc != MPI_SUCCESS) {
    munmap(map, map_len);
    return rc;
  }
  WinObj *w = lookup_win(*win);
  w->base = my_base;  // even a zero-size slice keeps its map position
  w->shm = true;
  w->shm_map = map;
  w->shm_len = map_len;
  w->shm_path = path;
  w->shm_sizes = std::move(sizes);
  w->shm_units = std::move(units);
  w->shm_offsets = std::move(offsets);
  *(void **)baseptr = my_base;
  return MPI_SUCCESS;
}

int MPI_Win_shared_query(MPI_Win win, int rank, MPI_Aint *size,
                         int *disp_unit, void *baseptr) {
  WinObj *w = lookup_win(win);
  if (!w) return MPI_ERR_WIN;
  if (!w->shm) return MPI_ERR_WIN;
  int n = (int)w->comm.group.size();
  if (rank == MPI_PROC_NULL) {
    // the lowest rank with a non-zero slice (win_shared_query.c)
    rank = 0;
    for (int r = 0; r < n; r++)
      if (w->shm_sizes[(size_t)r] > 0) {
        rank = r;
        break;
      }
  }
  if (rank < 0 || rank >= n) return MPI_ERR_ARG;
  *size = (MPI_Aint)w->shm_sizes[(size_t)rank];
  *disp_unit = w->shm_units[(size_t)rank];
  *(void **)baseptr = w->shm_map + w->shm_offsets[(size_t)rank];
  return MPI_SUCCESS;
}

// win attribute caching: the comm keyval machinery, instantiated for
// windows (the reference shares one attribute engine; two small maps
// reach the same behavior here)
struct WinKeyvalObj {
  MPI_Win_copy_attr_function *copy_fn;
  MPI_Win_delete_attr_function *delete_fn;
  void *extra_state;
  bool freed = false;
};
static std::map<int, WinKeyvalObj> g_win_keyvals;
static int g_next_win_keyval = 0;
static std::map<std::pair<int, int>, void *> g_win_attrs;

void delete_win_attrs(int win) {
  for (auto it = g_win_attrs.begin(); it != g_win_attrs.end();) {
    if (it->first.first == win) {
      auto kv = g_win_keyvals.find(it->first.second);
      if (kv != g_win_keyvals.end() && kv->second.delete_fn)
        kv->second.delete_fn(win, it->first.second, it->second,
                             kv->second.extra_state);
      it = g_win_attrs.erase(it);
    } else {
      ++it;
    }
  }
}

int MPI_Win_create_keyval(MPI_Win_copy_attr_function *copy_fn,
                          MPI_Win_delete_attr_function *delete_fn,
                          int *keyval, void *extra_state) {
  if (!keyval) return MPI_ERR_ARG;
  int kv = g_next_win_keyval++;
  g_win_keyvals[kv] = {copy_fn, delete_fn, extra_state};
  *keyval = kv;
  return MPI_SUCCESS;
}

int MPI_Win_free_keyval(int *keyval) {
  if (!keyval) return MPI_ERR_ARG;
  auto it = g_win_keyvals.find(*keyval);
  if (it == g_win_keyvals.end()) return MPI_ERR_ARG;
  it->second.freed = true;
  bool referenced = false;
  for (auto &e : g_win_attrs)
    if (e.first.second == *keyval) referenced = true;
  if (!referenced) g_win_keyvals.erase(it);
  *keyval = MPI_KEYVAL_INVALID;
  return MPI_SUCCESS;
}

int MPI_Win_set_attr(MPI_Win win, int keyval, void *attribute_val) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  auto kv = g_win_keyvals.find(keyval);
  if (kv == g_win_keyvals.end() || kv->second.freed) return MPI_ERR_ARG;
  auto it = g_win_attrs.find({win, keyval});
  if (it != g_win_attrs.end() && kv->second.delete_fn)
    kv->second.delete_fn(win, keyval, it->second, kv->second.extra_state);
  g_win_attrs[{win, keyval}] = attribute_val;
  return MPI_SUCCESS;
}

int MPI_Win_get_attr(MPI_Win win, int keyval, void *attribute_val,
                     int *flag) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  auto it = g_win_attrs.find({win, keyval});
  *flag = it != g_win_attrs.end() ? 1 : 0;
  if (*flag) *(void **)attribute_val = it->second;
  return MPI_SUCCESS;
}

int MPI_Win_delete_attr(MPI_Win win, int keyval) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  auto it = g_win_attrs.find({win, keyval});
  if (it == g_win_attrs.end()) return MPI_ERR_ARG;
  auto kv = g_win_keyvals.find(keyval);
  if (kv != g_win_keyvals.end() && kv->second.delete_fn)
    kv->second.delete_fn(win, keyval, it->second, kv->second.extra_state);
  g_win_attrs.erase(it);
  if (kv != g_win_keyvals.end() && kv->second.freed) {
    bool referenced = false;
    for (auto &e : g_win_attrs)
      if (e.first.second == keyval) referenced = true;
    if (!referenced) g_win_keyvals.erase(kv);
  }
  return MPI_SUCCESS;
}

// ------------------------------------ info objects + naming (round 5)
// info_create.c family: ordered string dictionaries (order matters for
// get_nthkey); comm/win/file carry deep COPIES (set_info snapshots,
// get_info returns a fresh dup the caller frees — MPI-3.1 §6.4.4).

struct InfoObj {
  std::vector<std::pair<std::string, std::string>> kv;
  const std::string *find(const char *key) const {
    for (auto &e : kv)
      if (e.first == key) return &e.second;
    return nullptr;
  }
};
static std::map<int, InfoObj> g_infos;
static int g_next_info = 1;  // 0 = MPI_INFO_NULL

// the MPI_INFO_ENV snapshot: built EAGERLY at the end of MPI_Init
// (wdir must be the LAUNCH directory, not wherever the app chdir'd
// before first touching the object — MPI-3.1 10.5.3), read-only after
static InfoObj g_env_info;

void build_env_info() {
  g_env_info.kv.clear();
  char buf[4096];
  ssize_t n2 = readlink("/proc/self/exe", buf, sizeof buf - 1);
  if (n2 > 0) {
    buf[n2] = '\0';
    g_env_info.kv.push_back({"command", buf});
  }
  if (getcwd(buf, sizeof buf)) g_env_info.kv.push_back({"wdir", buf});
  if (gethostname(buf, sizeof buf) == 0)
    g_env_info.kv.push_back({"host", buf});
  g_env_info.kv.push_back(
      {"maxprocs", std::to_string(g.size > 0 ? g.size : 1)});
  const char *lvl = "MPI_THREAD_SINGLE";
  if (g_thread_level >= MPI_THREAD_MULTIPLE)
    lvl = "MPI_THREAD_MULTIPLE";
  else if (g_thread_level == MPI_THREAD_SERIALIZED)
    lvl = "MPI_THREAD_SERIALIZED";
  else if (g_thread_level == MPI_THREAD_FUNNELED)
    lvl = "MPI_THREAD_FUNNELED";
  g_env_info.kv.push_back({"thread_level", lvl});
}

void build_env_info_hook(void) { build_env_info(); }

static InfoObj *lookup_info(MPI_Info h) {
  if (h == MPI_INFO_ENV) return &g_env_info;
  auto it = g_infos.find(h);
  return it == g_infos.end() ? nullptr : &it->second;
}

// object-info snapshots (comm/win handle -> copy); files carry theirs
// in a side map too so FileObj's layout stays untouched
static std::map<int, InfoObj> g_comm_info, g_win_info, g_file_info;
// object names; comm defaults seeded lazily for WORLD/SELF
static std::map<int, std::string> g_comm_names, g_type_names, g_win_names;

static int next_info_handle() {
  int h = g_next_info++;
  if (h == MPI_INFO_ENV) h = g_next_info++;  // never alias the sentinel
  return h;
}

int MPI_Info_create(MPI_Info *info) {
  int h = next_info_handle();
  g_infos[h] = InfoObj{};
  *info = h;
  return MPI_SUCCESS;
}

int MPI_Info_free(MPI_Info *info) {
  if (info && *info == MPI_INFO_ENV) return MPI_ERR_INFO;  // predefined
  if (!info || !g_infos.erase(*info)) return MPI_ERR_INFO;
  *info = MPI_INFO_NULL;
  return MPI_SUCCESS;
}

int MPI_Info_dup(MPI_Info info, MPI_Info *newinfo) {
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  int h = next_info_handle();
  g_infos[h] = *o;
  *newinfo = h;
  return MPI_SUCCESS;
}

int MPI_Info_set(MPI_Info info, const char *key, const char *value) {
  if (info == MPI_INFO_ENV) return MPI_ERR_INFO;  // read-only
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  if (!key || !*key || strlen(key) > MPI_MAX_INFO_KEY)
    return MPI_ERR_INFO_KEY;
  if (!value || strlen(value) > MPI_MAX_INFO_VAL)
    return MPI_ERR_INFO_VALUE;
  for (auto &e : o->kv)
    if (e.first == key) {
      e.second = value;
      return MPI_SUCCESS;
    }
  o->kv.push_back({key, value});
  return MPI_SUCCESS;
}

int MPI_Info_delete(MPI_Info info, const char *key) {
  if (info == MPI_INFO_ENV) return MPI_ERR_INFO;  // read-only
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  for (auto it = o->kv.begin(); it != o->kv.end(); ++it)
    if (it->first == key) {
      o->kv.erase(it);
      return MPI_SUCCESS;
    }
  return MPI_ERR_INFO_NOKEY;
}

int MPI_Info_get(MPI_Info info, const char *key, int valuelen,
                 char *value, int *flag) {
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  const std::string *v = o->find(key);
  *flag = v ? 1 : 0;
  if (v) {
    size_t n = (size_t)valuelen < v->size() ? (size_t)valuelen
                                            : v->size();
    memcpy(value, v->data(), n);
    value[n] = '\0';
  }
  return MPI_SUCCESS;
}

int MPI_Info_get_nkeys(MPI_Info info, int *nkeys) {
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  *nkeys = (int)o->kv.size();
  return MPI_SUCCESS;
}

int MPI_Info_get_nthkey(MPI_Info info, int n, char *key) {
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  if (n < 0 || n >= (int)o->kv.size()) return MPI_ERR_ARG;
  snprintf(key, MPI_MAX_INFO_KEY + 1, "%s", o->kv[n].first.c_str());
  return MPI_SUCCESS;
}

int MPI_Info_get_valuelen(MPI_Info info, const char *key, int *valuelen,
                          int *flag) {
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  const std::string *v = o->find(key);
  *flag = v ? 1 : 0;
  if (v) *valuelen = (int)v->size();
  return MPI_SUCCESS;
}

namespace {

// set_info snapshots (an INFO_NULL set clears); get_info returns a
// fresh handle the caller frees
int object_set_info(std::map<int, InfoObj> &table, int handle,
                    MPI_Info info) {
  if (info == MPI_INFO_NULL) {
    table.erase(handle);
    return MPI_SUCCESS;
  }
  InfoObj *o = lookup_info(info);
  if (!o) return MPI_ERR_INFO;
  table[handle] = *o;
  return MPI_SUCCESS;
}

int object_get_info(std::map<int, InfoObj> &table, int handle,
                    MPI_Info *info_used) {
  int h = next_info_handle();
  auto it = table.find(handle);
  g_infos[h] = it == table.end() ? InfoObj{} : it->second;
  *info_used = h;
  return MPI_SUCCESS;
}

int object_set_name(std::map<int, std::string> &table, int handle,
                    const char *name) {
  table[handle] = name ? name : "";
  return MPI_SUCCESS;
}

int object_get_name(const std::map<int, std::string> &table, int handle,
                    const std::string &fallback, char *name,
                    int *resultlen) {
  auto it = table.find(handle);
  const std::string &s = it == table.end() ? fallback : it->second;
  snprintf(name, MPI_MAX_OBJECT_NAME, "%s", s.c_str());
  *resultlen = (int)strlen(name);
  return MPI_SUCCESS;
}

const char *predefined_type_name(MPI_Datatype dt) {
  switch (dt) {
    case MPI_BYTE:           return "MPI_BYTE";
    case MPI_INT:            return "MPI_INT";
    case MPI_LONG:           return "MPI_LONG";
    case MPI_FLOAT:          return "MPI_FLOAT";
    case MPI_DOUBLE:         return "MPI_DOUBLE";
    case MPI_CHAR:           return "MPI_CHAR";
    case MPI_SIGNED_CHAR:    return "MPI_SIGNED_CHAR";
    case MPI_SHORT:          return "MPI_SHORT";
    case MPI_LONG_LONG:      return "MPI_LONG_LONG";
    case MPI_UNSIGNED_CHAR:  return "MPI_UNSIGNED_CHAR";
    case MPI_UNSIGNED_SHORT: return "MPI_UNSIGNED_SHORT";
    case MPI_UNSIGNED:       return "MPI_UNSIGNED";
    case MPI_UNSIGNED_LONG:  return "MPI_UNSIGNED_LONG";
    case MPI_2INT:           return "MPI_2INT";
    case MPI_FLOAT_INT:      return "MPI_FLOAT_INT";
    case MPI_DOUBLE_INT:     return "MPI_DOUBLE_INT";
    case MPI_LONG_INT:       return "MPI_LONG_INT";
    case MPI_SHORT_INT:      return "MPI_SHORT_INT";
  }
  return "";
}

}  // namespace

int MPI_Comm_set_name(MPI_Comm comm, const char *name) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  return object_set_name(g_comm_names, comm, name);
}

int MPI_Comm_get_name(MPI_Comm comm, char *name, int *resultlen) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  std::string fallback;
  if (comm == MPI_COMM_WORLD) fallback = "MPI_COMM_WORLD";
  else if (comm == MPI_COMM_SELF) fallback = "MPI_COMM_SELF";
  return object_get_name(g_comm_names, comm, fallback, name, resultlen);
}

int MPI_Type_set_name(MPI_Datatype dt, const char *name) {
  if (dt >= DERIVED_BASE && !g_dtypes.count(dt)) return MPI_ERR_TYPE;
  DtInfo di;
  if (dt < DERIVED_BASE && !base_dtinfo(dt, di)) return MPI_ERR_TYPE;
  return object_set_name(g_type_names, dt, name);
}

int MPI_Type_get_name(MPI_Datatype dt, char *name, int *resultlen) {
  if (dt >= DERIVED_BASE && !g_dtypes.count(dt)) return MPI_ERR_TYPE;
  DtInfo di;
  if (dt < DERIVED_BASE && !base_dtinfo(dt, di)) return MPI_ERR_TYPE;
  return object_get_name(g_type_names, dt, predefined_type_name(dt),
                         name, resultlen);
}

int MPI_Win_set_name(MPI_Win win, const char *name) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  return object_set_name(g_win_names, win, name);
}

int MPI_Win_get_name(MPI_Win win, char *name, int *resultlen) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  return object_get_name(g_win_names, win, "", name, resultlen);
}

int MPI_Comm_set_info(MPI_Comm comm, MPI_Info info) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  return object_set_info(g_comm_info, comm, info);
}

int MPI_Comm_get_info(MPI_Comm comm, MPI_Info *info_used) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  return object_get_info(g_comm_info, comm, info_used);
}

int MPI_Win_set_info(MPI_Win win, MPI_Info info) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  return object_set_info(g_win_info, win, info);
}

int MPI_Win_get_info(MPI_Win win, MPI_Info *info_used) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  return object_get_info(g_win_info, win, info_used);
}

int MPI_File_set_info(MPI_File fh, MPI_Info info) {
  if (!g_files.count(fh)) return MPI_ERR_FILE;
  return object_set_info(g_file_info, fh, info);
}

int MPI_File_get_info(MPI_File fh, MPI_Info *info_used) {
  if (!g_files.count(fh)) return MPI_ERR_FILE;
  return object_get_info(g_file_info, fh, info_used);
}

int MPI_File_get_amode(MPI_File fh, int *amode) {
  auto it = g_files.find(fh);
  if (it == g_files.end()) return MPI_ERR_FILE;
  *amode = it->second.amode;
  return MPI_SUCCESS;
}

int MPI_File_get_group(MPI_File fh, MPI_Group *group) {
  auto it = g_files.find(fh);
  if (it == g_files.end()) return MPI_ERR_FILE;
  CommObj *c = lookup_comm(it->second.comm);
  if (!c) return MPI_ERR_COMM;
  *group = register_group(c->group);
  return MPI_SUCCESS;
}

// ------------------------------------ communicator tier 2 (round 5)

int MPI_Comm_split_type(MPI_Comm comm, int split_type, int key,
                        MPI_Info, MPI_Comm *newcomm) {
  // comm_split_type.c: SHARED groups ranks that can share memory —
  // here, ranks whose modex business card names the same host.  The
  // color is the lowest parent rank on my host, so same-host members
  // agree and distinct hosts never collide.
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (split_type != MPI_COMM_TYPE_SHARED && split_type != MPI_UNDEFINED)
    return MPI_ERR_ARG;
  // MPI-3.1 §6.4.2: UNDEFINED ranks still participate in the
  // collective — they enter the allgather with a sentinel card (hosts
  // never start with '\1') so no SHARED rank can match them, then
  // split with MPI_UNDEFINED
  int n = (int)c->group.size();
  char mine[64] = {0};
  if (split_type == MPI_UNDEFINED)
    snprintf(mine, sizeof mine, "\1%d", c->local_rank);
  else
    snprintf(mine, sizeof mine, "%s",
             g.book[c->group[c->local_rank]].first.c_str());
  std::vector<char> all((size_t)n * 64);
  int rc = c_allgather(*c, mine, 64, MPI_BYTE, all.data(), 64, MPI_BYTE);
  if (rc != MPI_SUCCESS) return rc;
  int color = MPI_UNDEFINED;
  if (split_type == MPI_COMM_TYPE_SHARED)
    for (int r = 0; r < n; r++)
      if (strncmp(all.data() + (size_t)r * 64, mine, 64) == 0) {
        color = r;  // lowest parent rank sharing my host
        break;
      }
  return MPI_Comm_split(comm, color, key, newcomm);
}

// Per-(group,tag) creation sequence: members of repeated
// Comm_create_group calls with the same signature advance identically
// (mismatched sequences are erroneous usage), so the derived cids
// agree without any wire traffic — the deterministic-cid contract.
static std::map<std::pair<uint64_t, int>, uint64_t> g_ccg_seq;

int MPI_Comm_create_group(MPI_Comm comm, MPI_Group group, int tag,
                          MPI_Comm *newcomm) {
  // comm_create_group.c: collective over the GROUP only — non-members
  // do not call.  No parent-wide traffic: cids derive from (member
  // world ranks, tag, per-signature sequence).
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  GroupObj *gr = lookup_group(group);
  if (group == MPI_GROUP_EMPTY || (gr && gr->ranks.empty())) {
    *newcomm = MPI_COMM_NULL;
    return MPI_SUCCESS;
  }
  if (!gr) return MPI_ERR_GROUP;
  int my_world = c->group[c->local_rank];
  int my_idx = -1;
  for (size_t i = 0; i < gr->ranks.size(); i++)
    if (gr->ranks[i] == my_world) my_idx = (int)i;
  if (my_idx < 0) {
    *newcomm = MPI_COMM_NULL;
    return MPI_SUCCESS;
  }
  uint64_t h = 0x9E3779B97F4A7C15ULL;
  for (int r : gr->ranks) h = mix64(h ^ (uint64_t)(uint32_t)r);
  uint64_t seq = g_ccg_seq[{h, tag}]++;
  CommObj child;
  uint64_t base = mix64(h ^ mix64((uint64_t)(uint32_t)tag) ^
                        (seq * 0x100000001B3ULL) ^ 0xCC6ULL);
  base = (base & 0x3FFFFFFFFFFFULL) | 0x10000ULL;
  child.cid_pt2pt = (int64_t)base;
  child.cid_coll = (int64_t)base + 1;
  child.cid_bar = (int64_t)base + 2;
  child.group = gr->ranks;
  child.local_rank = my_idx;
  int handle = g_next_comm++;
  g_comms[handle] = child;
  *newcomm = handle;
  return MPI_SUCCESS;
}

int MPI_Comm_dup_with_info(MPI_Comm comm, MPI_Info info,
                           MPI_Comm *newcomm) {
  int rc = MPI_Comm_dup(comm, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  return MPI_Comm_set_info(*newcomm, info);
}

int MPI_Comm_idup(MPI_Comm comm, MPI_Comm *newcomm,
                  MPI_Request *request) {
  // comm_idup.c; dup is wire-free here (deterministic cids), so the
  // request is born complete
  int rc = MPI_Comm_dup(comm, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(comm);
  return MPI_SUCCESS;
}

int MPI_Comm_remote_group(MPI_Comm comm, MPI_Group *group) {
  CommObj *c = lookup_comm(comm);
  if (!c) return MPI_ERR_COMM;
  if (c->remote.empty()) return MPI_ERR_COMM;  // intracommunicator
  *group = register_group(c->remote);
  return MPI_SUCCESS;
}

// Finalize sweep for this section's state (called from MPI_Finalize)
void clear_info_naming_state(void) {
  g_infos.clear();
  g_next_info = 1;
  g_comm_info.clear();
  g_win_info.clear();
  g_file_info.clear();
  g_comm_names.clear();
  g_type_names.clear();
  g_win_names.clear();
  g_ccg_seq.clear();
}

// ------------------------------------------- error handlers (round 5)

int dispatch_comm_err(int comm, int code) {
  if (code == MPI_SUCCESS) return code;
  int eh = errh_of_comm(comm);
  if (eh == MPI_ERRORS_RETURN) return code;
  if (eh == MPI_ERRORS_ARE_FATAL) {
    char msg[MPI_MAX_ERROR_STRING];
    int len;
    MPI_Error_string(code, msg, &len);
    fprintf(stderr,
            "zompi: MPI_ERRORS_ARE_FATAL on comm %d: %s — aborting\n",
            comm, msg);
    _exit(code > 0 && code < 256 ? code : 1);
  }
  auto it = g_errhandlers.find(eh);
  if (it != g_errhandlers.end() && it->second.kind == 0 &&
      it->second.fn) {
    MPI_Comm c2 = comm;
    ((MPI_Comm_errhandler_function *)it->second.fn)(&c2, &code);
  }
  return code;
}

int MPI_Comm_create_errhandler(MPI_Comm_errhandler_function *fn,
                               MPI_Errhandler *errhandler) {
  int h = g_next_errh++;
  g_errhandlers[h] = {0, (void *)fn};
  *errhandler = h;
  return MPI_SUCCESS;
}

int MPI_Comm_set_errhandler(MPI_Comm comm, MPI_Errhandler errhandler) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  if (!valid_errh(errhandler, 0)) return MPI_ERR_ARG;
  release_errh_ref(g_comm_errh, comm);
  g_comm_errh[comm] = errhandler;
  return MPI_SUCCESS;
}

int MPI_Comm_get_errhandler(MPI_Comm comm, MPI_Errhandler *errhandler) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  *errhandler = errh_of_comm(comm);
  return MPI_SUCCESS;
}

int MPI_Comm_call_errhandler(MPI_Comm comm, int errorcode) {
  if (!lookup_comm(comm)) return MPI_ERR_COMM;
  dispatch_comm_err(comm, errorcode);
  return MPI_SUCCESS;
}

int MPI_Win_create_errhandler(MPI_Win_errhandler_function *fn,
                              MPI_Errhandler *errhandler) {
  int h = g_next_errh++;
  g_errhandlers[h] = {1, (void *)fn};
  *errhandler = h;
  return MPI_SUCCESS;
}

int MPI_Win_set_errhandler(MPI_Win win, MPI_Errhandler errhandler) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  if (!valid_errh(errhandler, 1)) return MPI_ERR_ARG;
  release_errh_ref(g_win_errh, win);
  g_win_errh[win] = errhandler;
  return MPI_SUCCESS;
}

int MPI_Win_get_errhandler(MPI_Win win, MPI_Errhandler *errhandler) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  auto it = g_win_errh.find(win);
  *errhandler = it != g_win_errh.end() ? it->second
                                       : MPI_ERRORS_ARE_FATAL;
  return MPI_SUCCESS;
}

int MPI_Win_call_errhandler(MPI_Win win, int errorcode) {
  if (!g_win_handles.count(win)) return MPI_ERR_WIN;
  auto it = g_win_errh.find(win);
  int eh = it != g_win_errh.end() ? it->second : MPI_ERRORS_ARE_FATAL;
  if (eh == MPI_ERRORS_RETURN) return MPI_SUCCESS;
  if (eh == MPI_ERRORS_ARE_FATAL) {
    fprintf(stderr, "zompi: MPI_ERRORS_ARE_FATAL on win %d: %d\n", win,
            errorcode);
    _exit(errorcode > 0 && errorcode < 256 ? errorcode : 1);
  }
  auto uh = g_errhandlers.find(eh);
  if (uh != g_errhandlers.end() && uh->second.kind == 1 &&
      uh->second.fn) {
    MPI_Win w2 = win;
    ((MPI_Win_errhandler_function *)uh->second.fn)(&w2, &errorcode);
  }
  return MPI_SUCCESS;
}

int MPI_File_create_errhandler(MPI_File_errhandler_function *fn,
                               MPI_Errhandler *errhandler) {
  int h = g_next_errh++;
  g_errhandlers[h] = {2, (void *)fn};
  *errhandler = h;
  return MPI_SUCCESS;
}

int MPI_File_set_errhandler(MPI_File file, MPI_Errhandler errhandler) {
  if (!g_files.count(file)) return MPI_ERR_FILE;
  if (!valid_errh(errhandler, 2)) return MPI_ERR_ARG;
  release_errh_ref(g_file_errh, file);
  g_file_errh[file] = errhandler;
  return MPI_SUCCESS;
}

int MPI_File_get_errhandler(MPI_File file, MPI_Errhandler *errhandler) {
  if (!g_files.count(file)) return MPI_ERR_FILE;
  auto it = g_file_errh.find(file);
  // files default to ERRORS_RETURN (MPI-3.1 §13.7)
  *errhandler = it != g_file_errh.end() ? it->second
                                        : MPI_ERRORS_RETURN;
  return MPI_SUCCESS;
}

int MPI_File_call_errhandler(MPI_File file, int errorcode) {
  if (!g_files.count(file)) return MPI_ERR_FILE;
  auto it = g_file_errh.find(file);
  int eh = it != g_file_errh.end() ? it->second : MPI_ERRORS_RETURN;
  if (eh == MPI_ERRORS_RETURN) return MPI_SUCCESS;
  if (eh == MPI_ERRORS_ARE_FATAL) {
    fprintf(stderr, "zompi: MPI_ERRORS_ARE_FATAL on file %d: %d\n",
            file, errorcode);
    _exit(errorcode > 0 && errorcode < 256 ? errorcode : 1);
  }
  auto uh = g_errhandlers.find(eh);
  if (uh != g_errhandlers.end() && uh->second.kind == 2 &&
      uh->second.fn) {
    MPI_File f2 = file;
    ((MPI_File_errhandler_function *)uh->second.fn)(&f2, &errorcode);
  }
  return MPI_SUCCESS;
}

int MPI_Errhandler_free(MPI_Errhandler *errhandler) {
  if (!errhandler) return MPI_ERR_ARG;
  if (*errhandler >= 0x10) {
    auto it = g_errhandlers.find(*errhandler);
    if (it == g_errhandlers.end()) return MPI_ERR_ARG;
    // stays in effect until the last referencing object detaches
    it->second.freed = true;
    reap_errh(*errhandler);
  }
  *errhandler = MPI_ERRHANDLER_NULL;
  return MPI_SUCCESS;
}

int MPI_Errhandler_create(MPI_Handler_function *fn,
                          MPI_Errhandler *errhandler) {
  return MPI_Comm_create_errhandler(fn, errhandler);
}

int MPI_Errhandler_set(MPI_Comm comm, MPI_Errhandler errhandler) {
  return MPI_Comm_set_errhandler(comm, errhandler);
}

int MPI_Errhandler_get(MPI_Comm comm, MPI_Errhandler *errhandler) {
  return MPI_Comm_get_errhandler(comm, errhandler);
}

MPI_Fint MPI_Errhandler_c2f(MPI_Errhandler errhandler) {
  return (MPI_Fint)errhandler;
}
MPI_Errhandler MPI_Errhandler_f2c(MPI_Fint errhandler) {
  return (MPI_Errhandler)errhandler;
}

// -------------------------------------- batch-8 surface (round 5)
// group_range_incl.c, attr_put.c (MPI-1 names), type_create_keyval.c,
// rput.c, pack_external.c, type_match_size.c, grequest_start.c.

int MPI_Group_compare(MPI_Group group1, MPI_Group group2, int *result) {
  const std::vector<int> *a = group_ranks(group1);
  const std::vector<int> *b = group_ranks(group2);
  if (!a || !b) return MPI_ERR_GROUP;
  if (*a == *b) {
    *result = MPI_IDENT;
    return MPI_SUCCESS;
  }
  std::vector<int> sa(*a), sb(*b);
  std::sort(sa.begin(), sa.end());
  std::sort(sb.begin(), sb.end());
  *result = sa == sb ? MPI_SIMILAR : MPI_UNEQUAL;
  return MPI_SUCCESS;
}

namespace {

// expand (first,last,stride) triplets into group ranks
// (group_range_incl.c's triplet semantics; negative strides walk down)
int expand_ranges(const std::vector<int> &src, int n, int ranges[][3],
                  std::vector<int> &out) {
  for (int i = 0; i < n; i++) {
    int first = ranges[i][0], last = ranges[i][1], stride = ranges[i][2];
    if (stride == 0) return MPI_ERR_ARG;
    if (stride > 0 ? first > last : first < last) return MPI_ERR_ARG;
    for (int r = first; stride > 0 ? r <= last : r >= last;
         r += stride) {
      if (r < 0 || r >= (int)src.size()) return MPI_ERR_ARG;
      out.push_back(r);
    }
  }
  return MPI_SUCCESS;
}

}  // namespace

int MPI_Group_range_incl(MPI_Group group, int n, int ranges[][3],
                         MPI_Group *newgroup) {
  const std::vector<int> *src = group_ranks(group);
  if (!src) return MPI_ERR_GROUP;
  std::vector<int> picks;
  int rc = expand_ranges(*src, n, ranges, picks);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<int> ranks;
  for (int r : picks) ranks.push_back((*src)[(size_t)r]);
  *newgroup = ranks.empty() ? MPI_GROUP_EMPTY : register_group(ranks);
  return MPI_SUCCESS;
}

int MPI_Group_range_excl(MPI_Group group, int n, int ranges[][3],
                         MPI_Group *newgroup) {
  const std::vector<int> *src = group_ranks(group);
  if (!src) return MPI_ERR_GROUP;
  std::vector<int> picks;
  int rc = expand_ranges(*src, n, ranges, picks);
  if (rc != MPI_SUCCESS) return rc;
  std::vector<bool> drop(src->size(), false);
  for (int r : picks) drop[(size_t)r] = true;
  std::vector<int> ranks;
  for (size_t i = 0; i < src->size(); i++)
    if (!drop[i]) ranks.push_back((*src)[i]);
  *newgroup = ranks.empty() ? MPI_GROUP_EMPTY : register_group(ranks);
  return MPI_SUCCESS;
}

// MPI-1 attribute names: straight aliases of the comm attribute engine
int MPI_Keyval_create(MPI_Copy_function *copy_fn,
                      MPI_Delete_function *delete_fn, int *keyval,
                      void *extra_state) {
  return MPI_Comm_create_keyval(copy_fn, delete_fn, keyval, extra_state);
}
int MPI_Keyval_free(int *keyval) { return MPI_Comm_free_keyval(keyval); }
int MPI_Attr_put(MPI_Comm comm, int keyval, void *attribute_val) {
  return MPI_Comm_set_attr(comm, keyval, attribute_val);
}
int MPI_Attr_get(MPI_Comm comm, int keyval, void *attribute_val,
                 int *flag) {
  return MPI_Comm_get_attr(comm, keyval, attribute_val, flag);
}
int MPI_Attr_delete(MPI_Comm comm, int keyval) {
  return MPI_Comm_delete_attr(comm, keyval);
}

// datatype attribute caching: the comm keyval machinery instantiated
// for datatypes (as with windows)
struct TypeKeyvalObj {
  MPI_Type_copy_attr_function *copy_fn;
  MPI_Type_delete_attr_function *delete_fn;
  void *extra_state;
  bool freed = false;
};
static std::map<int, TypeKeyvalObj> g_type_keyvals;
static int g_next_type_keyval = 0;
static std::map<std::pair<int, int>, void *> g_type_attrs;

void reap_type_keyval(int keyval) {
  auto kv = g_type_keyvals.find(keyval);
  if (kv == g_type_keyvals.end() || !kv->second.freed) return;
  for (auto &e : g_type_attrs)
    if (e.first.second == keyval) return;
  g_type_keyvals.erase(kv);  // deferred free completes here
}

void delete_type_attrs(MPI_Datatype dt) {
  for (auto it = g_type_attrs.begin(); it != g_type_attrs.end();) {
    if (it->first.first == dt) {
      int kvid = it->first.second;
      auto kv = g_type_keyvals.find(kvid);
      if (kv != g_type_keyvals.end() && kv->second.delete_fn)
        kv->second.delete_fn(dt, kvid, it->second,
                             kv->second.extra_state);
      it = g_type_attrs.erase(it);
      reap_type_keyval(kvid);
    } else {
      ++it;
    }
  }
}

int MPI_Type_create_keyval(MPI_Type_copy_attr_function *copy_fn,
                           MPI_Type_delete_attr_function *delete_fn,
                           int *keyval, void *extra_state) {
  if (!keyval) return MPI_ERR_ARG;
  int kv = g_next_type_keyval++;
  g_type_keyvals[kv] = {copy_fn, delete_fn, extra_state};
  *keyval = kv;
  return MPI_SUCCESS;
}

int MPI_Type_free_keyval(int *keyval) {
  if (!keyval) return MPI_ERR_ARG;
  auto it = g_type_keyvals.find(*keyval);
  if (it == g_type_keyvals.end()) return MPI_ERR_ARG;
  it->second.freed = true;
  bool referenced = false;
  for (auto &e : g_type_attrs)
    if (e.first.second == *keyval) referenced = true;
  if (!referenced) g_type_keyvals.erase(it);
  *keyval = MPI_KEYVAL_INVALID;
  return MPI_SUCCESS;
}

int MPI_Type_set_attr(MPI_Datatype dt, int keyval, void *attribute_val) {
  if (dt >= DERIVED_BASE && !g_dtypes.count(dt)) return MPI_ERR_TYPE;
  auto kv = g_type_keyvals.find(keyval);
  if (kv == g_type_keyvals.end() || kv->second.freed)
    return MPI_ERR_ARG;
  auto it = g_type_attrs.find({dt, keyval});
  if (it != g_type_attrs.end() && kv->second.delete_fn)
    kv->second.delete_fn(dt, keyval, it->second, kv->second.extra_state);
  g_type_attrs[{dt, keyval}] = attribute_val;
  return MPI_SUCCESS;
}

int MPI_Type_get_attr(MPI_Datatype dt, int keyval, void *attribute_val,
                      int *flag) {
  if (dt >= DERIVED_BASE && !g_dtypes.count(dt)) return MPI_ERR_TYPE;
  auto it = g_type_attrs.find({dt, keyval});
  *flag = it != g_type_attrs.end() ? 1 : 0;
  if (*flag) *(void **)attribute_val = it->second;
  return MPI_SUCCESS;
}

int MPI_Type_delete_attr(MPI_Datatype dt, int keyval) {
  if (dt >= DERIVED_BASE && !g_dtypes.count(dt)) return MPI_ERR_TYPE;
  auto it = g_type_attrs.find({dt, keyval});
  if (it == g_type_attrs.end()) return MPI_ERR_ARG;
  auto kv = g_type_keyvals.find(keyval);
  if (kv != g_type_keyvals.end() && kv->second.delete_fn)
    kv->second.delete_fn(dt, keyval, it->second, kv->second.extra_state);
  g_type_attrs.erase(it);
  reap_type_keyval(keyval);
  return MPI_SUCCESS;
}

// size-matched types (type_match_size.c)
int MPI_Type_match_size(int typeclass, int size, MPI_Datatype *dt) {
  if (typeclass == MPI_TYPECLASS_INTEGER) {
    switch (size) {
      case 1: *dt = MPI_SIGNED_CHAR; return MPI_SUCCESS;
      case 2: *dt = MPI_SHORT; return MPI_SUCCESS;
      case 4: *dt = MPI_INT; return MPI_SUCCESS;
      case 8: *dt = MPI_LONG_LONG; return MPI_SUCCESS;
    }
  } else if (typeclass == MPI_TYPECLASS_REAL) {
    switch (size) {
      case 4: *dt = MPI_FLOAT; return MPI_SUCCESS;
      case 8: *dt = MPI_DOUBLE; return MPI_SUCCESS;
    }
  } else if (typeclass == MPI_TYPECLASS_COMPLEX) {
    // complex = contiguous (re, im) pair; match_size returns a
    // REFERENCE the caller never frees, so the handle is built once
    // per size and cached for the process lifetime
    static MPI_Datatype cached8 = MPI_DATATYPE_NULL;
    static MPI_Datatype cached16 = MPI_DATATYPE_NULL;
    MPI_Datatype *slot;
    MPI_Datatype base;
    if (size == 8) { slot = &cached8; base = MPI_FLOAT; }
    else if (size == 16) { slot = &cached16; base = MPI_DOUBLE; }
    else return MPI_ERR_ARG;
    if (*slot == MPI_DATATYPE_NULL || !g_dtypes.count(*slot)) {
      int rc = MPI_Type_contiguous(2, base, slot);
      if (rc != MPI_SUCCESS) return rc;
      rc = MPI_Type_commit(slot);
      if (rc != MPI_SUCCESS) return rc;
    }
    *dt = *slot;
    return MPI_SUCCESS;
  }
  return MPI_ERR_ARG;
}

// Fortran-parameterized types (type_create_f90_*.c): precision/range
// select the narrowest hosting native type
int MPI_Type_create_f90_integer(int range, MPI_Datatype *newtype) {
  if (range <= 2) *newtype = MPI_SIGNED_CHAR;
  else if (range <= 4) *newtype = MPI_SHORT;
  else if (range <= 9) *newtype = MPI_INT;
  else if (range <= 18) *newtype = MPI_LONG_LONG;
  else return MPI_ERR_ARG;
  return MPI_SUCCESS;
}

int MPI_Type_create_f90_real(int precision, int range,
                             MPI_Datatype *newtype) {
  if (precision <= 6 && range <= 37) *newtype = MPI_FLOAT;
  else if (precision <= 15 && range <= 307) *newtype = MPI_DOUBLE;
  else return MPI_ERR_ARG;
  return MPI_SUCCESS;
}

int MPI_Type_create_f90_complex(int precision, int range,
                                MPI_Datatype *newtype) {
  MPI_Datatype base;
  int rc = MPI_Type_create_f90_real(precision, range, &base);
  if (rc != MPI_SUCCESS) return rc;
  rc = MPI_Type_contiguous(2, base, newtype);
  if (rc != MPI_SUCCESS) return rc;
  DtypeObj &d = g_dtypes[*newtype];
  d.combiner = MPI_COMBINER_F90_COMPLEX;
  d.env_ints = {precision, range};
  d.env_types.clear();
  return MPI_Type_commit(newtype);
}

// canonical packing (pack_external.c): big-endian canonical base
// elements with native sizes (64-bit longs — documented divergence)
namespace {

bool little_endian() {
  const uint16_t probe = 1;
  return *(const uint8_t *)&probe == 1;
}

void swap_elems(char *buf, size_t nbytes, size_t item) {
  if (item <= 1 || !little_endian()) return;
  for (size_t at = 0; at + item <= nbytes; at += item)
    for (size_t i = 0; i < item / 2; i++)
      std::swap(buf[at + i], buf[at + item - 1 - i]);
}

}  // namespace

// canonical element unit of a type's PACKED stream: predefined =
// item size; byte-sealed derived = the recorded constructor unit
// (0 = heterogeneous struct, not canonically packable)
static int packed_unit(const DtView &v, MPI_Datatype dt) {
  return packed_unit_of(v.derived, dt, v.di.item);
}

int MPI_Pack_external(const char datarep[], const void *inbuf,
                      int incount, MPI_Datatype datatype, void *outbuf,
                      MPI_Aint outsize, MPI_Aint *position) {
  if (!datarep || strcmp(datarep, "external32") != 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(datatype, v)) return MPI_ERR_TYPE;
  int unit = packed_unit(v, datatype);
  // unit 0 = no canonical element order: mixed-field structs and pair
  // records, directly or through ANY derived construction — reject,
  // never half-swap
  if (unit == 0) return MPI_ERR_TYPE;
  std::vector<char> packed;
  pack_dtype(inbuf, incount, v, packed);
  swap_elems(packed.data(), packed.size(), (size_t)unit);
  if (*position + (MPI_Aint)packed.size() > outsize)
    return MPI_ERR_TRUNCATE;
  memcpy((char *)outbuf + *position, packed.data(), packed.size());
  *position += (MPI_Aint)packed.size();
  return MPI_SUCCESS;
}

int MPI_Unpack_external(const char datarep[], const void *inbuf,
                        MPI_Aint insize, MPI_Aint *position,
                        void *outbuf, int outcount,
                        MPI_Datatype datatype) {
  if (!datarep || strcmp(datarep, "external32") != 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(datatype, v)) return MPI_ERR_TYPE;
  int unit = packed_unit(v, datatype);
  if (unit == 0) return MPI_ERR_TYPE;  // see Pack_external
  size_t want = (size_t)outcount * v.elems_per_item() * v.di.item;
  if (*position + (MPI_Aint)want > insize) return MPI_ERR_TRUNCATE;
  std::vector<char> tmp((const char *)inbuf + *position,
                        (const char *)inbuf + *position + want);
  swap_elems(tmp.data(), tmp.size(), (size_t)unit);
  unpack_dtype(outbuf, outcount, v, tmp.data(), tmp.size());
  *position += (MPI_Aint)want;
  return MPI_SUCCESS;
}

int MPI_Pack_external_size(const char datarep[], int incount,
                           MPI_Datatype datatype, MPI_Aint *size) {
  if (!datarep || strcmp(datarep, "external32") != 0) return MPI_ERR_ARG;
  DtView v;
  if (!resolve_dtype(datatype, v)) return MPI_ERR_TYPE;
  if (packed_unit(v, datatype) == 0)
    return MPI_ERR_TYPE;  // consistent with Pack_external's rejection
  *size = (MPI_Aint)((int64_t)incount * v.elems_per_item() *
                     (int64_t)v.di.item);
  return MPI_SUCCESS;
}

// generalized requests (grequest_start.c): the engine's Req with
// user-driven completion.  query_fn fills the status at completion,
// free_fn runs right after (this engine has no free hook in the
// retire path; complete -> wait is the ordering that matters).
struct GrequestState {
  MPI_Grequest_query_function *query_fn;
  MPI_Grequest_free_function *free_fn;
  MPI_Grequest_cancel_function *cancel_fn;
  void *extra_state;
};
// guarded by g.match_mu: Grequest_complete is DESIGNED to run on a
// user progress thread concurrent with the main thread's engine calls
static std::map<int, GrequestState> g_grequests;

int MPI_Grequest_start(MPI_Grequest_query_function *query_fn,
                       MPI_Grequest_free_function *free_fn,
                       MPI_Grequest_cancel_function *cancel_fn,
                       void *extra_state, MPI_Request *request) {
  Req *r = new Req;
  r->heap = true;
  r->comm = MPI_COMM_WORLD;
  int handle;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    handle = g.next_req++;
    g.reqs[handle] = r;
    g_grequests[handle] = {query_fn, free_fn, cancel_fn, extra_state};
  }
  *request = handle;
  return MPI_SUCCESS;
}

int MPI_Grequest_complete(MPI_Request request) {
  GrequestState st;
  Req *r;
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    auto git = g_grequests.find(request);
    if (git == g_grequests.end()) return MPI_ERR_REQUEST;
    st = git->second;
    auto it = g.reqs.find(request);
    if (it == g.reqs.end()) return MPI_ERR_REQUEST;
    r = it->second;
  }
  MPI_Status status{};
  status.MPI_SOURCE = MPI_ANY_SOURCE;
  status.MPI_TAG = MPI_ANY_TAG;
  if (st.query_fn) st.query_fn(st.extra_state, &status);
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    r->status = status;
    r->complete = true;
    g.match_cv.notify_all();
  }
  if (st.free_fn) st.free_fn(st.extra_state);
  {
    std::lock_guard<std::mutex> lk(g.match_mu);
    g_grequests.erase(request);
  }
  return MPI_SUCCESS;
}

// request-based RMA (rput.c family): every origin-side operation here
// packs its payload at call time (local completion is immediate), so
// the request is born complete — remote completion is the epoch's
// flush/unlock/fence, exactly as for the non-request forms
int MPI_Rput(const void *origin_addr, int origin_count,
             MPI_Datatype origin_datatype, int target_rank,
             MPI_Aint target_disp, int target_count,
             MPI_Datatype target_datatype, MPI_Win win,
             MPI_Request *request) {
  int rc = MPI_Put(origin_addr, origin_count, origin_datatype,
                   target_rank, target_disp, target_count,
                   target_datatype, win);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(MPI_COMM_WORLD);
  return MPI_SUCCESS;
}

int MPI_Rget(void *origin_addr, int origin_count,
             MPI_Datatype origin_datatype, int target_rank,
             MPI_Aint target_disp, int target_count,
             MPI_Datatype target_datatype, MPI_Win win,
             MPI_Request *request) {
  int rc = MPI_Get(origin_addr, origin_count, origin_datatype,
                   target_rank, target_disp, target_count,
                   target_datatype, win);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(MPI_COMM_WORLD);
  return MPI_SUCCESS;
}

int MPI_Raccumulate(const void *origin_addr, int origin_count,
                    MPI_Datatype origin_datatype, int target_rank,
                    MPI_Aint target_disp, int target_count,
                    MPI_Datatype target_datatype, MPI_Op op, MPI_Win win,
                    MPI_Request *request) {
  int rc = MPI_Accumulate(origin_addr, origin_count, origin_datatype,
                          target_rank, target_disp, target_count,
                          target_datatype, op, win);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(MPI_COMM_WORLD);
  return MPI_SUCCESS;
}

int MPI_Rget_accumulate(const void *origin_addr, int origin_count,
                        MPI_Datatype origin_datatype, void *result_addr,
                        int result_count, MPI_Datatype result_datatype,
                        int target_rank, MPI_Aint target_disp,
                        int target_count, MPI_Datatype target_datatype,
                        MPI_Op op, MPI_Win win, MPI_Request *request) {
  int rc = MPI_Get_accumulate(origin_addr, origin_count,
                              origin_datatype, result_addr,
                              result_count, result_datatype,
                              target_rank, target_disp, target_count,
                              target_datatype, op, win);
  if (rc != MPI_SUCCESS) return rc;
  *request = make_completed_req(MPI_COMM_WORLD);
  return MPI_SUCCESS;
}

// ---------------------------- ports / join / naming (round 5)
// open_port.c / comm_accept.c / comm_connect.c / publish_name.c /
// comm_join.c: client/server connection establishment within one
// universe.  A port is a live listening socket named "host:tcpport";
// accept/connect roots exchange group lists + a seed over it and both
// sides derive the intercommunicator cids from the same hash — the
// deterministic-cid collapse again.  Publish/lookup speak the
// launcher's name-server protocol (tools/mpirun.py hosts it,
// ZMPI_NAMESERVER advertises it — the ompi-server analog).

static std::map<std::string, int> g_ports;  // port name -> listen fd

int MPI_Open_port(MPI_Info, char *port_name) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return MPI_ERR_OTHER;
  set_cloexec(fd);
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = 0;
  inet_pton(AF_INET, g.host.c_str(), &a.sin_addr);
  if (bind(fd, (sockaddr *)&a, sizeof a) != 0 || listen(fd, 8) != 0) {
    close(fd);
    return MPI_ERR_OTHER;
  }
  socklen_t alen = sizeof a;
  getsockname(fd, (sockaddr *)&a, &alen);
  snprintf(port_name, MPI_MAX_PORT_NAME, "%s:%d", g.host.c_str(),
           (int)ntohs(a.sin_port));
  g_ports[port_name] = fd;
  return MPI_SUCCESS;
}

int MPI_Close_port(const char *port_name) {
  auto it = g_ports.find(port_name ? port_name : "");
  if (it == g_ports.end()) return MPI_ERR_ARG;
  close(it->second);
  g_ports.erase(it);
  return MPI_SUCCESS;
}

namespace {

// serialize my comm's world-rank group + a seed into one DSS frame
std::string pack_group_frame(const CommObj &c, int64_t seed) {
  std::string f;
  put_varint(f, 2);
  put_int(f, seed);
  f.push_back((char)T_LIST);
  put_varint(f, c.group.size());
  for (int r : c.group) put_int(f, (int64_t)r);
  return f;
}

bool parse_group_frame(const std::string &f, int64_t &seed,
                       std::vector<int> &group) {
  std::vector<DssVal> vals;
  if (!parse_all(f, vals) || vals.size() != 2 ||
      vals[1].tag != T_LIST)
    return false;
  seed = vals[0].i;
  group.clear();
  for (auto &e : vals[1].items) group.push_back((int)e.i);
  return true;
}

// both sides build the identical intercomm from (mine, theirs, seed)
int build_port_intercomm(CommObj *c, const std::vector<int> &remote,
                         int64_t seed, MPI_Comm *newcomm) {
  CommObj inter;
  inter.group = c->group;
  inter.local_rank = c->local_rank;
  inter.remote = remote;
  intercomm_cids(c->group, remote, (int)(seed & 0x7FFFFFFF), inter);
  int handle = g_next_comm++;
  g_comms[handle] = inter;
  *newcomm = handle;
  return MPI_SUCCESS;
}

// distribute (seed, remote group) from the root and build — the tail
// both accept and connect share
int port_epilogue(CommObj *c, int root, int64_t hdr0_seed,
                  std::vector<int> &remote, MPI_Comm comm,
                  MPI_Comm *newcomm) {
  long hdr[2] = {(long)hdr0_seed, (long)remote.size()};
  int rc = c_bcast(*c, hdr, 2, MPI_LONG, root, 0x7E19);
  if (rc != MPI_SUCCESS) return rc;
  if (hdr[0] < 0) return MPI_ERR_OTHER;  // root failure, agreed
  remote.resize((size_t)hdr[1]);
  if (hdr[1] > 0) {
    rc = c_bcast(*c, remote.data(), (int)hdr[1], MPI_INT, root, 0x7E1A);
    if (rc != MPI_SUCCESS) return rc;
  }
  (void)comm;
  return build_port_intercomm(c, remote, hdr[0], newcomm);
}

}  // namespace

int MPI_Comm_accept(const char *port_name, MPI_Info, int root,
                    MPI_Comm comm, MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c || !c->remote.empty()) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  int64_t seed = -1;
  std::vector<int> remote;
  if (c->local_rank == root) {
    auto it = g_ports.find(port_name ? port_name : "");
    if (it != g_ports.end()) {
      int conn = accept(it->second, nullptr, nullptr);
      if (conn >= 0) {
        // the accept side mints the seed (its own counter guarantees
        // distinct cids across repeated accepts on one port)
        static std::atomic<int64_t> accept_seq{1};
        int64_t my_seed =
            (int64_t)(mix64((uint64_t)accept_seq.fetch_add(1) ^
                            ((uint64_t)g.rank << 32)) &
                      0x7FFFFFFF);
        std::string f;
        if (recv_frame(conn, f)) {
          int64_t ignored;
          if (parse_group_frame(f, ignored, remote) &&
              send_frame(conn, pack_group_frame(*c, my_seed)))
            seed = my_seed;
        }
        close(conn);
      }
    }
  }
  return port_epilogue(c, root, seed, remote, comm, newcomm);
}

int MPI_Comm_connect(const char *port_name, MPI_Info, int root,
                     MPI_Comm comm, MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c || !c->remote.empty()) return MPI_ERR_COMM;
  if (root < 0 || root >= (int)c->group.size()) return MPI_ERR_ARG;
  int64_t seed = -1;
  std::vector<int> remote;
  if (c->local_rank == root && port_name) {
    std::string pn = port_name;
    size_t colon = pn.rfind(':');
    if (colon != std::string::npos) {
      int conn = tcp_connect(pn.substr(0, colon),
                             atoi(pn.c_str() + colon + 1));
      if (conn >= 0) {
        // connector sends first, seed comes back from the acceptor
        if (send_frame(conn, pack_group_frame(*c, 0))) {
          std::string f;
          int64_t their_seed;
          if (recv_frame(conn, f) &&
              parse_group_frame(f, their_seed, remote))
            seed = their_seed;
        }
        close(conn);
      }
    }
  }
  return port_epilogue(c, root, seed, remote, comm, newcomm);
}

int MPI_Comm_disconnect(MPI_Comm *comm) {
  // comm_disconnect.c: collective; waits for pending comm traffic.
  // The engine completes sends at the API boundary, so the barrier IS
  // the quiescence point; then the handle dies like Comm_free.
  if (!comm || *comm == MPI_COMM_WORLD || *comm == MPI_COMM_SELF)
    return MPI_ERR_COMM;  // the Comm_free guard, same mistake class
  CommObj *c = lookup_comm(*comm);
  if (!c) return MPI_ERR_COMM;
  if (c->remote.empty()) c_barrier(*c);  // intracomm quiesce
  delete_comm_attrs(*comm);
  release_errh_ref(g_comm_errh, *comm);
  g_comms.erase(*comm);
  *comm = MPI_COMM_NULL;
  return MPI_SUCCESS;
}

int MPI_Comm_join(int fd, MPI_Comm *intercomm) {
  // comm_join.c scoped to one universe: the two processes exchange
  // (world rank, local seed) over the caller's socket; the shared
  // seed is the SUM so both sides compute it identically
  static std::atomic<int64_t> join_seq{1};
  int64_t my_seed = join_seq.fetch_add(1) + g.rank * 1000003LL;
  std::string out;
  put_varint(out, 2);
  put_int(out, (int64_t)g.rank);
  put_int(out, my_seed);
  if (!send_frame(fd, out)) return MPI_ERR_OTHER;
  std::string in;
  if (!recv_frame(fd, in)) return MPI_ERR_OTHER;
  std::vector<DssVal> vals;
  if (!parse_all(in, vals) || vals.size() != 2) return MPI_ERR_OTHER;
  int peer = (int)vals[0].i;
  int64_t seed = my_seed + vals[1].i;
  if (peer < 0 || peer >= (int)g.book.size() || peer == g.rank)
    return MPI_ERR_ARG;
  CommObj inter;
  inter.group = {g.rank};
  inter.local_rank = 0;
  inter.remote = {peer};
  intercomm_cids(inter.group, inter.remote,
                 (int)(seed & 0x7FFFFFFF), inter);
  int handle = g_next_comm++;
  g_comms[handle] = inter;
  *intercomm = handle;
  return MPI_SUCCESS;
}

namespace {

// one round-trip with the launcher-hosted name server; the request is
// ONE list value, the reply ONE value (mpirun.py's protocol)
int nameserver_rpc(const std::vector<std::string> &req, DssVal &reply) {
  const char *ns = getenv("ZMPI_NAMESERVER");
  if (!ns || !*ns) return MPI_ERR_OTHER;  // no ompi-server analog
  std::string addr = ns;
  size_t colon = addr.rfind(':');
  if (colon == std::string::npos) return MPI_ERR_OTHER;
  int fd = tcp_connect(addr.substr(0, colon),
                       atoi(addr.c_str() + colon + 1));
  if (fd < 0) return MPI_ERR_OTHER;
  std::string f;
  put_varint(f, 1);
  f.push_back((char)T_LIST);
  put_varint(f, req.size());
  for (auto &s2 : req) put_str(f, s2);
  std::string in;
  bool ok = send_frame(fd, f) && recv_frame(fd, in);
  close(fd);
  if (!ok) return MPI_ERR_OTHER;
  std::vector<DssVal> vals;
  if (!parse_all(in, vals) || vals.size() != 1) return MPI_ERR_OTHER;
  reply = vals[0];
  return MPI_SUCCESS;
}

}  // namespace

int MPI_Publish_name(const char *service_name, MPI_Info,
                     const char *port_name) {
  if (!service_name || !port_name) return MPI_ERR_ARG;
  DssVal reply;
  return nameserver_rpc({"pub", service_name, port_name}, reply);
}

int MPI_Lookup_name(const char *service_name, MPI_Info,
                    char *port_name) {
  if (!service_name || !port_name) return MPI_ERR_ARG;
  DssVal reply;
  int rc = nameserver_rpc({"look", service_name}, reply);
  if (rc != MPI_SUCCESS) return rc;
  if (reply.tag != T_STR) return MPI_ERR_ARG;  // unpublished service
  snprintf(port_name, MPI_MAX_PORT_NAME, "%s", reply.s.c_str());
  return MPI_SUCCESS;
}

int MPI_Unpublish_name(const char *service_name, MPI_Info,
                       const char *port_name) {
  (void)port_name;
  if (!service_name) return MPI_ERR_ARG;
  DssVal reply;
  int rc = nameserver_rpc({"unpub", service_name}, reply);
  if (rc != MPI_SUCCESS) return rc;
  return reply.tag == T_BOOL && reply.i ? MPI_SUCCESS : MPI_ERR_ARG;
}

// general distributed graph (dist_graph_create.c): edges may describe
// ANY node, so one allgatherv round routes every (src, dst, weight)
// triple to everyone; each rank then filters its in/out lists in
// contributor order
int MPI_Dist_graph_create(MPI_Comm comm, int n, const int sources[],
                          const int degrees[], const int destinations[],
                          const int weights[], MPI_Info /*info*/,
                          int /*reorder*/, MPI_Comm *newcomm) {
  CommObj *c = lookup_comm(comm);
  if (!c || !c->remote.empty()) return MPI_ERR_COMM;
  if (n < 0) return MPI_ERR_ARG;
  int csize = (int)c->group.size();
  bool weighted = weights != MPI_UNWEIGHTED;
  std::vector<int64_t> mine;
  {
    int at = 0;
    for (int i = 0; i < n; i++) {
      if (sources[i] < 0 || sources[i] >= csize || degrees[i] < 0)
        return MPI_ERR_ARG;
      for (int e = 0; e < degrees[i]; e++, at++) {
        if (destinations[at] < 0 || destinations[at] >= csize)
          return MPI_ERR_ARG;
        mine.push_back(sources[i]);
        mine.push_back(destinations[at]);
        mine.push_back(
            weighted && weights != MPI_WEIGHTS_EMPTY ? weights[at] : 1);
      }
    }
  }
  int my_n = (int)mine.size();
  std::vector<int> counts((size_t)csize), displs((size_t)csize);
  int rc = c_allgather(*c, &my_n, 1, MPI_INT, counts.data(), 1, MPI_INT);
  if (rc != MPI_SUCCESS) return rc;
  int total = 0;
  for (int r = 0; r < csize; r++) {
    displs[(size_t)r] = total;
    total += counts[(size_t)r];
  }
  std::vector<int64_t> all((size_t)total);
  rc = c_allgatherv(*c, mine.data(), my_n, MPI_LONG, all.data(),
                    counts.data(), displs.data(), MPI_LONG);
  if (rc != MPI_SUCCESS) return rc;
  int me = c->local_rank;
  std::vector<int> in_src, in_w, out_dst, out_w;
  for (int t = 0; t + 2 < total; t += 3) {
    int src = (int)all[(size_t)t], dst = (int)all[(size_t)t + 1];
    int w = (int)all[(size_t)t + 2];
    if (dst == me) {
      in_src.push_back(src);
      in_w.push_back(w);
    }
    if (src == me) {
      out_dst.push_back(dst);
      out_w.push_back(w);
    }
  }
  rc = MPI_Comm_split(comm, 0, me, newcomm);
  if (rc != MPI_SUCCESS) return rc;
  CommObj *nc = lookup_comm(*newcomm);
  nc->dist = true;
  nc->dist_src = std::move(in_src);
  nc->dist_dst = std::move(out_dst);
  nc->dist_weighted = weighted;
  if (weighted) {
    nc->dist_srcw = std::move(in_w);
    nc->dist_dstw = std::move(out_w);
  }
  return MPI_SUCCESS;
}

// predefined attribute functions (attr_fn.c): the do-nothing copy and
// delete callbacks plus the always-copy DUP_FN
int MPI_NULL_COPY_FN(MPI_Comm, int, void *, void *, void *, int *flag) {
  *flag = 0;
  return MPI_SUCCESS;
}
int MPI_NULL_DELETE_FN(MPI_Comm, int, void *, void *) {
  return MPI_SUCCESS;
}
int MPI_DUP_FN(MPI_Comm, int, void *, void *attribute_val_in,
               void *attribute_val_out, int *flag) {
  *(void **)attribute_val_out = attribute_val_in;
  *flag = 1;
  return MPI_SUCCESS;
}

// ------------------------------------------- MPI_T tool interface
// ompi/mpi/tool reduced to this shim's variable set: cvars are the
// MCA-style knobs MPI_Init reads from ZMPI_MCA_* (writable at runtime
// through exactly this interface, the reference's cvar write path);
// pvars read the engine's live counters and queue levels.

static bool g_mpit_up = false;

struct CvarDesc {
  const char *name;
  const char *desc;
  MPI_Datatype dt;
  int scope;  // MPI_T_SCOPE_LOCAL = writable here
};
static const CvarDesc g_cvars[] = {
    {"tcp_eager_limit",
     "protocol switch: payloads above this many bytes go rendezvous",
     MPI_LONG, MPI_T_SCOPE_LOCAL},
    {"rndv_cts_timeout",
     "seconds a rendezvous sender waits for CTS (<0 = forever)",
     MPI_DOUBLE, MPI_T_SCOPE_LOCAL},
};
constexpr int N_CVARS = (int)(sizeof g_cvars / sizeof g_cvars[0]);

struct PvarDesc {
  const char *name;
  const char *desc;
  int var_class;
};
static const PvarDesc g_pvars[] = {
    {"eager_sends", "messages sent on the eager path",
     MPI_T_PVAR_CLASS_COUNTER},
    {"rndv_sends", "messages sent through the rendezvous protocol",
     MPI_T_PVAR_CLASS_COUNTER},
    {"bytes_sent", "payload bytes handed to the wire",
     MPI_T_PVAR_CLASS_COUNTER},
    {"unexpected_msgs", "current unexpected-queue length",
     MPI_T_PVAR_CLASS_LEVEL},
    {"posted_recvs", "current posted-receive-queue length",
     MPI_T_PVAR_CLASS_LEVEL},
};
constexpr int N_PVARS = (int)(sizeof g_pvars / sizeof g_pvars[0]);

static std::set<int> g_pvar_sessions;
static int g_next_pvar_session = 1;

static void mpit_str(const char *src, char *dst, int *len) {
  if (dst && len && *len > 0) {
    snprintf(dst, (size_t)*len, "%s", src);
    *len = (int)strlen(dst);
  } else if (len) {
    *len = (int)strlen(src) + 1;
  }
}

int MPI_T_init_thread(int, int *provided) {
  g_mpit_up = true;
  if (provided) *provided = g_thread_level;
  return MPI_SUCCESS;
}

int MPI_T_finalize(void) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  g_mpit_up = false;
  g_pvar_sessions.clear();
  return MPI_SUCCESS;
}

int MPI_T_cvar_get_num(int *num_cvar) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  *num_cvar = N_CVARS;
  return MPI_SUCCESS;
}

int MPI_T_cvar_get_info(int idx, char *name, int *name_len,
                        int *verbosity, MPI_Datatype *datatype,
                        void *, char *desc, int *desc_len, int *bind,
                        int *scope) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  if (idx < 0 || idx >= N_CVARS) return MPI_T_ERR_INVALID_INDEX;
  mpit_str(g_cvars[idx].name, name, name_len);
  mpit_str(g_cvars[idx].desc, desc, desc_len);
  if (verbosity) *verbosity = MPI_T_VERBOSITY_USER_BASIC;
  if (datatype) *datatype = g_cvars[idx].dt;
  if (bind) *bind = MPI_T_BIND_NO_OBJECT;
  if (scope) *scope = g_cvars[idx].scope;
  return MPI_SUCCESS;
}

int MPI_T_cvar_handle_alloc(int idx, void *, MPI_T_cvar_handle *handle,
                            int *count) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  if (idx < 0 || idx >= N_CVARS) return MPI_T_ERR_INVALID_INDEX;
  *handle = idx;  // the variable set is static; the index IS the handle
  if (count) *count = 1;
  return MPI_SUCCESS;
}

int MPI_T_cvar_handle_free(MPI_T_cvar_handle *handle) {
  if (handle) *handle = -1;
  return MPI_SUCCESS;
}

int MPI_T_cvar_read(MPI_T_cvar_handle h, void *buf) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  switch (h) {
    case 0:
      *(long *)buf = (long)g.eager_limit.load();
      return MPI_SUCCESS;
    case 1:
      *(double *)buf = g.cts_timeout.load();
      return MPI_SUCCESS;
  }
  return MPI_T_ERR_INVALID_HANDLE;
}

int MPI_T_cvar_write(MPI_T_cvar_handle h, const void *buf) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  switch (h) {
    case 0: {
      long v = *(const long *)buf;
      if (v <= 0) return MPI_T_ERR_CVAR_SET_NOT_NOW;
      g.eager_limit = v;
      return MPI_SUCCESS;
    }
    case 1:
      g.cts_timeout = *(const double *)buf;
      return MPI_SUCCESS;
  }
  return MPI_T_ERR_INVALID_HANDLE;
}

int MPI_T_pvar_get_num(int *num_pvar) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  *num_pvar = N_PVARS;
  return MPI_SUCCESS;
}

int MPI_T_pvar_get_info(int idx, char *name, int *name_len,
                        int *verbosity, int *var_class,
                        MPI_Datatype *datatype, void *, char *desc,
                        int *desc_len, int *bind, int *readonly,
                        int *continuous, int *atomic_) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  if (idx < 0 || idx >= N_PVARS) return MPI_T_ERR_INVALID_INDEX;
  mpit_str(g_pvars[idx].name, name, name_len);
  mpit_str(g_pvars[idx].desc, desc, desc_len);
  if (verbosity) *verbosity = MPI_T_VERBOSITY_USER_BASIC;
  if (var_class) *var_class = g_pvars[idx].var_class;
  if (datatype) *datatype = MPI_LONG_LONG;
  if (bind) *bind = MPI_T_BIND_NO_OBJECT;
  if (readonly) *readonly = 1;
  if (continuous) *continuous = 1;  // counters never need start/stop
  if (atomic_) *atomic_ = 0;
  return MPI_SUCCESS;
}

int MPI_T_pvar_session_create(MPI_T_pvar_session *session) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  *session = g_next_pvar_session++;
  g_pvar_sessions.insert(*session);
  return MPI_SUCCESS;
}

int MPI_T_pvar_session_free(MPI_T_pvar_session *session) {
  if (!session || !g_pvar_sessions.erase(*session))
    return MPI_T_ERR_INVALID_HANDLE;
  *session = -1;
  return MPI_SUCCESS;
}

int MPI_T_pvar_handle_alloc(MPI_T_pvar_session session, int idx, void *,
                            MPI_T_pvar_handle *handle, int *count) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  if (!g_pvar_sessions.count(session)) return MPI_T_ERR_INVALID_HANDLE;
  if (idx < 0 || idx >= N_PVARS) return MPI_T_ERR_INVALID_INDEX;
  *handle = idx;
  if (count) *count = 1;
  return MPI_SUCCESS;
}

int MPI_T_pvar_handle_free(MPI_T_pvar_session,
                           MPI_T_pvar_handle *handle) {
  if (handle) *handle = -1;
  return MPI_SUCCESS;
}

int MPI_T_pvar_start(MPI_T_pvar_session session, MPI_T_pvar_handle) {
  // continuous variables: start is a no-op (the reference's behavior)
  return g_pvar_sessions.count(session) ? MPI_SUCCESS
                                        : MPI_T_ERR_INVALID_HANDLE;
}

int MPI_T_pvar_stop(MPI_T_pvar_session session, MPI_T_pvar_handle) {
  return g_pvar_sessions.count(session) ? MPI_SUCCESS
                                        : MPI_T_ERR_INVALID_HANDLE;
}

int MPI_T_pvar_read(MPI_T_pvar_session session, MPI_T_pvar_handle h,
                    void *buf) {
  if (!g_mpit_up) return MPI_T_ERR_NOT_INITIALIZED;
  if (!g_pvar_sessions.count(session)) return MPI_T_ERR_INVALID_HANDLE;
  long long v;
  switch (h) {
    case 0: v = g.ctr_eager_sends.load(); break;
    case 1: v = g.ctr_rndv_sends.load(); break;
    case 2: v = g.ctr_bytes_sent.load(); break;
    case 3: {
      std::lock_guard<std::mutex> lk(g.match_mu);
      v = (long long)g.unexpected.size();
      break;
    }
    case 4: {
      std::lock_guard<std::mutex> lk(g.match_mu);
      v = (long long)g.posted.size();
      break;
    }
    default:
      return MPI_T_ERR_INVALID_HANDLE;
  }
  *(long long *)buf = v;
  return MPI_SUCCESS;
}

// ---------------------------------------------------------------- misc

int MPI_Abort(MPI_Comm, int errorcode) {
  fprintf(stderr, "MPI_Abort(%d)\n", errorcode);
  // best-effort: unlink this rank's ring files so an aborted job does
  // not strand /dev/shm segments (the launcher sweeps the rest; pure
  // syscalls, safe in this context)
  for (auto &e : g_sm_out)
    if (e.second->creator) shm_unlink(e.second->path.c_str());
  _exit(errorcode ? errorcode : 1);
}

double MPI_Wtime(void) {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch())
      .count();
}

double MPI_Wtick(void) { return 1e-9; }

}  // extern "C"

// PMPI profiling layer: weak MPI_X + PMPI_X aliases (generated)
#include "zompi_pmpi.inc"
