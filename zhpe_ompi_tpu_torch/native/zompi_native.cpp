// zompi native runtime kernels (the port's own copy; namesake:
// zhpe_ompi_tpu/native/zompi_native.cpp, same C ABI, same codes, ABI 3).
//
// C++ components for the host-plane hot paths, where the reference is
// native C (SURVEY.md §2.1): the datatype convertor
// (opal/datatype/opal_convertor.c:218-276 — segment-walking pack/unpack), the
// reduction op kernel table (ompi/mca/op/base/op_base_functions.c,
// ompi_op_base_functions[OP_MAX][TYPE_MAX]), the receive-side tag-matching
// engine (ompi/mca/pml/ob1/pml_ob1_recvfrag.c:295-513), and the
// cross-process atomics on shared mappings (the one-sided plane's lock words
// and the symmetric heap's AMOs).
//
// Exposed as a flat C ABI loaded with ctypes (native/__init__.py).  The
// card's compute path never touches this library: tensors on the card are
// packed and reduced there (datatype/convertor.py's device path, csrc/);
// these kernels serve host memory (the wire transport, MPI_Pack
// semantics, host-side reductions, the matching queues).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libzompi.so zompi_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <deque>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Datatype convertor: segment-based pack/unpack.
//
// `segs` is a flat array of nsegs (displacement, nbytes) int64 pairs — the
// optimized description (maximal contiguous runs) of ONE element of the
// datatype, cf. opal_datatype_optimize.c. `extent` strides elements.
// ---------------------------------------------------------------------------

void zompi_pack(const uint8_t* src, uint8_t* dst, const int64_t* segs,
                int64_t nsegs, int64_t extent, int64_t count) {
  for (int64_t e = 0; e < count; ++e) {
    const uint8_t* base = src + e * extent;
    for (int64_t s = 0; s < nsegs; ++s) {
      const int64_t disp = segs[2 * s], nb = segs[2 * s + 1];
      std::memcpy(dst, base + disp, static_cast<size_t>(nb));
      dst += nb;
    }
  }
}

void zompi_unpack(const uint8_t* src, uint8_t* dst, const int64_t* segs,
                  int64_t nsegs, int64_t extent, int64_t count) {
  for (int64_t e = 0; e < count; ++e) {
    uint8_t* base = dst + e * extent;
    for (int64_t s = 0; s < nsegs; ++s) {
      const int64_t disp = segs[2 * s], nb = segs[2 * s + 1];
      std::memcpy(base + disp, src, static_cast<size_t>(nb));
      src += nb;
    }
  }
}

// Resumable pack: emit packed bytes [position, position+max_bytes) of the
// packed stream (MPI_Pack / convertor-with-position semantics,
// test/datatype/position.c). Returns the new position.
int64_t zompi_pack_partial(const uint8_t* src, uint8_t* dst,
                           const int64_t* segs, int64_t nsegs, int64_t extent,
                           int64_t count, int64_t position,
                           int64_t max_bytes) {
  int64_t elem_size = 0;
  for (int64_t s = 0; s < nsegs; ++s) elem_size += segs[2 * s + 1];
  if (elem_size == 0) return position;
  int64_t remaining = max_bytes;
  int64_t pos = position;
  while (remaining > 0 && pos < elem_size * count) {
    const int64_t e = pos / elem_size;
    int64_t off = pos % elem_size;  // offset into this element's packed bytes
    const uint8_t* base = src + e * extent;
    for (int64_t s = 0; s < nsegs && remaining > 0; ++s) {
      const int64_t disp = segs[2 * s], nb = segs[2 * s + 1];
      if (off >= nb) {
        off -= nb;
        continue;
      }
      const int64_t take = std::min(nb - off, remaining);
      std::memcpy(dst, base + disp + off, static_cast<size_t>(take));
      dst += take;
      pos += take;
      remaining -= take;
      off = 0;
    }
  }
  return pos;
}

// Resumable unpack of a chunk landing at packed-byte `position` (chunks may
// arrive out of order, cf. test/datatype/unpack_ooo.c). Returns new position.
int64_t zompi_unpack_partial(const uint8_t* src, int64_t nbytes, uint8_t* dst,
                             const int64_t* segs, int64_t nsegs,
                             int64_t extent, int64_t count, int64_t position) {
  int64_t elem_size = 0;
  for (int64_t s = 0; s < nsegs; ++s) elem_size += segs[2 * s + 1];
  if (elem_size == 0) return position;
  int64_t remaining = nbytes;
  int64_t pos = position;
  while (remaining > 0 && pos < elem_size * count) {
    const int64_t e = pos / elem_size;
    int64_t off = pos % elem_size;
    uint8_t* base = dst + e * extent;
    for (int64_t s = 0; s < nsegs && remaining > 0; ++s) {
      const int64_t disp = segs[2 * s], nb = segs[2 * s + 1];
      if (off >= nb) {
        off -= nb;
        continue;
      }
      const int64_t take = std::min(nb - off, remaining);
      std::memcpy(base + disp + off, src, static_cast<size_t>(take));
      src += take;
      pos += take;
      remaining -= take;
      off = 0;
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Reduction op kernels: the ompi_op_base_functions[op][type] table as a
// compile-time template expansion. inout[i] = combine(in[i], inout[i])
// (MPI_Reduce source/target order, ompi/op/op.h:547-605).
// ---------------------------------------------------------------------------

enum ZompiOp {
  ZOMPI_OP_SUM = 0,
  ZOMPI_OP_PROD = 1,
  ZOMPI_OP_MAX = 2,
  ZOMPI_OP_MIN = 3,
  ZOMPI_OP_BAND = 4,
  ZOMPI_OP_BOR = 5,
  ZOMPI_OP_BXOR = 6,
  ZOMPI_OP_LAND = 7,
  ZOMPI_OP_LOR = 8,
  ZOMPI_OP_LXOR = 9,
};

enum ZompiType {
  ZOMPI_T_I8 = 0,
  ZOMPI_T_U8 = 1,
  ZOMPI_T_I16 = 2,
  ZOMPI_T_U16 = 3,
  ZOMPI_T_I32 = 4,
  ZOMPI_T_U32 = 5,
  ZOMPI_T_I64 = 6,
  ZOMPI_T_U64 = 7,
  ZOMPI_T_F32 = 8,
  ZOMPI_T_F64 = 9,
};

}  // extern "C"

namespace {

template <typename T>
void reduce_typed(int op, const T* in, T* inout, int64_t n, bool is_integer) {
  switch (op) {
    case ZOMPI_OP_SUM:
      for (int64_t i = 0; i < n; ++i) inout[i] = in[i] + inout[i];
      break;
    case ZOMPI_OP_PROD:
      for (int64_t i = 0; i < n; ++i) inout[i] = in[i] * inout[i];
      break;
    case ZOMPI_OP_MAX:
      // NaN propagates, matching np.maximum (either operand NaN → NaN)
      for (int64_t i = 0; i < n; ++i) {
        if constexpr (std::is_floating_point_v<T>) {
          inout[i] =
              (in[i] > inout[i] || std::isnan(in[i])) ? in[i] : inout[i];
        } else {
          inout[i] = in[i] > inout[i] ? in[i] : inout[i];
        }
      }
      break;
    case ZOMPI_OP_MIN:
      for (int64_t i = 0; i < n; ++i) {
        if constexpr (std::is_floating_point_v<T>) {
          inout[i] =
              (in[i] < inout[i] || std::isnan(in[i])) ? in[i] : inout[i];
        } else {
          inout[i] = in[i] < inout[i] ? in[i] : inout[i];
        }
      }
      break;
    case ZOMPI_OP_LAND:
      for (int64_t i = 0; i < n; ++i)
        inout[i] = static_cast<T>((in[i] != T(0)) && (inout[i] != T(0)));
      break;
    case ZOMPI_OP_LOR:
      for (int64_t i = 0; i < n; ++i)
        inout[i] = static_cast<T>((in[i] != T(0)) || (inout[i] != T(0)));
      break;
    case ZOMPI_OP_LXOR:
      for (int64_t i = 0; i < n; ++i)
        inout[i] = static_cast<T>((in[i] != T(0)) != (inout[i] != T(0)));
      break;
    default:
      (void)is_integer;
      break;
  }
}

template <typename T>
void reduce_bitwise(int op, const T* in, T* inout, int64_t n) {
  switch (op) {
    case ZOMPI_OP_BAND:
      for (int64_t i = 0; i < n; ++i) inout[i] = in[i] & inout[i];
      break;
    case ZOMPI_OP_BOR:
      for (int64_t i = 0; i < n; ++i) inout[i] = in[i] | inout[i];
      break;
    case ZOMPI_OP_BXOR:
      for (int64_t i = 0; i < n; ++i) inout[i] = in[i] ^ inout[i];
      break;
    default:
      break;
  }
}

template <typename T>
int reduce_dispatch_int(int op, const void* in, void* inout, int64_t n) {
  if (op >= ZOMPI_OP_BAND && op <= ZOMPI_OP_BXOR) {
    reduce_bitwise<T>(op, static_cast<const T*>(in), static_cast<T*>(inout), n);
  } else {
    reduce_typed<T>(op, static_cast<const T*>(in), static_cast<T*>(inout), n,
                    true);
  }
  return 0;
}

template <typename T>
int reduce_dispatch_float(int op, const void* in, void* inout, int64_t n) {
  if (op >= ZOMPI_OP_BAND && op <= ZOMPI_OP_BXOR) return -1;  // no bitwise
  reduce_typed<T>(op, static_cast<const T*>(in), static_cast<T*>(inout), n,
                  false);
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 for an undefined (op, type) pair — the caller
// falls back to the Python path (mirrors the reference's NULL table slots).
int zompi_reduce(int op, int type, const void* in, void* inout, int64_t n) {
  if (op < ZOMPI_OP_SUM || op > ZOMPI_OP_LXOR) return -1;  // unknown op code
  switch (type) {
    case ZOMPI_T_I8:
      return reduce_dispatch_int<int8_t>(op, in, inout, n);
    case ZOMPI_T_U8:
      return reduce_dispatch_int<uint8_t>(op, in, inout, n);
    case ZOMPI_T_I16:
      return reduce_dispatch_int<int16_t>(op, in, inout, n);
    case ZOMPI_T_U16:
      return reduce_dispatch_int<uint16_t>(op, in, inout, n);
    case ZOMPI_T_I32:
      return reduce_dispatch_int<int32_t>(op, in, inout, n);
    case ZOMPI_T_U32:
      return reduce_dispatch_int<uint32_t>(op, in, inout, n);
    case ZOMPI_T_I64:
      return reduce_dispatch_int<int64_t>(op, in, inout, n);
    case ZOMPI_T_U64:
      return reduce_dispatch_int<uint64_t>(op, in, inout, n);
    case ZOMPI_T_F32:
      return reduce_dispatch_float<float>(op, in, inout, n);
    case ZOMPI_T_F64:
      return reduce_dispatch_float<double>(op, in, inout, n);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// Tag-matching engine (pml_ob1_recvfrag.c:295-513): posted-receive list +
// unexpected-message queue with MPI wildcard semantics. Payloads and request
// callbacks live on the Python side, referenced here by opaque uint64 keys.
// ---------------------------------------------------------------------------

struct ZompiEnvelope {
  int64_t src, tag, cid, seq;
  uint64_t payload_key;
};

struct ZompiPosted {
  int64_t src, tag, cid;  // src/tag may be -1 (ANY)
  uint64_t req_key;
};

struct ZompiMatch {
  std::mutex mu;
  std::deque<ZompiPosted> posted;
  std::deque<ZompiEnvelope> unexpected;
};

static inline bool zompi_matches(const ZompiPosted& p, const ZompiEnvelope& e) {
  if (p.cid != e.cid) return false;
  if (p.src != -1 && p.src != e.src) return false;
  if (p.tag != -1 && p.tag != e.tag) return false;
  return true;
}

void* zompi_match_create() { return new ZompiMatch(); }

void zompi_match_destroy(void* h) { delete static_cast<ZompiMatch*>(h); }

// Post a receive. Returns 1 and fills out_env[4]={src,tag,cid,seq} +
// *out_payload_key if an unexpected message matched (earliest wins), else 0.
int zompi_match_post(void* h, int64_t src, int64_t tag, int64_t cid,
                     uint64_t req_key, int64_t* out_env,
                     uint64_t* out_payload_key) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  ZompiPosted p{src, tag, cid, req_key};
  for (auto it = m->unexpected.begin(); it != m->unexpected.end(); ++it) {
    if (zompi_matches(p, *it)) {
      out_env[0] = it->src;
      out_env[1] = it->tag;
      out_env[2] = it->cid;
      out_env[3] = it->seq;
      *out_payload_key = it->payload_key;
      m->unexpected.erase(it);
      return 1;
    }
  }
  m->posted.push_back(p);
  return 0;
}

// Deliver an arriving message. Returns 1 and fills *out_req_key if a posted
// receive matched (earliest wins), else 0 (parked on the unexpected queue).
int zompi_match_incoming(void* h, int64_t src, int64_t tag, int64_t cid,
                         int64_t seq, uint64_t payload_key,
                         uint64_t* out_req_key) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  ZompiEnvelope e{src, tag, cid, seq, payload_key};
  for (auto it = m->posted.begin(); it != m->posted.end(); ++it) {
    if (zompi_matches(*it, e)) {
      *out_req_key = it->req_key;
      m->posted.erase(it);
      return 1;
    }
  }
  m->unexpected.push_back(e);
  return 0;
}

// MPI_Iprobe: peek the earliest matching unexpected envelope (no dequeue).
int zompi_match_probe(void* h, int64_t src, int64_t tag, int64_t cid,
                      int64_t* out_env) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  ZompiPosted p{src, tag, cid, 0};
  for (const auto& e : m->unexpected) {
    if (zompi_matches(p, e)) {
      out_env[0] = e.src;
      out_env[1] = e.tag;
      out_env[2] = e.cid;
      out_env[3] = e.seq;
      return 1;
    }
  }
  return 0;
}

// MPI_Mprobe: dequeue the earliest matching unexpected envelope — the
// returned message is matched and can no longer satisfy other receives.
int zompi_match_extract(void* h, int64_t src, int64_t tag, int64_t cid,
                        int64_t* out_env, uint64_t* out_payload_key) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  ZompiPosted p{src, tag, cid, 0};
  for (auto it = m->unexpected.begin(); it != m->unexpected.end(); ++it) {
    if (zompi_matches(p, *it)) {
      out_env[0] = it->src;
      out_env[1] = it->tag;
      out_env[2] = it->cid;
      out_env[3] = it->seq;
      *out_payload_key = it->payload_key;
      m->unexpected.erase(it);
      return 1;
    }
  }
  return 0;
}

void zompi_match_stats(void* h, int64_t* n_posted, int64_t* n_unexpected) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  *n_posted = static_cast<int64_t>(m->posted.size());
  *n_unexpected = static_cast<int64_t>(m->unexpected.size());
}

// Queue depths excluding entries attributable to the given sources or
// communicator ids: posted receives NAMED on an excluded source
// (abandoned after a typed process failure) or posted on an excluded
// cid (a revoked channel never delivers again), and unexpected
// messages FROM an excluded source or carried on an excluded cid.  The
// checkpoint quiescence check uses this so acked-failed peers' and
// revoked channels' rows — which no drain can ever clear — don't block
// a recovery-time snapshot.  ANY_SOURCE (-1) posted receives are
// unattributable by source and counted unless their cid is excluded.
void zompi_match_stats_excluding(void* h, const int64_t* excl_srcs,
                                 int64_t n_excl, const int64_t* excl_cids,
                                 int64_t n_cids, int64_t* n_posted,
                                 int64_t* n_unexpected) {
  ZompiMatch* m = static_cast<ZompiMatch*>(h);
  std::lock_guard<std::mutex> g(m->mu);
  auto excluded = [&](int64_t src, int64_t cid) {
    for (int64_t i = 0; i < n_excl; ++i)
      if (excl_srcs[i] == src) return true;
    for (int64_t i = 0; i < n_cids; ++i)
      if (excl_cids[i] == cid) return true;
    return false;
  };
  int64_t p = 0, u = 0;
  for (const auto& r : m->posted)
    if (!excluded(r.src, r.cid)) ++p;
  for (const auto& e : m->unexpected)
    if (!excluded(e.src, e.cid)) ++u;
  *n_posted = p;
  *n_unexpected = u;
}

// ---------------------------------------------------------------------------
// Cross-process atomics on shared mappings.
//
// The oshmem atomic framework executes AMOs in native code against the
// mapped segment (oshmem/mca/atomic/basic over sshmem/mmap); __atomic
// builtins give lock-free 1/2/4/8-byte read-modify-write that is coherent
// across OS processes sharing the mapping.  A process of either package
// that maps the same region takes the same word: one atomicity domain per
// region whichever package the ranks run.
//
//   kind: 0 fetch-add, 1 swap, 2 compare-and-swap, 3 set (a swap whose
//         old value is discarded), 4 fetch.
//   type: the ZompiType codes above.
//
// Integers travel as int64 (value_i, cmp_i, *old_i), floats as double
// (value_f, cmp_f, *old_f).  Float add is a CAS loop on the bit pattern
// (CAS compares BITS, so -0.0 vs 0.0 and NaN payloads follow bit
// equality).  Returns 0, or -1 for a type code outside the table.
// ---------------------------------------------------------------------------

}  // extern "C"  (templates below need C++ linkage)

namespace {

template <typename T>
void amo_int(T* p, int kind, T val, T cmp, T* old) {
  switch (kind) {
    case 0: *old = __atomic_fetch_add(p, val, __ATOMIC_SEQ_CST); break;
    case 1:
    case 3: *old = __atomic_exchange_n(p, val, __ATOMIC_SEQ_CST); break;
    case 2: {
      T expected = cmp;
      __atomic_compare_exchange_n(p, &expected, val, false,
                                  __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
      *old = expected;  // on failure: the current value, i.e. the pre-op
      break;
    }
    case 4: *old = __atomic_load_n(p, __ATOMIC_SEQ_CST); break;
  }
}

template <typename F, typename Bits>
void amo_float(F* p, int kind, F val, F cmp, F* old) {
  static_assert(sizeof(F) == sizeof(Bits), "pun width");
  Bits* bp = reinterpret_cast<Bits*>(p);
  auto pun = [](F f) { Bits b; std::memcpy(&b, &f, sizeof b); return b; };
  auto unpun = [](Bits b) { F f; std::memcpy(&f, &b, sizeof f); return f; };
  switch (kind) {
    case 0: {
      Bits cur = __atomic_load_n(bp, __ATOMIC_SEQ_CST);
      while (!__atomic_compare_exchange_n(bp, &cur, pun(unpun(cur) + val),
                                          false, __ATOMIC_SEQ_CST,
                                          __ATOMIC_SEQ_CST)) {
      }
      *old = unpun(cur);
      break;
    }
    case 1:
    case 3:
      *old = unpun(__atomic_exchange_n(bp, pun(val), __ATOMIC_SEQ_CST));
      break;
    case 2: {
      Bits expected = pun(cmp);
      __atomic_compare_exchange_n(bp, &expected, pun(val), false,
                                  __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
      *old = unpun(expected);
      break;
    }
    case 4: *old = unpun(__atomic_load_n(bp, __ATOMIC_SEQ_CST)); break;
  }
}

template <typename T>
int amo_i(void* addr, int kind, int64_t v, int64_t c, int64_t* old_i) {
  T o{};
  amo_int<T>(static_cast<T*>(addr), kind, static_cast<T>(v),
             static_cast<T>(c), &o);
  *old_i = static_cast<int64_t>(o);
  return 0;
}

}  // namespace

extern "C" {

int zompi_shm_amo(void* addr, int type_code, int kind, int64_t value_i,
                  int64_t cmp_i, double value_f, double cmp_f,
                  int64_t* old_i, double* old_f) {
  switch (type_code) {
    case 0: return amo_i<int8_t>(addr, kind, value_i, cmp_i, old_i);
    case 1: return amo_i<uint8_t>(addr, kind, value_i, cmp_i, old_i);
    case 2: return amo_i<int16_t>(addr, kind, value_i, cmp_i, old_i);
    case 3: return amo_i<uint16_t>(addr, kind, value_i, cmp_i, old_i);
    case 4: return amo_i<int32_t>(addr, kind, value_i, cmp_i, old_i);
    case 5: return amo_i<uint32_t>(addr, kind, value_i, cmp_i, old_i);
    case 6: return amo_i<int64_t>(addr, kind, value_i, cmp_i, old_i);
    case 7: return amo_i<uint64_t>(addr, kind, value_i, cmp_i, old_i);
    case 8: {
      float o{};
      amo_float<float, uint32_t>(static_cast<float*>(addr), kind,
                                 static_cast<float>(value_f),
                                 static_cast<float>(cmp_f), &o);
      *old_f = o;
      return 0;
    }
    case 9: {
      double o{};
      amo_float<double, uint64_t>(static_cast<double*>(addr), kind, value_f,
                                  cmp_f, &o);
      *old_f = o;
      return 0;
    }
  }
  return -1;
}

// Full memory fence: the ordering point of shmem_quiet/shmem_fence on
// mapped segments.
void zompi_shm_fence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

int zompi_abi_version() { return 3; }

}  // extern "C"
