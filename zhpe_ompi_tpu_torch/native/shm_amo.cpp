// Cross-process atomics on shared mappings (the one-sided plane's lock
// words and the symmetric heap's AMOs).
//
// The two entry points keep the C ABI, the type codes and the operation
// codes of the JAX package's kernel library, so a process of either
// package that maps the same region takes the same lock-free __atomic
// word: one atomicity domain per region whichever package the ranks run.
//
//   kind: 0 fetch-add, 1 swap, 2 compare-and-swap, 3 set (a swap whose
//         old value is discarded), 4 fetch.
//   type: 0 int8, 1 uint8, 2 int16, 3 uint16, 4 int32, 5 uint32,
//         6 int64, 7 uint64, 8 float32, 9 float64.
//
// Integers travel as int64 (value_i, cmp_i, *old_i), floats as double
// (value_f, cmp_f, *old_f).  Float add is a CAS loop on the bit pattern.
// Returns 0, or -1 for a type code outside the table.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libshm_amo.so shm_amo.cpp

#include <cstdint>
#include <cstring>

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
  T o;
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
      float o;
      amo_float<float, uint32_t>(static_cast<float*>(addr), kind,
                                 static_cast<float>(value_f),
                                 static_cast<float>(cmp_f), &o);
      *old_f = o;
      return 0;
    }
    case 9: {
      double o;
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

int zompi_shm_abi_version() { return 1; }

}  // extern "C"
