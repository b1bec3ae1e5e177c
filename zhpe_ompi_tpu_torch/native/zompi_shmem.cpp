/* libzompi OSHMEM layer — shmem.h over the shim's window engine.
 *
 * See zompi_shmem.h for the design.  Compiled into the same
 * libzompi_mpi.so as the MPI surface (build_mpi_shim compiles both
 * translation units), so a process can be an MPI rank and a PE at once,
 * exactly as the reference links ompi + oshmem into one runtime.
 *
 * Internal substrate entry points (zompi_win_amo / zompi_win_flush) are
 * provided by zompi_mpi.cpp; they are deliberately NOT in mpi.h.
 */

#include "zompi_mpi.h"
#include "zompi_shmem.h"

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>

extern "C" {
int zompi_win_amo(MPI_Win win, int target_rank, long long disp_bytes,
                  const char *subkind, MPI_Datatype dt,
                  const void *operand, int operand_items, void *old_out);
int zompi_win_flush(MPI_Win win);
int zompi_win_get_start(MPI_Win win, int target_rank,
                        long long disp_bytes, long long nbytes,
                        void *dest, int *handle_out);
int zompi_win_get_wait(int handle);
}

#include <vector>

namespace {

constexpr size_t ALIGN = 64;  // covers every base dtype

struct ShmemState {
  bool up = false;
  bool owns_mpi = false;  // we called MPI_Init -> we call MPI_Finalize
  char *heap = nullptr;
  size_t heap_bytes = 0;
  MPI_Win win = MPI_WIN_NULL;
  // deterministic first-fit free list: every PE runs the identical
  // collective allocation sequence, so offsets agree with no exchange
  // (the memheap contract)
  std::map<size_t, size_t> free_list;  // offset -> size
  std::map<size_t, size_t> allocated;  // offset -> aligned size
  std::mutex alloc_mu;
  // implicit-handle nonblocking gets completing at shmem_quiet
  std::vector<int> pending_gets;
  std::mutex nbi_mu;
  // shmem_align over-allocation: aligned pointer -> real block start
  std::map<void *, void *> aligned_blocks;
};

ShmemState s;

long long disp_of(const void *ptr) {
  const char *p = (const char *)ptr;
  if (!s.up || p < s.heap || p >= s.heap + s.heap_bytes) {
    fprintf(stderr,
            "zompi_shmem: address %p is not in the symmetric heap\n", ptr);
    return -1;
  }
  return (long long)(p - s.heap);
}

}  // namespace

extern "C" {

int shmem_init(void) {
  if (s.up) return 0;
  int inited = 0;
  MPI_Initialized(&inited);
  if (!inited) {
    if (MPI_Init(nullptr, nullptr) != MPI_SUCCESS) return -1;
    s.owns_mpi = true;
  }
  const char *hb = getenv("ZMPI_SHMEM_HEAP");
  s.heap_bytes = hb && hb[0] ? (size_t)atoll(hb) : (size_t)1 << 20;
  // page-aligned base: shmem_align aligns OFFSETS (the symmetric
  // contract), so an aligned base makes the absolute address aligned
  // too for every alignment up to the page size
  size_t rounded = (s.heap_bytes + 4095) & ~(size_t)4095;
  s.heap = (char *)aligned_alloc(4096, rounded);
  if (!s.heap) return -1;
  memset(s.heap, 0, rounded);
  if (MPI_Win_create(s.heap, (MPI_Aint)s.heap_bytes, 1, MPI_INFO_NULL,
                     MPI_COMM_WORLD, &s.win) != MPI_SUCCESS)
    return -1;
  s.free_list = {{0, s.heap_bytes}};
  s.up = true;
  return 0;
}

void shmem_finalize(void) {
  if (!s.up) return;
  // the spec's implicit quiet: pending nbi gets complete and puts
  // flush BEFORE the window dies under them
  shmem_quiet();
  MPI_Barrier(MPI_COMM_WORLD);
  MPI_Win_free(&s.win);
  free(s.heap);
  s.heap = nullptr;
  // a re-init must not inherit this epoch's bookkeeping: a recycled
  // heap address could alias a stale aligned_blocks key and redirect
  // a future free to the wrong offset
  s.free_list.clear();
  s.allocated.clear();
  s.aligned_blocks.clear();
  {
    std::lock_guard<std::mutex> lk(s.nbi_mu);
    s.pending_gets.clear();
  }
  s.up = false;
  if (s.owns_mpi) MPI_Finalize();
}

int shmem_my_pe(void) {
  int r = -1;
  MPI_Comm_rank(MPI_COMM_WORLD, &r);
  return r;
}

int shmem_n_pes(void) {
  int n = 0;
  MPI_Comm_size(MPI_COMM_WORLD, &n);
  return n;
}

/* ---- symmetric heap ---- */

void *shmem_malloc(size_t size) {
  if (!s.up || size == 0) return nullptr;
  size_t want = (size + ALIGN - 1) & ~(ALIGN - 1);
  void *out = nullptr;
  {
    std::lock_guard<std::mutex> lk(s.alloc_mu);
    for (auto it = s.free_list.begin(); it != s.free_list.end(); ++it) {
      if (it->second >= want) {
        size_t off = it->first, sz = it->second;
        s.free_list.erase(it);
        if (sz > want) s.free_list[off + want] = sz - want;
        s.allocated[off] = want;
        out = s.heap + off;
        break;
      }
    }
  }
  // spec: barrier at EXIT — allocation itself is local deterministic
  // bookkeeping, the sync publishes the new region
  MPI_Barrier(MPI_COMM_WORLD);
  return out;  // null on every PE if any PE would fail (same sequence)
}

void *shmem_calloc(size_t count, size_t size) {
  if (count != 0 && size > (size_t)-1 / count) return nullptr;
  void *p = shmem_malloc(count * size);
  if (p) memset(p, 0, count * size);
  return p;
}

void shmem_free(void *ptr) {
  if (!s.up || !ptr) return;
  {
    // an aligned pointer resolves back to its over-allocated block
    std::lock_guard<std::mutex> lk(s.alloc_mu);
    auto ab = s.aligned_blocks.find(ptr);
    if (ab != s.aligned_blocks.end()) {
      ptr = ab->second;
      s.aligned_blocks.erase(ab);
    }
  }
  // spec: barrier at ENTRY — pending remote accesses to the region
  // must complete before its bytes can be reused
  MPI_Barrier(MPI_COMM_WORLD);
  long long d = disp_of(ptr);
  if (d >= 0) {
    std::lock_guard<std::mutex> lk(s.alloc_mu);
    size_t off = (size_t)d;
    auto a = s.allocated.find(off);
    if (a == s.allocated.end()) {
      fprintf(stderr, "zompi_shmem: free of unallocated %p\n", ptr);
    } else {
      // coalescing free (the deterministic sequence keeps every PE's
      // list identical)
      size_t sz = a->second;
      s.allocated.erase(a);
      auto it = s.free_list.emplace(off, sz).first;
      auto fwd = std::next(it);
      if (fwd != s.free_list.end() &&
          it->first + it->second == fwd->first) {
        it->second += fwd->second;
        s.free_list.erase(fwd);
      }
      if (it != s.free_list.begin()) {
        auto prev = std::prev(it);
        if (prev->first + prev->second == it->first) {
          prev->second += it->second;
          s.free_list.erase(it);
        }
      }
    }
  }
}

/* ---- completion ---- */

void shmem_quiet(void) {
  if (!s.up) return;
  // complete pending nbi gets first, then flush outstanding puts; a
  // failing get must not abandon the rest (drain everything, abort at
  // the end — the OpenSHMEM APIs have no error channel)
  std::vector<int> pend;
  {
    std::lock_guard<std::mutex> lk(s.nbi_mu);
    pend.swap(s.pending_gets);
  }
  bool failed = false;
  for (int h : pend)
    if (zompi_win_get_wait(h) != MPI_SUCCESS) failed = true;
  if (zompi_win_flush(s.win) != MPI_SUCCESS) failed = true;
  if (failed) {
    fprintf(stderr, "zompi_shmem: quiet failed to complete nbi ops\n");
    abort();
  }
}

void shmem_fence(void) {
  /* per-origin FIFO on each connection already orders puts to a PE */
}

void shmem_barrier_all(void) {
  /* spec: completes all outstanding updates BEFORE synchronizing */
  shmem_quiet();
  MPI_Barrier(MPI_COMM_WORLD);
}

/* ---- RMA ---- */

namespace {

// the window API takes int counts; move any size in bounded chunks —
// sized to also bound how long a single wput frame holds the control
// socket's send lock (a CTS queued behind a multi-GB write would stall
// unrelated rendezvous)
constexpr size_t CHUNK = 16u << 20;

}  // namespace

void shmem_putmem(void *dest, const void *source, size_t nbytes, int pe) {
  long long d = disp_of(dest);
  if (d < 0) return;
  const char *src = (const char *)source;
  for (size_t off = 0; off < nbytes; off += CHUNK) {
    size_t n = nbytes - off < CHUNK ? nbytes - off : CHUNK;
    if (MPI_Put(src + off, (int)n, MPI_BYTE, pe, (MPI_Aint)(d + off),
                (int)n, MPI_BYTE, s.win) != MPI_SUCCESS) {
      fprintf(stderr, "zompi_shmem: put to PE %d failed\n", pe);
      abort();
    }
  }
}

void shmem_getmem(void *dest, const void *source, size_t nbytes, int pe) {
  long long d = disp_of(source);
  if (d < 0) return;
  char *dst = (char *)dest;
  for (size_t off = 0; off < nbytes; off += CHUNK) {
    size_t n = nbytes - off < CHUNK ? nbytes - off : CHUNK;
    if (MPI_Get(dst + off, (int)n, MPI_BYTE, pe, (MPI_Aint)(d + off),
                (int)n, MPI_BYTE, s.win) != MPI_SUCCESS) {
      fprintf(stderr, "zompi_shmem: get from PE %d failed\n", pe);
      abort();
    }
  }
}

void shmem_putmem_nbi(void *dest, const void *source, size_t nbytes,
                      int pe) {
  /* puts are fire-and-forget AMs already: the blocking form IS the
     nbi contract (completion no later than quiet) */
  shmem_putmem(dest, source, nbytes, pe);
}

void shmem_getmem_nbi(void *dest, const void *source, size_t nbytes,
                      int pe) {
  long long d = disp_of(source);
  if (d < 0) return;
  char *dst = (char *)dest;
  for (size_t off = 0; off < nbytes; off += CHUNK) {
    size_t n = nbytes - off < CHUNK ? nbytes - off : CHUNK;
    int handle = -1;
    if (zompi_win_get_start(s.win, pe, d + (long long)off, (long long)n,
                            dst + off, &handle) != MPI_SUCCESS) {
      fprintf(stderr, "zompi_shmem: get_nbi from PE %d failed\n", pe);
      abort();
    }
    std::lock_guard<std::mutex> lk(s.nbi_mu);
    s.pending_gets.push_back(handle);
  }
}

void shmem_long_put(long *dest, const long *source, size_t n, int pe) {
  shmem_putmem(dest, source, n * sizeof(long), pe);
}

void shmem_long_get(long *dest, const long *source, size_t n, int pe) {
  shmem_getmem(dest, source, n * sizeof(long), pe);
}

void shmem_double_put(double *dest, const double *source, size_t n,
                      int pe) {
  shmem_putmem(dest, source, n * sizeof(double), pe);
}

void shmem_double_get(double *dest, const double *source, size_t n,
                      int pe) {
  shmem_getmem(dest, source, n * sizeof(double), pe);
}

void shmem_long_p(long *addr, long value, int pe) {
  shmem_putmem(addr, &value, sizeof value, pe);
}

long shmem_long_g(const long *addr, int pe) {
  long v = 0;
  shmem_getmem(&v, addr, sizeof v, pe);
  return v;
}

void shmem_double_p(double *addr, double value, int pe) {
  shmem_putmem(addr, &value, sizeof value, pe);
}

double shmem_double_g(const double *addr, int pe) {
  double v = 0;
  shmem_getmem(&v, addr, sizeof v, pe);
  return v;
}

/* ---- atomics (64-bit long via the fetch-AMO RPC) ---- */

namespace {

long amo_long(const void *target, int pe, const char *kind, long v0,
              long v1 = 0) {
  long long d = disp_of(target);
  long old = 0;
  long opnd[2] = {v0, v1};
  bool is_cas = strcmp(kind, "cas") == 0;
  int items = is_cas ? 2 : 1;  // fetch: items is the element count
  int rc = d < 0 ? MPI_ERR_ARG
                 : zompi_win_amo(s.win, pe, d, kind, MPI_LONG, opnd,
                                 items, &old);
  if (rc != MPI_SUCCESS) {
    // the OpenSHMEM atomic APIs have no error channel; fabricating an
    // old value of 0 would e.g. hand out a held lock — abort, the
    // reference's failure semantics for a dead transport
    fprintf(stderr, "zompi_shmem: atomic %s to PE %d failed (rc=%d)\n",
            kind, pe, rc);
    abort();
  }
  return old;
}

}  // namespace

void shmem_long_atomic_add(long *t, long v, int pe) {
  amo_long(t, pe, "add", v);
}

long shmem_long_atomic_fetch_add(long *t, long v, int pe) {
  return amo_long(t, pe, "add", v);
}

void shmem_long_atomic_inc(long *t, int pe) { amo_long(t, pe, "add", 1); }

long shmem_long_atomic_fetch_inc(long *t, int pe) {
  return amo_long(t, pe, "add", 1);
}

long shmem_long_atomic_swap(long *t, long v, int pe) {
  return amo_long(t, pe, "swap", v);
}

long shmem_long_atomic_compare_swap(long *t, long cond, long v, int pe) {
  return amo_long(t, pe, "cas", cond, v);
}

long shmem_long_atomic_fetch(const long *t, int pe) {
  return amo_long(t, pe, "fetch", 0);
}

void shmem_long_atomic_set(long *t, long v, int pe) {
  amo_long(t, pe, "set", v);
}

/* ---- point synchronization ---- */

void shmem_long_wait_until(long *ivar, int cmp, long value) {
  // reads go through the local fetch-AMO so they serialize against the
  // drain's concurrent applications under the window lock
  int me = shmem_my_pe();
  for (;;) {
    long v = shmem_long_atomic_fetch(ivar, me);
    bool ok = false;
    switch (cmp) {
      case SHMEM_CMP_EQ: ok = v == value; break;
      case SHMEM_CMP_NE: ok = v != value; break;
      case SHMEM_CMP_GT: ok = v > value; break;
      case SHMEM_CMP_GE: ok = v >= value; break;
      case SHMEM_CMP_LT: ok = v < value; break;
      case SHMEM_CMP_LE: ok = v <= value; break;
    }
    if (ok) return;
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

/* ---- collectives (over the MPI plane, scoll/mpi's shape) ---- */

void shmem_broadcastmem(void *dest, const void *source, size_t nbytes,
                        int pe_root) {
  // 1.4 semantics: root's source lands in every PE's dest (root
  // included)
  if (shmem_my_pe() == pe_root && dest != source)
    memcpy(dest, source, nbytes);
  MPI_Bcast(dest, (int)nbytes, MPI_BYTE, pe_root, MPI_COMM_WORLD);
}

void shmem_long_sum_reduce(long *dest, const long *source, size_t n) {
  MPI_Allreduce(source, dest, (int)n, MPI_LONG, MPI_SUM, MPI_COMM_WORLD);
}

void shmem_long_max_reduce(long *dest, const long *source, size_t n) {
  MPI_Allreduce(source, dest, (int)n, MPI_LONG, MPI_MAX, MPI_COMM_WORLD);
}

void shmem_double_sum_reduce(double *dest, const double *source,
                             size_t n) {
  MPI_Allreduce(source, dest, (int)n, MPI_DOUBLE, MPI_SUM,
                MPI_COMM_WORLD);
}

void shmem_double_max_reduce(double *dest, const double *source,
                             size_t n) {
  MPI_Allreduce(source, dest, (int)n, MPI_DOUBLE, MPI_MAX,
                MPI_COMM_WORLD);
}

void shmem_fcollectmem(void *dest, const void *source, size_t nbytes) {
  MPI_Allgather(source, (int)nbytes, MPI_BYTE, dest, (int)nbytes,
                MPI_BYTE, MPI_COMM_WORLD);
}

/* ---- distributed locks (PE 0's instance is the authority) ---- */

void shmem_set_lock(long *lock) {
  int me = shmem_my_pe();
  for (;;) {
    long old = shmem_long_atomic_compare_swap(lock, 0, (long)me + 1, 0);
    if (old == 0) return;
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

void shmem_clear_lock(long *lock) {
  shmem_long_atomic_set(lock, 0, 0);
}

int shmem_test_lock(long *lock) {
  int me = shmem_my_pe();
  long old = shmem_long_atomic_compare_swap(lock, 0, (long)me + 1, 0);
  return old == 0 ? 0 : 1;  /* 0 = acquired, OpenSHMEM contract */
}

}  // extern "C"

/* ------------------------- round-5 completion tier ------------------
 * shmem_align.c, shmem_realloc.c, shmem_ptr.c, shmem_pe_accessible.c,
 * shmem_iput.c/iget.c, shmem_alltoall.c, shmem_collect.c,
 * shmem_sync.c, shmem_global_exit.c, shmem_info.c, the deprecated
 * cache ops, and the legacy start_pes-era names. */

extern "C" {

void *shmem_align(size_t alignment, size_t size) {
  // the symmetric contract aligns the OFFSET (identical on every PE);
  // the page-aligned heap base then makes the local address aligned
  // for any power-of-two alignment up to the page size
  if (!s.up || size == 0 || alignment == 0 ||
      (alignment & (alignment - 1)))
    return nullptr;
  // the heap base is 4096-aligned; offsets aligned beyond that would
  // NOT be absolutely aligned — refuse rather than silently misalign
  if (alignment > 4096) return nullptr;
  if (size > (size_t)-1 - alignment) return nullptr;  // size+alignment
  if (alignment <= ALIGN) return shmem_malloc(size);
  // over-allocate, then publish the aligned offset; free() resolves
  // the aligned pointer back to the block through the side map
  char *base = (char *)shmem_malloc(size + alignment);
  if (!base) return nullptr;
  size_t off = (size_t)(base - s.heap);
  size_t aligned_off = (off + alignment - 1) & ~(alignment - 1);
  char *out = s.heap + aligned_off;
  if (out != base) {
    std::lock_guard<std::mutex> lk(s.alloc_mu);
    s.aligned_blocks[out] = base;
  }
  return out;
}

void *shmem_realloc(void *ptr, size_t size) {
  // shmem_realloc.c: collective like malloc/free; contents move
  if (!s.up) return nullptr;
  if (!ptr) return shmem_malloc(size);
  if (size == 0) {
    shmem_free(ptr);
    return nullptr;
  }
  size_t old_sz = 0;
  {
    std::lock_guard<std::mutex> lk(s.alloc_mu);
    void *blk = ptr;  // an aligned pointer's block starts earlier
    auto ab = s.aligned_blocks.find(ptr);
    if (ab != s.aligned_blocks.end()) blk = ab->second;
    long long d = disp_of(blk);
    if (d >= 0) {
      auto a = s.allocated.find((size_t)d);
      if (a != s.allocated.end())
        old_sz = a->second - (size_t)((char *)ptr - (char *)blk);
    }
  }
  // shrink (or refit) in place: the block already covers the request,
  // the symmetric offset stays valid on every PE, and no collective
  // round is needed (every PE takes this same deterministic branch)
  if (size <= old_sz) return ptr;
  void *fresh = shmem_malloc(size);
  if (!fresh) return nullptr;
  memcpy(fresh, ptr, old_sz < size ? old_sz : size);
  shmem_free(ptr);
  return fresh;
}

void *shmem_ptr(const void *dest, int pe) {
  // only the local PE's heap is load/store addressable on this
  // transport (shmem_ptr.c returns NULL exactly then)
  if (!s.up || pe != shmem_my_pe()) return nullptr;
  const char *p = (const char *)dest;
  if (p < s.heap || p >= s.heap + s.heap_bytes) return nullptr;
  return (void *)p;
}

int shmem_pe_accessible(int pe) {
  return s.up && pe >= 0 && pe < shmem_n_pes() ? 1 : 0;
}

int shmem_addr_accessible(const void *addr, int pe) {
  if (!shmem_pe_accessible(pe)) return 0;
  const char *p = (const char *)addr;
  return p >= s.heap && p < s.heap + s.heap_bytes ? 1 : 0;
}

/* strided RMA: element loops over the contiguous engine (the
 * reference's iput is the same loop at the SPML layer) */
#define ZOMPI_IPUT(T, NAME, PUT)                                       \
  void NAME(T *dest, const T *source, ptrdiff_t dst, ptrdiff_t sst,    \
            size_t nelems, int pe) {                                   \
    if (dst == 1 && sst == 1) { /* contiguous: one engine op */        \
      PUT(dest, source, nelems, pe);                                   \
      return;                                                          \
    }                                                                  \
    for (size_t i = 0; i < nelems; i++)                                \
      PUT(dest + (ptrdiff_t)i * dst, source + (ptrdiff_t)i * sst, 1,  \
          pe);                                                         \
  }
ZOMPI_IPUT(long, shmem_long_iput, shmem_long_put)
ZOMPI_IPUT(long, shmem_long_iget, shmem_long_get)
ZOMPI_IPUT(double, shmem_double_iput, shmem_double_put)
ZOMPI_IPUT(double, shmem_double_iget, shmem_double_get)
#undef ZOMPI_IPUT

void shmem_alltoallmem(void *dest, const void *source, size_t nbytes) {
  // the engine's collective counts are int (and frames bound at 4 GiB)
  if (nbytes > (size_t)1 << 30) {
    fprintf(stderr,
            "zompi_shmem: alltoall block of %zu bytes exceeds the "
            "1 GiB per-PE bound\n", nbytes);
    shmem_global_exit(1);
  }
  MPI_Alltoall(source, (int)nbytes, MPI_BYTE, dest, (int)nbytes,
               MPI_BYTE, MPI_COMM_WORLD);
}

void shmem_collectmem(void *dest, const void *source, size_t nbytes) {
  // varying contributions, concatenated in PE order (shmem_collect.c)
  if (nbytes > (size_t)1 << 30) {
    fprintf(stderr,
            "zompi_shmem: collect block of %zu bytes exceeds the "
            "1 GiB per-PE bound\n", nbytes);
    shmem_global_exit(1);
  }
  int n = shmem_n_pes();
  std::vector<int> counts((size_t)n), displs((size_t)n);
  int mine = (int)nbytes;
  MPI_Allgather(&mine, 1, MPI_INT, counts.data(), 1, MPI_INT,
                MPI_COMM_WORLD);
  long long total = 0;
  for (int r = 0; r < n; r++) {
    if (total > (long long)INT32_MAX - counts[(size_t)r]) {
      fprintf(stderr, "zompi_shmem: collect total exceeds 2 GiB\n");
      shmem_global_exit(1);
    }
    displs[(size_t)r] = (int)total;
    total += counts[(size_t)r];
  }
  MPI_Allgatherv(source, mine, MPI_BYTE, dest, counts.data(),
                 displs.data(), MPI_BYTE, MPI_COMM_WORLD);
}

void shmem_sync_all(void) {
  // sync WITHOUT the implicit quiet (shmem_sync.c): pure arrival
  // synchronization — puts need not be remotely complete
  MPI_Barrier(MPI_COMM_WORLD);
}

void shmem_global_exit(int status) {
  MPI_Abort(MPI_COMM_WORLD, status);
}

void shmem_info_get_version(int *major, int *minor) {
  *major = SHMEM_MAJOR_VERSION;
  *minor = SHMEM_MINOR_VERSION;
}

void shmem_info_get_name(char *name) {
  snprintf(name, SHMEM_MAX_NAME_LEN, "zhpe-ompi-tpu OpenSHMEM");
}

/* deprecated cache ops: the host is cache-coherent; kept for link
 * compatibility with start_pes-era codes */
void shmem_set_cache_inv(void) {}
void shmem_clear_cache_inv(void) {}
void shmem_set_cache_line_inv(void *) {}
void shmem_clear_cache_line_inv(void *) {}
void shmem_udcflush(void) {}
void shmem_udcflush_line(void *) {}

/* legacy names */
void start_pes(int) { (void)shmem_init(); }
int _my_pe(void) { return shmem_my_pe(); }
int _num_pes(void) { return shmem_n_pes(); }

void shmem_long_wait(long *ivar, long value) {
  shmem_long_wait_until(ivar, SHMEM_CMP_NE, value);
}

long shmem_swap(long *target, long value, int pe) {
  return shmem_long_atomic_swap(target, value, pe);
}

}  // extern "C"
