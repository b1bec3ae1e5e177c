/* zompi_shmem.h — shmem.h-compatible C OSHMEM surface over the host
 * plane (reference: ``oshmem/shmem/c``, 56 binding files; the OpenSHMEM
 * C API the reference ships next to mpi.h).
 *
 * Re-designed over the shim's window engine instead of a fabric's RDMA
 * verbs: the symmetric heap is a malloc'd arena registered as an
 * internal MPI window over WORLD; symmetric allocation is a lockstep
 * deterministic allocator (identical call sequences -> identical
 * offsets, the reference memheap contract, memheap_base_alloc.c); RMA
 * lowers onto the window's drain-applied put/get tuples; atomics are
 * the fetch-AMO RPC applied under the target's window lock
 * (oshmem/shmem/c/shmem_fadd.c semantics: the service loop is the
 * serialization point); collectives ride the MPI collectives
 * (scoll/mpi's reuse trick).
 *
 * Launch contract: same ZMPI_* env as mpi.h ranks (one universe; a
 * program may use both APIs).  Heap size: ZMPI_SHMEM_HEAP bytes
 * (default 1 MiB) — the SHMEM_SYMMETRIC_SIZE analog.
 *
 * Reductions use the OpenSHMEM-1.4 style (dest, source, nreduce)
 * signatures (no pWrk/pSync scratch arrays — the transport needs none).
 */

#ifndef ZOMPI_SHMEM_H
#define ZOMPI_SHMEM_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* init / identity (shmem_init.c) */
int shmem_init(void);
void shmem_finalize(void);
int shmem_my_pe(void);
int shmem_n_pes(void);

/* symmetric heap (shmem_malloc.c; collective) */
void *shmem_malloc(size_t size);
void *shmem_calloc(size_t count, size_t size);
void shmem_free(void *ptr);

/* ordering / completion (shmem_quiet.c, shmem_fence.c) */
void shmem_quiet(void);
void shmem_fence(void);
void shmem_barrier_all(void);

/* contiguous RMA (shmem_put.c / shmem_get.c family) */
void shmem_putmem(void *dest, const void *source, size_t nbytes, int pe);
void shmem_getmem(void *dest, const void *source, size_t nbytes, int pe);
/* implicit-handle nonblocking RMA (shmem_put_nb.c / shmem_get_nb.c):
 * completion no later than shmem_quiet / shmem_barrier_all */
void shmem_putmem_nbi(void *dest, const void *source, size_t nbytes,
                      int pe);
void shmem_getmem_nbi(void *dest, const void *source, size_t nbytes,
                      int pe);
void shmem_long_put(long *dest, const long *source, size_t nelems, int pe);
void shmem_long_get(long *dest, const long *source, size_t nelems, int pe);
void shmem_double_put(double *dest, const double *source, size_t nelems,
                      int pe);
void shmem_double_get(double *dest, const double *source, size_t nelems,
                      int pe);

/* single-element RMA (shmem_p.c / shmem_g.c) */
void shmem_long_p(long *addr, long value, int pe);
long shmem_long_g(const long *addr, int pe);
void shmem_double_p(double *addr, double value, int pe);
double shmem_double_g(const double *addr, int pe);

/* atomics (shmem_fadd.c / shmem_swap.c / shmem_cswap.c family) */
void shmem_long_atomic_add(long *target, long value, int pe);
long shmem_long_atomic_fetch_add(long *target, long value, int pe);
void shmem_long_atomic_inc(long *target, int pe);
long shmem_long_atomic_fetch_inc(long *target, int pe);
long shmem_long_atomic_swap(long *target, long value, int pe);
long shmem_long_atomic_compare_swap(long *target, long cond, long value,
                                    int pe);
long shmem_long_atomic_fetch(const long *target, int pe);
void shmem_long_atomic_set(long *target, long value, int pe);

/* point synchronization (shmem_wait.c) */
#define SHMEM_CMP_EQ 0
#define SHMEM_CMP_NE 1
#define SHMEM_CMP_GT 2
#define SHMEM_CMP_GE 3
#define SHMEM_CMP_LT 4
#define SHMEM_CMP_LE 5
void shmem_long_wait_until(long *ivar, int cmp, long value);

/* collectives (shmem_broadcast.c / shmem_reduce.c, 1.4 signatures) */
void shmem_broadcastmem(void *dest, const void *source, size_t nbytes,
                        int pe_root);
void shmem_long_sum_reduce(long *dest, const long *source, size_t nreduce);
void shmem_long_max_reduce(long *dest, const long *source, size_t nreduce);
void shmem_double_sum_reduce(double *dest, const double *source,
                             size_t nreduce);
void shmem_double_max_reduce(double *dest, const double *source,
                             size_t nreduce);
void shmem_fcollectmem(void *dest, const void *source, size_t nbytes);

/* distributed locks (shmem_lock.c) */
void shmem_set_lock(long *lock);
void shmem_clear_lock(long *lock);
int shmem_test_lock(long *lock);

/* round-5 completion tier: the rest of the reference's binding
 * families (shmem_align.c, shmem_realloc.c, shmem_ptr.c,
 * shmem_pe_accessible.c, shmem_iput.c/iget.c, shmem_alltoall.c,
 * shmem_collect.c, shmem_sync.c, shmem_global_exit.c, shmem_info.c,
 * the deprecated cache ops, and the legacy start_pes-era names). */
void *shmem_align(size_t alignment, size_t size);
void *shmem_realloc(void *ptr, size_t size);
/* load/store access: only the local PE's heap is addressable here */
void *shmem_ptr(const void *dest, int pe);
int shmem_pe_accessible(int pe);
int shmem_addr_accessible(const void *addr, int pe);
/* strided RMA (element strides, shmem_iput.c semantics) */
void shmem_long_iput(long *dest, const long *source, ptrdiff_t dst,
                     ptrdiff_t sst, size_t nelems, int pe);
void shmem_long_iget(long *dest, const long *source, ptrdiff_t dst,
                     ptrdiff_t sst, size_t nelems, int pe);
void shmem_double_iput(double *dest, const double *source, ptrdiff_t dst,
                       ptrdiff_t sst, size_t nelems, int pe);
void shmem_double_iget(double *dest, const double *source, ptrdiff_t dst,
                       ptrdiff_t sst, size_t nelems, int pe);
/* collectives over all PEs (house 1.4 style: no pSync/pWrk) */
void shmem_alltoallmem(void *dest, const void *source, size_t nbytes);
void shmem_collectmem(void *dest, const void *source, size_t nbytes);
void shmem_sync_all(void);
void shmem_global_exit(int status);
#define SHMEM_MAX_NAME_LEN 64
#define SHMEM_MAJOR_VERSION 1
#define SHMEM_MINOR_VERSION 4
void shmem_info_get_version(int *major, int *minor);
void shmem_info_get_name(char *name);
/* deprecated cache ops (shmem_set_cache_inv.c family): no-ops on a
 * coherent host, kept so legacy codes link */
void shmem_set_cache_inv(void);
void shmem_clear_cache_inv(void);
void shmem_set_cache_line_inv(void *dest);
void shmem_clear_cache_line_inv(void *dest);
void shmem_udcflush(void);
void shmem_udcflush_line(void *dest);
/* legacy start_pes-era names */
void start_pes(int npes);
int _my_pe(void);
int _num_pes(void);
void shmem_long_wait(long *ivar, long value);
long shmem_swap(long *target, long value, int pe);

#ifdef __cplusplus
}
#endif

#endif /* ZOMPI_SHMEM_H */
