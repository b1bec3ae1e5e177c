// Hopper (sm_90a) building blocks shared by the port's attention kernels:
// TMA tensor maps and loads, mbarriers with phase parity, wgmma shared-memory
// descriptors and the fence/commit/wait around them, and setmaxnreg.
//
// Shared-memory tiles.  A tile of R rows of a (rows, hd) bf16 operand is
// stored as hd * 2 / kSwz column atoms of R rows x kSwz bytes, one after the
// other, where kSwz = min(hd * 2, 128) is the swizzle width: 128 B for
// hd >= 64, 64 B for hd = 32, 32 B for hd = 16.  TMA writes each atom with
// the swizzle of that width (a box of kSwz / 2 columns and 64 rows); the
// wgmma descriptors below name the same swizzle, so the two agree on where
// every 16-byte chunk lives.  Tiles start on 1024-byte boundaries, the
// period of the widest swizzle.
//
// The tensor maps are encoded on the host, per call, with
// cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint, so the
// libraries link the CUDA runtime only (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The current device's SM count, asked once per device.
inline cudaError_t sm_count(int* out) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = counts[dev];
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device (`done` is the caller's bitmask of devices).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (*done & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// Geometry of one operand's map, as the Python wrapper computes it
// (ops/flash_attention.py::tma_map_geometry): dims (hd, S, h, B), byte
// strides of S, h and B, and the box (kSwz / 2, 64, 1, 1), innermost first.
constexpr int kGeomLen = 11;

// A 4-D bf16 map of a (B, S, h, hd) operand from its geometry, swizzled to
// the box's row width.  Rows past S read as zeros.
inline cudaError_t encode_operand(CUtensorMap* map, const void* base, const long long* g) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], ones[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)g[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)g[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)g[7 + i];
  const int row_bytes = (int)box[0] * 2;
  const CUtensorMapSwizzle swz = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                   : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swz == CU_TENSOR_MAP_SWIZZLE_NONE) return cudaErrorInvalidValue;
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// True when g describes a (B, S, h, hd) operand with the box the kernels load.
inline bool geometry_ok(const long long* g, int B, int S, int H, int hd) {
  const int atom = hd < 64 ? hd : 64;
  return g[0] == hd && g[1] == S && g[2] == H && g[3] == B && g[7] == atom && g[8] == 64 &&
         g[9] == 1 && g[10] == 1;
}

// -------------------------------------------------------------- device side

// The work items (head, tile) of one block of a persistent grid.  In round
// r the blocks run in groups of `group` = min(tiles, gridDim.x): group g
// takes head r * n_groups + g, and block u of the group takes its tiles
// (u + r) % group, then group further on.  So the tiles of one head run
// at the same time on neighbouring blocks, and the operand they all read
// (K and V in the forward, Q and dO in dk/dv) is fetched from device
// memory once and then served by the L2; and a block's rounds cycle
// through the light and the heavy causal tiles.
struct Walk {
  int heads, tiles, group, n_groups, g, u, r = 0, k = 0;
  __device__ __forceinline__ Walk(int heads_, int tiles_) : heads(heads_), tiles(tiles_) {
    group = tiles < (int)gridDim.x ? tiles : (int)gridDim.x;
    n_groups = gridDim.x / group;
    g = blockIdx.x / group;
    u = blockIdx.x % group;
  }
  // The block's next item; false when it has none left.
  __device__ __forceinline__ bool next(int& head, int& tile) {
    if (g >= n_groups) return false;
    for (;;) {
      const int h = r * n_groups + g;
      if (h >= heads) return false;
      const int t = (u + r) % group + k * group;
      if (t < tiles) {
        head = h;
        tile = t;
        ++k;
        return true;
      }
      ++r;
      k = 0;
    }
  }
};

// Byte layout of the tiles of a head dim.
template <int HD>
struct Tiles {
  static constexpr int kSwz = HD * 2 < 128 ? HD * 2 : 128;  // bytes of a swizzled row
  static constexpr int kAtom = kSwz / 2;                    // columns of one atom
  static constexpr int kAtoms = HD / kAtom;
  static constexpr int kTile = 64 * HD * 2;                 // bytes of a 64-row tile
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// allocated 1 KB larger for it).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once: the producer's
// first pass over the ring's empty barriers.  A wait that outlasts two
// seconds can only be a broken pipeline (a load that never lands, an
// arrival count that is never reached): it traps, so the launch fails with
// an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (++tries == 64) t0 = global_ns();
    if (tries > 64 && (tries & 63) == 0 && global_ns() - t0 > 2000000000ull) __trap();
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 4-D map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row, row + 64) of head h of batch b: every column atom of the tile
// at dst (kTile bytes).
template <int HD>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int h, int b) {
  using T = Tiles<HD>;
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a)
    tma_load_4d(dst + a * 64 * T::kSwz, map, bar, a * T::kAtom, row, h, b);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

// Descriptor of k-step kk (columns 16kk .. 16kk + 15) of a 64-row tile used
// K-major (the row index is M or N of the product, the columns are K):
// 32 bytes into the swizzled row, in atom kk * 32 / kSwz.  8-row groups
// are 8 * kSwz bytes apart (SBO); LBO is unused by swizzled K-major
// layouts and set to 1 (16 bytes).
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tiles<HD>;
  const uint32_t byte = kk * 32;
  return make_desc(tile + (byte / T::kSwz) * 64 * T::kSwz + byte % T::kSwz, 16, 8 * T::kSwz,
                   T::kLayout);
}

// Descriptor of k-step j (rows 16j .. 16j + 15) of a 64-row tile used
// MN-major (the row index is K of the product, the columns are N): 8-row
// groups along K are 8 * kSwz bytes apart (SBO), column atoms along N are
// 64 * kSwz bytes apart (LBO).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j) {
  using T = Tiles<HD>;
  return make_desc(tile + j * 16 * T::kSwz, 64 * T::kSwz, 8 * T::kSwz, T::kLayout);
}

// Order prior register and shared-memory accesses before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to an accumulator across an
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for A fragments held in registers: an asynchronous wgmma reads
// them until its group is waited on, so they must stay live (and their
// registers unused by anything else) until then.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Store this lane's two rows (row0 and row0 + 8, of the 16 its warp owns)
// of a 64 x HD accumulator, times mul0 and mul1, as bf16 rows of a
// (B, S, H, HD) contiguous tensor; rows at or past S are not written.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* out, const float (&d)[HD / 2], int64_t b, int h,
                                          int S, int H, int row0, float mul0, float mul1) {
  const int tq = threadIdx.x & 3;
  const int row1 = row0 + 8;
  const int64_t ss = (int64_t)H * HD;
  bf16* p = out + (b * S * H + h) * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(p + row0 * ss + c) =
          __floats2bfloat162_rn(d[4 * j] * mul0, d[4 * j + 1] * mul0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(p + row1 * ss + c) =
          __floats2bfloat162_rn(d[4 * j + 2] * mul1, d[4 * j + 3] * mul1);
  }
}

// The A fragment of k-chunk j of the product P B from the accumulator of
// P = (64 x N): n-tiles 2j and 2j + 1 of the accumulator are, register for
// register, the m16n8k16 A fragment of columns 16j .. 16j + 15.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int j) {
  a[0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
  a[1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
  a[2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
  a[3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
}

// D(64 x 64) (+)= A(64 x 16) B(16 x 64), f32 += bf16 x bf16; A and B in shared
// memory, both K-major (no transpose).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 16) (+)= A(64 x 16) B(16 x 16), f32 += bf16 x bf16; A in registers
// (the m16n8k16 A fragment of each warp's 16 rows), B in shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 32) (+)= A(64 x 16) B(16 x 32), f32 += bf16 x bf16; A in registers
// (the m16n8k16 A fragment of each warp's 16 rows), B in shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16) B(16 x 64), f32 += bf16 x bf16; A in registers
// (the m16n8k16 A fragment of each warp's 16 rows), B in shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16) B(16 x 128), f32 += bf16 x bf16; A in registers
// (the m16n8k16 A fragment of each warp's 16 rows), B in shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace sm90
