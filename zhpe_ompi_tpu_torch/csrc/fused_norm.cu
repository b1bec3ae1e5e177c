// Layernorm forward and backward for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Forward.  Replaces the TPU kernel zhpe_ompi_tpu/ops/fused_norm.py::_ln_fwd_kernel
// (launched by _ln_fwd, pl.pallas_call at fused_norm.py:66): row layernorm
// over the last axis, eps 1e-5, statistics in f32 (m = mean(x), c = x - m,
// v = mean(c^2), r = rsqrt(v + eps)), y = c * r * g in x's dtype, plus the
// per-row m and r in f32 for the backward.
//
// What bounds it on an H100: bytes.  At the flagship width (8192 x 1024
// bf16) it moves one read of x, one write of y, g, m and r, about 33.6 MB,
// which is ~10 us at 3.35 TB/s; its arithmetic is a few operations per
// byte, far below the ~295 FLOP/byte where the tensor cores would bind.
//
// Design: one warp per row, eight rows per block.  On the fast path the
// row is read once with 16-byte loads into registers (CHUNKS loads per
// lane), the mean and the centred variance are two passes over those
// registers (warp shuffles, no shared memory), and y is written once with
// 16-byte stores: one read and one write of every element, the minimum.
// The TPU kernel's 256-row VMEM blocks have no counterpart: a GPU wants
// many small independent blocks in flight to hide memory latency.  Rows
// whose width is not a multiple of the 16-byte vector, rows wider than the
// register budget, and unaligned pointers take the generic path, which
// reads the row from device memory three times with scalar loads.  Both
// paths mask their own edge (any N, any D), where the JAX dispatcher fell
// back to the reference on n % block or d % 128.
//
// Backward.  Replaces the TPU kernel _ln_bwd_kernel (launched by _ln_bwd,
// pl.pallas_call at fused_norm.py:127): with x^ = (x - m) r and
// dx^ = dy g, dx = r (dx^ - mean(dx^) - x^ mean(dx^ x^)) in x's dtype, and
// dg = sum over rows of dy x^ in f32.
//
// What bounds it: bytes again.  At 8192 x 1024 bf16 it must read x and dy
// and write dx, ~50.4 MB, ~15 us at 3.35 TB/s.
//
// What held the first design back, at 31.7 us on an NVIDIA H100 80GB HBM3
// at 700 W: each lane kept its row as f32 (x^, dx^ and the dg sums, 127-128
// registers), so two 256-thread blocks fit an SM and each warp had one row
// in flight, its load -> two shuffle reductions -> store chain serial; g
// was read again from device memory for every row; and dg took a second
// launch, which folded ~264 partial rows with ~9 dependent loads a thread.
//
// This design, one cooperative launch (the grid is sized by the occupancy
// the card reports, so every block is resident and the sum order is fixed
// for a card):
// - Register path: one warp per row, 16 warps a block, one block per SM,
//   a grid-stride loop over the rows.  A lane keeps its columns of x and dy
//   packed as loaded (16-byte vectors, 32 registers for d = 1024 bf16) and
//   unpacks them twice, for the two row means and then for dx; the next
//   row's x, dy, mean and rstd are loaded before this row's reductions, so
//   two rows are in flight per warp.  g is read once per block into shared
//   memory.  Each lane keeps its columns' dg sums in registers; at the end
//   the block's warps fold them in warp order through shared memory into
//   one (d,) partial row per block.
// - Generic path (widths that are not a multiple of the 16-byte vector,
//   unaligned pointers): scalar passes, each warp's dg sum in its own
//   partial row in device memory, one block per SM.
// - Then a grid-wide barrier, and the blocks fold the partial rows in
//   parallel (fold_dg): a block takes 32 columns, its warps split the rows,
//   and their sums are added in warp order.  No atomics: the same bits on
//   every run on a given card.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fast path: the row in registers.  VEC elements per 16-byte load; lane l
// holds elements [(c * 32 + l) * VEC, +VEC) for c < CHUNKS.  Requires
// d % VEC == 0 and 16-byte aligned x, y and g.
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_fwd_reg(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
           float* __restrict__ mean, float* __restrict__ rstd, int64_t n, int d,
           float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float v[CHUNKS][VEC];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] = to_f(e[i]);
        s += v[c][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c][i] = 0.f;
    }
  }
  const float m = warp_sum(s) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] -= m;
        q += v[c][i] * v[c][i];
      }
    }
  }
  const float r = rsqrtf(warp_sum(q) / (float)d + eps);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
      float gv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        float4 g4 = *reinterpret_cast<const float4*>(g + col + i);
        gv[i] = g4.x; gv[i + 1] = g4.y; gv[i + 2] = g4.z; gv[i + 3] = g4.w;
      }
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[c][i] * r * gv[i]);
      *reinterpret_cast<uint4*>(yr + col) = raw;
    }
  }
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

// Generic path: any d, any alignment; three scalar passes over the row.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_fwd_generic(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
               float* __restrict__ mean, float* __restrict__ rstd, int64_t n, int d,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += to_f(xr[j]);
  const float m = warp_sum(s) / (float)d;
  float q = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float c = to_f(xr[j]) - m;
    q += c * c;
  }
  const float r = rsqrtf(warp_sum(q) / (float)d + eps);
  for (int j = lane; j < d; j += 32) yr[j] = from_f<T>((to_f(xr[j]) - m) * r * g[j]);
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

template <typename T, int CHUNKS>
void launch_reg(const void* x, const float* g, void* y, float* m, float* r, int64_t n,
                int d, float eps, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_fwd_reg<T, CHUNKS><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), g, static_cast<T*>(y), m, r, n, d, eps);
}

template <typename T>
void launch(const void* x, const float* g, void* y, float* m, float* r, int64_t n, int d,
            float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                       ((uintptr_t)g % 16 == 0) && (d % VEC == 0);
  const int chunks = (d + 32 * VEC - 1) / (32 * VEC);
  if (aligned && chunks <= 1) return launch_reg<T, 1>(x, g, y, m, r, n, d, eps, st);
  if (aligned && chunks <= 2) return launch_reg<T, 2>(x, g, y, m, r, n, d, eps, st);
  if (aligned && chunks <= 4) return launch_reg<T, 4>(x, g, y, m, r, n, d, eps, st);
  if (aligned && chunks <= 8) return launch_reg<T, 8>(x, g, y, m, r, n, d, eps, st);
  const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_fwd_generic<T><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), g, static_cast<T*>(y), m, r, n, d, eps);
}

// ---------------------------------------------------------------- backward

// dg[j] = sum over p < rows of partial[p][j], once every block of the
// (cooperative) grid has written its partial rows.  Block b folds the
// 32-column chunks b, b + gridDim.x, ...: warp w sums rows w, w + W, ... of
// its lane's column, then the W sums are added in warp order.
__device__ void fold_dg(const float* partial, int64_t rows, int d, float* __restrict__ dg) {
  __shared__ float sums[32][33];
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  for (int c = blockIdx.x; c * 32 < d; c += gridDim.x) {
    const int j = c * 32 + lane;
    float a = 0.f;
    if (j < d) {
#pragma unroll 8
      for (int64_t p = warp; p < rows; p += W) a += __ldcg(partial + p * d + j);
    }
    sums[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && j < d) {
      float t = 0.f;
      for (int w = 0; w < W; ++w) t += sums[w][lane];
      dg[j] = t;
    }
    __syncthreads();
  }
}

// The register path's constants: VEC elements per 16-byte load, rows up to
// kCols wide, 16 warps a block where two rows of packed x and dy and the
// dg sums fit 128 registers (CHUNKS <= 4), else 8.
template <typename T, int CHUNKS>
struct BwdReg {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kCols = CHUNKS * 32 * kVec;
  static constexpr int kThreads = CHUNKS <= 4 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSmem = (1 + kWarps) * kCols * 4;  // g, then each warp's dg sums
};

// Register path: lane l holds columns [(c * 32 + l) * VEC, +VEC) for
// c < CHUNKS, as in ln_fwd_reg.  Requires d % VEC == 0 and 16-byte aligned
// x, dy, dx and g.  Writes partial[blockIdx.x][:d], the block's dg sum,
// then folds the grid's partial rows into dg.
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(BwdReg<T, CHUNKS>::kThreads, 1)
ln_bwd_reg(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
           const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
           float* partial, float* __restrict__ dg, int64_t n, int d) {
  using P = BwdReg<T, CHUNKS>;
  constexpr int VEC = P::kVec, W = P::kWarps;
  extern __shared__ float smem[];
  float* sg = smem;               // g
  float* sacc = smem + P::kCols;  // warp w's dg sums at w * kCols
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // x and dy of row r, packed as loaded; zeros past n and past d
  auto load = [&](int64_t r, uint4 (&xs)[CHUNKS], uint4 (&ds)[CHUNKS]) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      xs[c] = ds[c] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n && col < d) {
        xs[c] = *reinterpret_cast<const uint4*>(x + r * d + col);
        ds[c] = *reinterpret_cast<const uint4*>(dy + r * d + col);
      }
    }
  };

  float acc[CHUNKS][VEC] = {};
  uint4 xv[CHUNKS], dv[CHUNKS];
  const int64_t stride = (int64_t)gridDim.x * W;
  int64_t row = (int64_t)blockIdx.x * W + warp;
  load(row, xv, dv);
  float m = row < n ? mean[row] : 0.f, r = row < n ? rstd[row] : 0.f;
  // g, while the first rows load
  for (int j = threadIdx.x; j < d; j += P::kThreads) sg[j] = g[j];
  __syncthreads();
  for (; row < n; row += stride) {
    // the next row's loads go out before this row's reductions
    const int64_t next = row + stride;
    uint4 xn[CHUNKS], dn[CHUNKS];
    load(next, xn, dn);
    const float m_next = next < n ? mean[next] : 0.f, r_next = next < n ? rstd[next] : 0.f;

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < d) {
        const T* xe = reinterpret_cast<const T*>(&xv[c]);
        const T* de = reinterpret_cast<const T*>(&dv[c]);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(sg + col + i);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float xh = (to_f(xe[i + t]) - m) * r;
            const float dyv = to_f(de[i + t]);
            const float dh = dyv * gv[t];
            acc[c][i + t] += dyv * xh;
            s1 += dh;
            s2 += dh * xh;
          }
        }
      }
    }
    const float mdh = warp_sum(s1) / (float)d;
    const float mdx = warp_sum(s2) / (float)d;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < d) {
        const T* xe = reinterpret_cast<const T*>(&xv[c]);
        const T* de = reinterpret_cast<const T*>(&dv[c]);
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(sg + col + i);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float xh = (to_f(xe[i + t]) - m) * r;
            e[i + t] = from_f<T>(r * (to_f(de[i + t]) * gv[t] - mdh - xh * mdx));
          }
        }
        *reinterpret_cast<uint4*>(dx + row * d + col) = raw;
      }
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      xv[c] = xn[c];
      dv[c] = dn[c];
    }
    m = m_next;
    r = r_next;
  }

  // the block's partial row: its warps' dg sums added in warp order
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sacc[warp * P::kCols + col + i] = acc[c][i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += P::kThreads) {
    float t = 0.f;
    for (int w = 0; w < W; ++w) t += sacc[w * P::kCols + j];
    partial[(int64_t)blockIdx.x * d + j] = t;
  }
  fold_dg(partial, gridDim.x, d, dg);
}

// Generic path: any d, any alignment; scalar passes over the row, each
// warp's dg sum in its own row of partial, (gridDim.x * kRowsPerBlock, d),
// then the grid's fold into dg.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_generic(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               T* __restrict__ dx, float* partial, float* __restrict__ dg, int64_t n, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = partial + ((int64_t)blockIdx.x * kRowsPerBlock + warp) * d;
  for (int j = lane; j < d; j += 32) pw[j] = 0.f;
  const int64_t stride = (int64_t)gridDim.x * kRowsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + warp; row < n; row += stride) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    const float m = mean[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float xh = (to_f(xr[j]) - m) * r;
      const float dyv = to_f(dyr[j]);
      const float dh = dyv * g[j];
      pw[j] += dyv * xh;
      s1 += dh;
      s2 += dh * xh;
    }
    const float mdh = warp_sum(s1) / (float)d;
    const float mdx = warp_sum(s2) / (float)d;
    for (int j = lane; j < d; j += 32) {
      const float xh = (to_f(xr[j]) - m) * r;
      dx[row * d + j] = from_f<T>(r * (to_f(dyr[j]) * g[j] - mdh - xh * mdx));
    }
  }
  fold_dg(partial, (int64_t)gridDim.x * kRowsPerBlock, d, dg);
}

template <typename T>
using BwdKernel = void (*)(const T*, const float*, const T*, const float*, const float*, T*,
                           float*, float*, int64_t, int);

template <typename T>
struct BwdPlan {
  BwdKernel<T> kernel;
  unsigned blocks, threads;
  int smem;
  long long partial_rows;
};

// The register path's kernel, block size and shared memory, its dynamic
// shared-memory limit raised once per device.
template <typename T, int CHUNKS>
cudaError_t reg_plan(BwdPlan<T>* plan) {
  using P = BwdReg<T, CHUNKS>;
  static unsigned long long smem_set = 0;
  plan->kernel = ln_bwd_reg<T, CHUNKS>;
  plan->threads = P::kThreads;
  plan->smem = P::kSmem;
  return sm90::allow_smem(ln_bwd_reg<T, CHUNKS>, P::kSmem, &smem_set);
}

// Which kernel, how many blocks of how many threads, how many dg partial
// rows.  Depends only on the shapes, the alignment and the card, so the
// wrapper can size the partials before the launch and the summation order
// is fixed.  The grid is at most what the card holds at once, as a
// cooperative launch needs.
template <typename T>
cudaError_t bwd_plan(const void* x, const void* g, const void* dy, const void* dx, int64_t n,
                     int d, BwdPlan<T>* plan) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)dy % 16 == 0) &&
                       ((uintptr_t)dx % 16 == 0) && ((uintptr_t)g % 16 == 0) && (d % VEC == 0);
  const int chunks = (d + 32 * VEC - 1) / (32 * VEC);
  cudaError_t err = cudaSuccess;
  bool reg = aligned && chunks <= 8;
  if (aligned && chunks <= 1) err = reg_plan<T, 1>(plan);
  else if (aligned && chunks <= 2) err = reg_plan<T, 2>(plan);
  else if (aligned && chunks <= 4) err = reg_plan<T, 4>(plan);
  else if (aligned && chunks <= 8) err = reg_plan<T, 8>(plan);
  else *plan = {ln_bwd_generic<T>, 0, 32 * kRowsPerBlock, 0, 0};
  if (err != cudaSuccess) return err;
  int per_sm = 1, sms = 0;
  if (reg) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan->kernel, plan->threads,
                                                        plan->smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  if ((err = sm90::sm_count(&sms)) != cudaSuccess) return err;
  const int warps = plan->threads / 32;
  const int64_t want = (n + warps - 1) / warps;
  const int64_t cap = (int64_t)per_sm * sms;
  plan->blocks = (unsigned)(want < cap ? want : cap);
  plan->partial_rows = reg ? (long long)plan->blocks : (long long)plan->blocks * warps;
  return cudaSuccess;
}

template <typename T>
int launch_bwd(const void* x, const float* g, const void* dy, const float* m, const float* r,
               void* dx, float* dg, float* partial, long long partial_rows, int64_t n, int d,
               cudaStream_t st) {
  BwdPlan<T> plan;
  cudaError_t err = bwd_plan<T>(x, g, dy, dx, n, d, &plan);
  if (err != cudaSuccess) return (int)err;
  if (plan.partial_rows != partial_rows) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  void* args[] = {&xp, &g, &dyp, &m, &r, &dxp, &partial, &dg, &n, &d};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(plan.kernel),
                                          dim3(plan.blocks), dim3(plan.threads), args,
                                          (size_t)plan.smem, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (n, d)
// row-major; g is (d,) float32; mean and rstd are (n,) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int zt_ln_fwd(const void* x, const void* g, void* y, void* mean, void* rstd,
                         long long n, int d, int dtype, float eps, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0: launch<float>(x, gf, y, m, r, n, d, eps, st); break;
    case 1: launch<__nv_bfloat16>(x, gf, y, m, r, n, d, eps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The number of (d,) float32 dg partial rows zt_ln_bwd needs for these
// tensors on the current device, or -1 for arguments it does not take.
extern "C" long long zt_ln_bwd_partials(const void* x, const void* g, const void* dy,
                                        const void* dx, long long n, int d, int dtype) {
  if (n <= 0 || d <= 0) return -1;
  switch (dtype) {
    case 0: {
      BwdPlan<float> plan;
      return bwd_plan<float>(x, g, dy, dx, n, d, &plan) == cudaSuccess ? plan.partial_rows : -1;
    }
    case 1: {
      BwdPlan<__nv_bfloat16> plan;
      return bwd_plan<__nv_bfloat16>(x, g, dy, dx, n, d, &plan) == cudaSuccess
                 ? plan.partial_rows
                 : -1;
    }
    default: return -1;
  }
}

// Layernorm backward.  x, dy and dx are (n, d) row-major in `dtype`
// (0 = float32, 1 = bfloat16); g is (d,) float32; mean and rstd are the
// forward's (n,) float32 statistics; dg is (d,) float32; partial is
// (partial_rows, d) float32 scratch, partial_rows as zt_ln_bwd_partials
// gives it.  One cooperative launch on `stream`.  Returns the cudaError_t
// (0 on success).
extern "C" int zt_ln_bwd(const void* x, const void* g, const void* dy, const void* mean,
                         const void* rstd, void* dx, void* dg, void* partial,
                         long long partial_rows, long long n, int d, int dtype, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* dgf = static_cast<float*>(dg);
  float* pf = static_cast<float*>(partial);
  switch (dtype) {
    case 0: return launch_bwd<float>(x, gf, dy, m, r, dx, dgf, pf, partial_rows, n, d, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, gf, dy, m, r, dx, dgf, pf, partial_rows, n, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
