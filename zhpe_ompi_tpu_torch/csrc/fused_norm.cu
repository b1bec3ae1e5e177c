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
// Design: the TPU kernel summed dg across its sequential grid in VMEM
// scratch; GPU blocks run in no order, so dg takes two launches, both in
// zt_ln_bwd, with no atomics and a fixed summation order (the result is
// the same bits on every run on a given card):
// 1. A grid-stride loop of a few blocks per SM (the count is the occupancy
//    the card reports, so it is fixed for a card).  One warp per row, as in
//    the forward: on the register path the row of x and dy is read once
//    with 16-byte loads, the two row means are warp shuffles over
//    registers, dx is written once.  Each lane keeps its columns' dg sum in
//    registers across the rows it visits; at the end the block's warps fold
//    their sums in warp order through shared memory and the block writes
//    one (D,) f32 partial.  At the flagship shape that is ~264 partials,
//    ~1 MB, against the ~50 MB of the main pass.  The generic path (odd
//    widths, unaligned pointers) keeps each warp's dg sum in its own row of
//    the partials in device memory, one block per SM.
// 2. ln_dg_reduce sums the partials column by column: 32 threads down each
//    column, then a fold of those 32 sums in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Register path: lane l holds columns [(c * 32 + l) * VEC, +VEC) for
// c < CHUNKS, as in ln_fwd_reg.  Requires d % VEC == 0 and 16-byte aligned
// x, dy, dx and g.  Writes partial[blockIdx.x][:d], the block's dg sum.
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_reg(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
           const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
           float* __restrict__ partial, int64_t n, int d) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sdg[CHUNKS * 32 * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c][i] = 0.f;

  const int64_t stride = (int64_t)gridDim.x * kRowsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + warp; row < n; row += stride) {
    const float m = mean[row], r = rstd[row];
    float xh[CHUNKS][VEC], dh[CHUNKS][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < d) {
        uint4 xraw = *reinterpret_cast<const uint4*>(x + row * d + col);
        uint4 draw = *reinterpret_cast<const uint4*>(dy + row * d + col);
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* de = reinterpret_cast<const T*>(&draw);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(g + col + i);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float dyv = to_f(de[i + t]);
            xh[c][i + t] = (to_f(xe[i + t]) - m) * r;
            dh[c][i + t] = dyv * gv[t];
            acc[c][i + t] += dyv * xh[c][i + t];
            s1 += dh[c][i + t];
            s2 += dh[c][i + t] * xh[c][i + t];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[c][i] = dh[c][i] = 0.f;
      }
    }
    const float mdh = warp_sum(s1) / (float)d;
    const float mdx = warp_sum(s2) / (float)d;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < d) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(r * (dh[c][i] - mdh - xh[c][i] * mdx));
        *reinterpret_cast<uint4*>(dx + row * d + col) = raw;
      }
    }
  }

  // fold the warps' dg sums in warp order
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int col = (c * 32 + lane) * VEC;
        if (col < d) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) sdg[col + i] = (w == 0 ? 0.f : sdg[col + i]) + acc[c][i];
        }
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < d; j += 32 * kRowsPerBlock)
    partial[(int64_t)blockIdx.x * d + j] = sdg[j];
}

// Generic path: any d, any alignment; scalar passes over the row, and each
// warp's dg sum in its own row of partial, (gridDim.x * kRowsPerBlock, d).
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_generic(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               T* __restrict__ dx, float* __restrict__ partial, int64_t n, int d) {
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
}

// dg[j] = sum over p of partial[p][j], in a fixed order: thread (tx, ty)
// sums rows ty, ty + 32, ... of column blockIdx.x * 32 + tx, then row 0 of
// the block folds the 32 sums in ty order.
__global__ void __launch_bounds__(1024)
ln_dg_reduce(const float* __restrict__ partial, float* __restrict__ dg, int64_t p, int d) {
  __shared__ float s[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (j < d)
    for (int64_t i = ty; i < p; i += 32) acc += partial[i * d + j];
  s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < d) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += s[i][tx];
    dg[j] = t;
  }
}

template <typename T>
using BwdKernel = void (*)(const T*, const float*, const T*, const float*, const float*, T*,
                           float*, int64_t, int);

template <typename T>
struct BwdPlan {
  BwdKernel<T> kernel;
  unsigned blocks;
  long long partial_rows;
};

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Which kernel, how many blocks, how many dg partial rows.  Depends only
// on the shapes, the alignment and the card, so the wrapper can size the
// partials before the launch and the summation order is fixed.
template <typename T>
BwdPlan<T> bwd_plan(const void* x, const void* g, const void* dy, const void* dx, int64_t n,
                    int d) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)dy % 16 == 0) &&
                       ((uintptr_t)dx % 16 == 0) && ((uintptr_t)g % 16 == 0) && (d % VEC == 0);
  const int chunks = (d + 32 * VEC - 1) / (32 * VEC);
  BwdKernel<T> k = nullptr;
  if (aligned && chunks <= 1) k = ln_bwd_reg<T, 1>;
  else if (aligned && chunks <= 2) k = ln_bwd_reg<T, 2>;
  else if (aligned && chunks <= 4) k = ln_bwd_reg<T, 4>;
  else if (aligned && chunks <= 8) k = ln_bwd_reg<T, 8>;
  const bool reg = k != nullptr;
  int per_sm = 1;
  if (reg) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * kRowsPerBlock, 0);
    if (per_sm < 1) per_sm = 1;
  } else {
    k = ln_bwd_generic<T>;
  }
  const int64_t want = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t cap = (int64_t)per_sm * sm_count();
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  return {k, blocks, reg ? (long long)blocks : (long long)blocks * kRowsPerBlock};
}

template <typename T>
int launch_bwd(const void* x, const float* g, const void* dy, const float* m, const float* r,
               void* dx, float* dg, float* partial, long long partial_rows, int64_t n, int d,
               cudaStream_t st) {
  const BwdPlan<T> plan = bwd_plan<T>(x, g, dy, dx, n, d);
  if (plan.partial_rows != partial_rows) return (int)cudaErrorInvalidValue;
  plan.kernel<<<plan.blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy), m, r, static_cast<T*>(dx),
      partial, n, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_dg_reduce<<<(unsigned)((d + 31) / 32), 1024, 0, st>>>(partial, dg, partial_rows, d);
  return (int)cudaGetLastError();
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
    case 0: return bwd_plan<float>(x, g, dy, dx, n, d).partial_rows;
    case 1: return bwd_plan<__nv_bfloat16>(x, g, dy, dx, n, d).partial_rows;
    default: return -1;
  }
}

// Layernorm backward.  x, dy and dx are (n, d) row-major in `dtype`
// (0 = float32, 1 = bfloat16); g is (d,) float32; mean and rstd are the
// forward's (n,) float32 statistics; dg is (d,) float32; partial is
// (partial_rows, d) float32 scratch, partial_rows as zt_ln_bwd_partials
// gives it.  Two launches on `stream`.  Returns the cudaError_t (0 on
// success).
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
